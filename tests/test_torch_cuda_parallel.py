# Copyright 2026 The rayfed-tpu Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.

"""The sharded train step on the card: ``make_fed_train_step`` over a
party x data x model DeviceMesh of one rank (a one-process NCCL group)
against the one-device step, through the bf16 flash kernels. On one rank
every placement is the whole tensor and every collective the identity, so
the steps are held bitwise, as ``chip_smoke.py`` phase 14 holds them at
the flagship width; their K1-K3 launches must match. Every test here is
marked ``cuda`` and skips without a Hopper card. The file imports neither
JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_parallel.py
"""

import socket

import pytest
import torch

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.models import decode, transformer as tfm
from rayfed_tpu_torch.ops import flash_attention as fa
from rayfed_tpu_torch.parallel import sharding as shd
from rayfed_tpu_torch.parallel.train import make_fed_train_step

pytestmark = pytest.mark.cuda

CFG = tfm.tiny_config(vocab=512, d_model=256, n_heads=2, n_layers=2,
                      d_ff=512)
STEPS = 3


@pytest.fixture
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    import torch.distributed as dist

    from rayfed_tpu_torch import mesh as pm

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield pm.build_mesh(mesh_shape=[1, 1, 1],
                            axis_names=["party", "data", "model"])
    finally:
        dist.destroy_process_group()


def _blocks():
    gen = torch.Generator(device="cuda").manual_seed(0)
    return [torch.randint(0, CFG.vocab, (4, 257), generator=gen,
                          device="cuda") for _ in range(STEPS)]


def _run(step_fn, params, opt, blocks):
    fa.reset_launch_counts()
    losses = []
    for blk in blocks:
        params, opt, loss = step_fn(params, opt, blk[:, :-1], blk[:, 1:])
        losses.append(float(loss))
    torch.cuda.synchronize()
    return losses, shd.gather_params(params), dict(fa.LAUNCHES)


@pytest.mark.parametrize("kw", [{}, {"shard_opt_state": True,
                                     "accum_steps": 2}],
                         ids=["replicated", "zero1_accum2"])
def test_one_rank_mesh_step_equals_the_one_device_step(mesh, kw):
    blocks = _blocks()
    init, step = make_fed_train_step(
        CFG, "cuda", lr=1e-3, attn="flash",
        accum_steps=kw.get("accum_steps", 1))
    want = _run(step, *init(0), blocks)
    init, step = make_fed_train_step(CFG, mesh, lr=1e-3, attn="flash", **kw)
    got = _run(step, *init(0), blocks)
    assert got[0] == want[0]
    for a, b in zip(tree_util.tree_flatten(got[1])[0],
                    tree_util.tree_flatten(want[1])[0]):
        assert torch.equal(a, b)
    kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    assert {k: got[2][k] for k in kernels} == {k: want[2][k] for k in kernels}
    assert all(got[2][k] > 0 for k in kernels)


def test_one_rank_mesh_greedy_decode_equals_the_one_device_decode(mesh):
    params = tfm.init_params(0, CFG, "cuda")
    prompt = _blocks()[0][:2, :16]
    want = decode.make_generate_fn(CFG, max_new_tokens=4)(params, prompt)
    got = decode.make_generate_fn(CFG, max_new_tokens=4, mesh=mesh)(
        params, prompt)
    assert torch.equal(got, want)
