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

"""The MoE train step and the three remat modes on the card, through the
bf16 flash kernels. Every test here is marked ``cuda`` and skips without a
card. The file imports neither JAX nor the JAX package, so it runs on a
machine that has only the port:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_family.py
"""

import dataclasses

import pytest
import torch

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.models import lora, moe, transformer as tfm
from rayfed_tpu_torch.ops import flash_attention as fa
from rayfed_tpu_torch.parallel.train import make_fed_train_step

pytestmark = pytest.mark.cuda

CFG = tfm.tiny_config(vocab=512, d_model=256, n_heads=2, n_layers=2,
                      d_ff=512, n_experts=4)
# The MoE FFN on the card against the CPU's in f32 (TF32 off): the same
# products, summed in another order.
F32_TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _tokens(device, shape, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, CFG.vocab, shape, generator=gen, device=device)


def _loss_and_grads(params, blk, remat):
    ps = tree_util.tree_map(lambda p: p.detach().clone().requires_grad_(True),
                            params)
    loss = tfm.lm_loss_pair(ps, blk[:, :-1], blk[:, 1:], CFG,
                            fa.make_flash_attn_fn(), remat=remat)
    loss.backward()
    return [loss.detach()] + [p.grad for p in tree_util.tree_flatten(ps)[0]]


def test_remat_modes_agree_bitwise_and_attn_skips_the_forward(cuda_device):
    params = tfm.init_params(0, CFG, cuda_device)
    blk = _tokens(cuda_device, (2, 257))
    got, k1 = {}, {}
    for mode in (False, True, "attn"):
        fa.reset_launch_counts()
        got[mode] = _loss_and_grads(params, blk, mode)
        torch.cuda.synchronize()
        k1[mode] = fa.LAUNCHES["flash_fwd"]
        assert fa.LAUNCHES["flash_bwd_dq"] == CFG.n_layers
        assert fa.LAUNCHES["flash_bwd_dkv"] == CFG.n_layers
    assert k1 == {False: CFG.n_layers, True: 2 * CFG.n_layers,
                  "attn": CFG.n_layers}
    for mode in (True, "attn"):
        for a, b in zip(got[mode], got[False]):
            assert torch.equal(a, b)


def test_moe_train_step_launches_the_kernels_and_learns(cuda_device):
    init_fn, step_fn = make_fed_train_step(CFG, cuda_device, attn="flash",
                                           remat="attn", lr=1e-2)
    params, opt = init_fn(0)
    blk = _tokens(cuda_device, (2, 257), seed=1)
    fa.reset_launch_counts()
    losses = []
    for _ in range(4):
        params, opt, loss = step_fn(params, opt, blk[:, :-1], blk[:, 1:])
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    assert all(fa.LAUNCHES[k] == 4 * CFG.n_layers
               for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))


def test_moe_ffn_on_the_card_matches_the_cpu_in_f32(cuda_device):
    w = moe.init_moe_ffn(3, 64, 128, 8, device="cpu")
    x = torch.randn(4, 96, 64, generator=torch.Generator().manual_seed(4))
    for fn in (lambda p, t: moe.moe_ffn_apply(p, t),
               lambda p, t: moe.moe_ffn_apply_topk(p, t, k=2)):
        want = fn(w, x)
        got = fn({k: v.to(cuda_device) for k, v in w.items()},
                 x.to(cuda_device)).cpu()
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_lora_step_on_the_card_launches_the_backward_kernels(cuda_device):
    cfg = dataclasses.replace(CFG, n_experts=0)
    params = tfm.init_params(0, cfg, cuda_device)
    ad = lora.init_lora(1, cfg, rank=4, device=cuda_device)
    step, optimizer = lora.make_lora_train_step(cfg, lr=1e-2)
    opt = optimizer.init(ad["layers"])
    frozen = [p.clone() for p in tree_util.tree_flatten(params)[0]]
    blk = _tokens(cuda_device, (2, 257), seed=2)
    fa.reset_launch_counts()
    ad, opt, loss = step(params, ad, opt, blk[:, :-1], blk[:, 1:])
    assert torch.isfinite(loss)
    # Adapter gradients on wq/wk/wv flow back through the attention.
    assert all(fa.LAUNCHES[k] == cfg.n_layers
               for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    for a, b in zip(tree_util.tree_flatten(params)[0], frozen):
        assert torch.equal(a, b)
