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

"""The serving plane on the card. Every test here is marked ``cuda`` and
skips without an sm_90 card. The file imports neither JAX nor the JAX
package, so it runs on a machine that has only the port:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_serving.py
"""

import numpy as np
import pytest
import torch

from rayfed_tpu_torch.config import ServingConfig
from rayfed_tpu_torch.models import transformer as tfm
from rayfed_tpu_torch.serving import server as srv_mod
from rayfed_tpu_torch.serving.kv_pool import KVPool
from rayfed_tpu_torch.serving.server import InferenceServer


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the server runs on one)")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the port targets sm_90 (Hopper) cards")
    return torch.device("cuda", 0)


def _cfg(dtype=torch.bfloat16):
    return tfm.TransformerConfig(vocab=1024, d_model=256, n_heads=2,
                                 n_layers=2, d_ff=704, compute_dtype=dtype)


def _prompts(n, seed=0, lo=4, hi=80):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 1000, int(rng.integers(lo, hi)))]
            for _ in range(n)]


def _serve(cfg, params, device, prompts, **scfg):
    srv = InferenceServer(cfg, ServingConfig(**scfg), params=params,
                          device=device)
    try:
        futs = [srv.submit(p, max_new_tokens=12, seed=i)
                for i, p in enumerate(prompts)]
        return [f.result(timeout=300)["tokens"] for f in futs], srv.stats()
    finally:
        srv.stop()


@pytest.mark.cuda
def test_paged_matches_slab_bitwise_on_the_card(cuda_device):
    """bf16 compute, prompts on both sides of the chunk size, greedy and
    sampled: the two layouts give the same tokens bit for bit."""
    cfg = _cfg()
    params = tfm.init_params(0, cfg, device=cuda_device)
    prompts = _prompts(12)
    for temperature in (0.0, 0.8):
        outs = {}
        for layout in ("slab", "paged"):
            outs[layout], st = _serve(
                cfg, params, cuda_device, prompts, max_slots=4, max_len=128,
                max_new_tokens=12, kv_layout=layout, temperature=temperature)
            assert st["completed"] == len(prompts)
        assert outs["paged"] == outs["slab"], temperature


@pytest.mark.cuda
def test_prefill_and_first_step_logits_match_a_full_forward(cuda_device):
    """f32 compute: the engine's prefill logits (whole and chunked) and
    its first decode step against a full forward, each within 1e-4 of the
    reference's norm."""
    cfg = _cfg(torch.float32)
    params = tfm.init_params(1, cfg, device=cuda_device)
    pool = KVPool(cfg, 3, 128, device=cuda_device)
    prompt = np.random.default_rng(2).integers(1, 1000, 70)

    def near(got, want):
        err = float(torch.linalg.vector_norm(got - want))
        assert err <= 1e-4 * float(torch.linalg.vector_norm(want)), err

    with torch.no_grad():
        full = tfm.forward(params, torch.tensor([prompt.tolist()],
                                                device=cuda_device), cfg)[0]
        k, v = pool.row(1)
        last = srv_mod.prefill_row(params, cfg, k, v, prompt, 128)
        near(last, full[-1])
        k2, v2 = pool.row(2)
        for off, real, clen in srv_mod.chunk_plan(70, 32, [8, 16, 32]):
            toks = np.zeros(clen, np.int64)
            toks[:real] = prompt[off:off + real]
            logits = srv_mod.chunk_row(params, cfg, k2, v2, toks, off)
        near(logits[real - 1], full[-1])
        tok = int(torch.argmax(last))
        kk, vv = pool.kv
        step = srv_mod.decode_step(params, cfg, kk, vv,
                                   np.array([0, tok, tok]),
                                   np.array([pool.junk_pos, 70, 70]))
        ext = tfm.forward(params, torch.tensor([prompt.tolist() + [tok]],
                                               device=cuda_device), cfg)[0, -1]
        near(step[1], ext)
        near(step[2], ext)


@pytest.mark.cuda
def test_pool_and_published_params_sit_on_the_party_card(cuda_device):
    cfg = _cfg()
    host_params = tfm.init_params(3, cfg, device="cpu")
    for layout in ("slab", "paged"):
        srv = InferenceServer(
            cfg, ServingConfig(max_slots=2, max_len=64, max_new_tokens=4,
                               kv_layout=layout),
            params=host_params, device=cuda_device)
        try:
            k, v = srv.pool._k, srv.pool._v
            assert k.device == v.device == cuda_device
            assert k.dtype == cfg.compute_dtype
            version = srv.publish(host_params)
            for leaf in torch.utils._pytree.tree_leaves(srv.bank.get(version)):
                assert leaf.device == cuda_device
            # A copy, never the caller's tensors.
            assert srv.bank.zerocopy_adopted() == 0
            assert len(srv.submit_and_wait([5, 6, 7])["tokens"]) == 4
        finally:
            srv.stop()


@pytest.mark.cuda
def test_server_without_a_device_resolves_to_the_card(cuda_device):
    cfg = _cfg()
    srv = InferenceServer(cfg, ServingConfig(max_slots=2, max_len=32,
                                             max_new_tokens=4),
                          params=tfm.init_params(4, cfg, device="cpu"))
    try:
        assert srv.device.type == "cuda"
        assert srv.device.index == torch.cuda.current_device()
        assert srv.pool.device == srv.device
        resp = srv.submit_and_wait([9, 8, 7, 6])
        assert len(resp["tokens"]) == 4
    finally:
        srv.stop()
