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

"""The Hopper flash kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips without a card (the
kernels have no CPU mode). The file imports neither JAX nor the JAX
package, so it runs on a machine that has only the port:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from chip_smoke import BF16_TILE_REL_TOL, tile_rel_err
from rayfed_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda", 0)


# bf16 outputs differ from the plain versions by where the online softmax
# rounds P to bf16 (64-wide tiles vs the plain version's blocks), about one
# bf16 ulp: held per 64-row tile of the sequence by the error's norm over
# the plain version's, as chip_smoke.py holds them. lse/delta are f32. The
# f32 kernels round nothing between products: their outputs are held by
# the largest absolute error, to the JAX package's f32 tolerances (2e-5 on
# O, 3e-4 on the gradients; tests/test_flash_attention.py).

SHAPES = [
    (2, 128, 128, 2, 16, 0),
    (1, 96, 160, 3, 32, 64),   # ragged tiles, Sq < Sk, q_offset
    (2, 256, 256, 2, 64, 0),
    (1, 512, 512, 4, 128, 0),
    # bf16: K1 tiles 128 queries x 128 keys, K2 128 queries x 64 keys, K3
    # 128 keys x 64 queries; f32: K1 and K2 128 queries x 32 keys, K3 128
    # keys x 32 queries:
    (2, 200, 200, 2, 128, 0),      # S not a multiple of 128 (nor of 64)
    (1, 136, 328, 3, 128, 192),    # Sq < Sk, q_offset on a tile boundary
    (1, 136, 328, 3, 128, 150),    # Sq < Sk, q_offset off it
    (4, 1024, 1024, 16, 128, 0),   # B*H = 64: blocks run in several waves
    (2, 1024, 1024, 4, 64, 0),     # D = 64 at S = 1024
    (2, 64, 64, 2, 128, 0),        # a 128-row block's second warpgroup
                                   # holds no valid row
    (1, 72, 200, 3, 128, 128),     # Sq = 72 < Sk, q_offset 128
    (1, 100, 90, 2, 64, 20),       # queries past the last key: Sk ends
                                   # mid-stage before their diagonal
    # Head dims the kernels take zero-padded to the next of 16/32/64/128:
    (1, 200, 200, 2, 48, 0),
    (2, 96, 160, 3, 80, 64),
    (1, 136, 328, 3, 96, 150),
    (4096, 64, 64, 16, 64, 0),     # B*H = 65536 on the grid's x dimension
]


def _max_abs(got, want):
    return float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b,sq,sk,h,d,q_offset", SHAPES)
def test_kernels_match_plain_on_card(cuda_device, b, sq, sk, h, d, q_offset,
                                     dtype):
    # The f32 yardstick runs its products in full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(s):
        return torch.randn((b, s, h, d), generator=g, device=cuda_device,
                           dtype=torch.float32).to(dtype)

    if dtype == torch.bfloat16:
        def out_ok(got, want):
            return tile_rel_err(got, want) <= BF16_TILE_REL_TOL
        grad_ok = out_ok
    else:
        def out_ok(got, want):
            return _max_abs(got, want) <= 2e-5

        def grad_ok(got, want):
            return _max_abs(got, want) <= 3e-4

    q, k, v, do = rnd(sq), rnd(sk), rnd(sk), rnd(sq)
    bq, bk = fa._pow2_block(sq, 512), fa._pow2_block(sk, 512)
    o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, bq, bk, q_offset)
    o, lse = fa._flash_fwd_cuda(q, k, v, q_offset)
    assert o.dtype == dtype
    assert out_ok(o, o_ref)
    assert float((lse - lse_ref).abs().max()) < 1e-3
    dq_ref, delta_ref = fa._flash_bwd_dq_plain(q, k, v, o_ref, lse_ref, do,
                                               bq, bk, q_offset)
    dq, delta = fa._flash_bwd_dq_cuda(q, k, v, o_ref, lse_ref, do, q_offset)
    assert grad_ok(dq, dq_ref)
    assert float((delta - delta_ref).abs().max()) < 1e-3
    dk_ref, dv_ref = fa._flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta_ref,
                                             bq, bk, q_offset)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse_ref, delta_ref, q_offset)
    torch.cuda.synchronize()
    assert grad_ok(dk, dk_ref)
    assert grad_ok(dv, dv_ref)


# Exact f32: each f32 kernel's error is at most a tenth of the error of
# one TF32 product per f32 product (the plain version with allow_tf32) on
# the same inputs; the f32 K1-K3 multiply as three TF32 products. A
# clean shape, a ragged one and one with q_offset off a tile boundary.
EXACT_SHAPES = [SHAPES[3], SHAPES[4], SHAPES[6]]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,d,q_offset", EXACT_SHAPES)
def test_f32_kernels_are_exact_f32_on_card(cuda_device, b, sq, sk, h, d,
                                           q_offset):
    from chip_smoke import EXACT_F32_FRACTION, kernel_errors

    readings = kernel_errors(cuda_device, b, sq, sk, h, d, q_offset,
                             dtype="float32", exact_f32=True)[0]
    assert not torch.backends.cuda.matmul.allow_tf32
    exact = {n: rl for n, rl in readings.items() if n.endswith(" exact")}
    assert sorted(exact) == ["K1 f32 O exact", "K1 f32 lse exact",
                             "K2 f32 dq exact", "K3 f32 dk exact",
                             "K3 f32 dv exact"]
    for name, (err, limit) in exact.items():
        assert err <= limit, (name, err, limit / EXACT_F32_FRACTION)


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_untaken_inputs(cuda_device):
    x = torch.zeros((1, 64, 2, 16), device=cuda_device, dtype=torch.bfloat16)
    # bf16 and f32 are taken; any other dtype, or a mix, is not.
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa._flash_fwd_cuda(x.half(), x.half(), x.half(), 0)
    with pytest.raises(TypeError, match="one dtype"):
        fa._flash_fwd_cuda(x.float(), x, x.float(), 0)
    with pytest.raises(TypeError, match="one dtype"):
        fa._flash_bwd_dq_cuda(x, x, x, x.float(),
                              torch.zeros((1, 64, 2), device=cuda_device),
                              x, 0)
    y = torch.zeros((1, 64, 2, 160), device=cuda_device,
                    dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="head dims above 128"):
        fa._flash_fwd_cuda(y, y, y, 0)
    # The grid's y dimension counts 128-row tiles, at most 65535.
    w = torch.zeros((1, 128 * 65535 + 1, 1, 16), device=cuda_device,
                    dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="grid's y limit"):
        fa._flash_fwd_cuda(w, w, w, 0)
    z = torch.zeros((1, 64, 2, 32), device=cuda_device,
                    dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="layout"):
        fa._flash_fwd_cuda(z, z, z, 0)


@pytest.mark.cuda
def test_f32_model_takes_the_f32_kernels(cuda_device):
    # make_fed_train_step(attn="auto") picks flash on a card; in f32 its
    # step goes through the f32 kernels and matches the dense attention.
    import dataclasses

    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.parallel.train import make_fed_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(tfm.tiny_config(d_model=128, n_heads=4),
                              compute_dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab, (2, 129),
                           generator=torch.Generator().manual_seed(0))
    losses = {}
    for attn in ("auto", "xla"):
        fa.reset_launch_counts()
        init_fn, step_fn = make_fed_train_step(cfg, cuda_device, attn=attn)
        params, opt = init_fn(0)
        _, _, loss = step_fn(params, opt, tokens[:, :-1], tokens[:, 1:])
        losses[attn] = float(loss)
        if attn == "auto":
            assert all(fa.LAUNCHES[n] > 0 for n in (
                "flash_fwd_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32"))
            assert fa.LAUNCHES["flash_fwd"] == 0
    assert abs(losses["auto"] - losses["xla"]) <= 1e-4 * abs(losses["xla"])
