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

from chip_smoke import BF16_TILE_REL_TOL, WIDE_SHAPES, tile_rel_err
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


# Head dims past 128 run on each dtype's D=256 plan, D below 256
# zero-padded to it: chip_smoke.py's phase 12 shapes, held to its limits
# (f32: 2e-5 on O, 1e-4 on lse and delta, 3e-4 on the gradients).
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b,sq,sk,h,d,q_offset", WIDE_SHAPES)
def test_wide_head_dim_kernels_match_plain_on_card(cuda_device, b, sq, sk, h,
                                                   d, q_offset, dtype):
    from chip_smoke import kernel_errors

    sfx = "" if dtype == "bfloat16" else "_f32"
    names = ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"]
    fa.reset_launch_counts()
    readings, errs, _ = kernel_errors(cuda_device, b, sq, sk, h, d, q_offset,
                                      dtype=dtype)
    assert sorted(errs) == sorted(n + sfx + "_d256" for n in names)
    for name, (err, limit) in readings.items():
        assert err <= limit, (name, err, limit)
    # The D=256 plan ran, not the D <= 128 one, nor the other dtype's.
    assert {k: n for k, n in fa.LAUNCHES.items() if n} == {
        n + sfx + "_d256": 1 for n in names}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_wide_head_dim_kernels_do_not_spill(cuda_device, dtype):
    from chip_smoke import kernel_resources
    from rayfed_tpu_torch.ops import _native

    with open(_native.build() + ".log") as f:
        log = f.read()
    kernels = _native.KERNEL_NAMES[:3] if dtype == "bf16" \
        else _native.KERNEL_NAMES[3:]
    res = kernel_resources(log, 256, kernels)
    for name, r in res.items():
        assert r["spill_bytes"] == 0, (name, r)
        assert r["blocks_per_sm"] == 1, (name, r)
        assert r["registers"] <= 255, (name, r)
        assert r["smem_bytes"] <= 232448, (name, r)


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
# clean shape, a ragged one, one with q_offset off a tile boundary, and
# one on the D=256 plan.
EXACT_SHAPES = [SHAPES[3], SHAPES[4], SHAPES[6], (1, 512, 512, 4, 256, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,d,q_offset", EXACT_SHAPES)
def test_f32_kernels_are_exact_f32_on_card(cuda_device, b, sq, sk, h, d,
                                           q_offset):
    from chip_smoke import EXACT_F32_FRACTION, kernel_errors

    readings = kernel_errors(cuda_device, b, sq, sk, h, d, q_offset,
                             dtype="float32", exact_f32=True)[0]
    assert not torch.backends.cuda.matmul.allow_tf32
    exact = {n: rl for n, rl in readings.items() if n.endswith(" exact")}
    tag = " f32 d256" if d == 256 else " f32"
    assert sorted(exact) == [f"K1{tag} O exact", f"K1{tag} lse exact",
                             f"K2{tag} dq exact", f"K3{tag} dk exact",
                             f"K3{tag} dv exact"]
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
    # f32 at D=160 runs (zero-padded to the D=256 plan); either dtype past
    # D=256 raises, naming its row.
    y = torch.zeros((1, 64, 2, 160), device=cuda_device)
    fa.reset_launch_counts()
    o, lse = fa._flash_fwd_cuda(y, y, y, 0)
    assert o.shape == y.shape and fa.LAUNCHES["flash_fwd_f32_d256"] == 1
    for dtype in (torch.bfloat16, torch.float32):
        z = torch.zeros((1, 64, 2, 320), device=cuda_device, dtype=dtype)
        with pytest.raises(NotImplementedError,
                           match="Queue 2, 'head dims above 256'"):
            fa._flash_fwd_cuda(z, z, z, 0)
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
@pytest.mark.parametrize("width", ["tiny", "wide"])
def test_f32_model_takes_the_f32_kernels(cuda_device, width):
    # make_fed_train_step(attn="auto") picks flash on a card; in f32 its
    # step goes through the f32 kernels of its head dim's plan (4 heads of
    # 32, or chip_smoke.WIDE's 8 heads of 256 at 2 layers) and matches the
    # dense attention.
    import dataclasses

    from chip_smoke import WIDE
    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.parallel.train import make_fed_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    shape = dict(d_model=128, n_heads=4) if width == "tiny" else dict(
        d_model=WIDE["d_model"], n_heads=WIDE["n_heads"], d_ff=WIDE["d_ff"])
    sfx = "_f32" if width == "tiny" else "_f32_d256"
    cfg = dataclasses.replace(tfm.tiny_config(**shape),
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
            names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
            assert {k: n for k, n in fa.LAUNCHES.items() if n}.keys() == {
                n + sfx for n in names}
    assert abs(losses["auto"] - losses["xla"]) <= 1e-4 * abs(losses["xla"])


# The bf16 K1 and K3 at D=256 are warp-specialised: a producer warpgroup
# feeding TMA copies into a ring, two consumer warpgroups on wgmma
# (csrc/flash_attention_d256.cu). So are the f32 K2 and K3 at D=256, on
# mma.sync (csrc/flash_attention_f32_d256.cu).
D256_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkv_kernel")
F32_D256_KERNELS = ("flash_bwd_dq_f32_kernel", "flash_bwd_dkv_f32_kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,row0", [(64, 0), (64, 190), (80, 150),
                                       (128, 100)])
def test_tma_tile_matches_cp_async_tile_on_card(cuda_device, rows, row0):
    # One tile loaded by TMA (the D=256 kernels) and by cp.async (the
    # D <= 128 kernels' load_sw_tile) lands as the same shared-memory
    # bytes: the 128-byte swizzle the wgmma descriptors read, rows past S
    # zero-filled, through a strided (b, s, h) view.
    import ctypes

    from rayfed_tpu_torch.ops import _native

    g = torch.Generator(device=cuda_device).manual_seed(rows + row0)
    x = torch.randn((2, 200, 3, 5, 256), generator=g, device=cuda_device,
                    dtype=torch.float32).to(torch.bfloat16)[:, :, 1]
    dims = (ctypes.c_longlong * 6)(2, 200, 5, *x.stride()[:3])
    got = {n: torch.zeros(rows * 512, dtype=torch.uint8, device=cuda_device)
           for n in ("tma", "cp")}
    code = _native.lib().rf_tma_tile_check(
        x.data_ptr(), ctypes.addressof(dims), 1, 3, row0, rows,
        got["tma"].data_ptr(), got["cp"].data_ptr(),
        torch.cuda.current_stream(cuda_device).cuda_stream)
    _native.check(code, "rf_tma_tile_check")
    torch.cuda.synchronize()
    assert torch.equal(got["tma"], got["cp"])
    # Each 64-column block holds `rows` rows of 128 bytes: rows past S =
    # 200 are zeros, the rest x's values.
    live = min(rows, 200 - row0) * 128
    for block in got["tma"].view(4, rows * 128):
        assert not block[live:].any()
        assert block[:live].view(torch.bfloat16).float().abs().sum() > 0


@pytest.mark.cuda
def test_d256_kernels_resources_on_card(cuda_device):
    from chip_smoke import kernel_resources
    from rayfed_tpu_torch.ops import _native

    with open(_native.build() + ".log") as f:
        log = f.read()
    for name, r in kernel_resources(log, 256,
                                    D256_KERNELS + F32_D256_KERNELS).items():
        # A producer warpgroup and two consumers; one block per SM; the
        # launch's registers (168 a thread) are what setmaxnreg moves.
        assert r["threads"] == 384, (name, r)
        assert r["blocks_per_sm"] == 1, (name, r)
        assert r["registers"] <= 168, (name, r)
        assert 196608 <= r["smem_bytes"] <= 232448, (name, r)
        assert r["spill_bytes"] == 0, (name, r)
    assert "Potential Performance Loss" not in "".join(
        line for line in log.splitlines() if "_d256_cu" in line)


@pytest.mark.cuda
@pytest.mark.parametrize("q_offset", [0, 64])
def test_d256_kernels_take_fused_qkv_views_on_card(cuda_device, q_offset):
    # q, k, v as strided views of one (B, S, 3, H, D) tensor, as a fused
    # projection gives them: the tensor maps read the (b, s, h) strides
    # (bf16 K1 and K3; f32 K2 and K3).
    b, s, h, d = 2, 200, 3, 256
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(7)
    qkv = torch.randn((b, s, 3, h, d), generator=g, device=cuda_device,
                      dtype=torch.float32)
    do32 = torch.randn((b, s, h, d), generator=g, device=cuda_device,
                       dtype=torch.float32)
    bq = bk = fa._pow2_block(s, 512)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = qkv.to(dtype).unbind(2)
        do = do32.to(dtype)
        assert not q.is_contiguous() and q.stride(1) == 3 * h * d
        o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, bq, bk, q_offset)
        dq_ref, delta_ref = fa._flash_bwd_dq_plain(q, k, v, o_ref, lse_ref,
                                                   do, bq, bk, q_offset)
        dk_ref, dv_ref = fa._flash_bwd_dkv_plain(q, k, v, do, lse_ref,
                                                 delta_ref, bq, bk, q_offset)
        fa.reset_launch_counts()
        o, lse = fa._flash_fwd_cuda(q, k, v, q_offset)
        dq, delta = fa._flash_bwd_dq_cuda(q, k, v, o_ref, lse_ref, do,
                                          q_offset)
        dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse_ref, delta_ref,
                                        q_offset)
        torch.cuda.synchronize()
        sfx = "_d256" if dtype == torch.bfloat16 else "_f32_d256"
        assert {n: c for n, c in fa.LAUNCHES.items() if c} == {
            n + sfx: 1 for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        assert float((lse - lse_ref).abs().max()) < 1e-3
        assert float((delta - delta_ref).abs().max()) < 1e-3
        if dtype == torch.bfloat16:
            for got, want in ((o, o_ref), (dq, dq_ref), (dk, dk_ref),
                              (dv, dv_ref)):
                assert tile_rel_err(got, want) <= BF16_TILE_REL_TOL
        else:
            assert _max_abs(o, o_ref) <= 2e-5
            for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
                assert _max_abs(got, want) <= 3e-4


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,q_offset", [(2, 512, 512, 4, 0),
                                                (1, 136, 328, 3, 150)])
def test_d256_kernels_are_deterministic_on_card(cuda_device, b, sq, sk, h,
                                                q_offset):
    # No atomics: two launches on the same inputs give the same bits, in
    # both dtypes (the f32 K2 and K3 sum each pair's partial scores in a
    # fixed order).
    from chip_smoke import _inputs

    for dtype in ("bfloat16", "float32"):
        q, k, v, do = _inputs(cuda_device, b, sq, sk, h, 256, 3, dtype)
        o1, lse1 = fa._flash_fwd_cuda(q, k, v, q_offset)
        o2, lse2 = fa._flash_fwd_cuda(q, k, v, q_offset)
        dq1, delta1 = fa._flash_bwd_dq_cuda(q, k, v, o1, lse1, do, q_offset)
        dq2, delta2 = fa._flash_bwd_dq_cuda(q, k, v, o1, lse1, do, q_offset)
        dk1, dv1 = fa._flash_bwd_dkv_cuda(q, k, v, do, lse1, delta1,
                                          q_offset)
        dk2, dv2 = fa._flash_bwd_dkv_cuda(q, k, v, do, lse1, delta1,
                                          q_offset)
        torch.cuda.synchronize()
        for one, two in ((o1, o2), (lse1, lse2), (dq1, dq2),
                         (delta1, delta2), (dk1, dk2), (dv1, dv2)):
            assert torch.equal(one, two), dtype


@pytest.mark.cuda
def test_d256_kernels_raise_on_strides_tma_cannot_take(cuda_device):
    # A TMA tensor map needs (b, s, h) strides of whole 16 bytes, and the
    # wrapper asks whole 8 elements of both dtypes: a head stride of 260
    # elements (520 bytes in bf16) is refused there, the stride named, and
    # never goes to another path.
    lse = torch.zeros((1, 64, 2), device=cuda_device)
    fa.reset_launch_counts()
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.zeros((1, 64, 2, 260), device=cuda_device,
                        dtype=dtype)[..., :256]
        y = torch.zeros((1, 64, 2, 256), device=cuda_device, dtype=dtype)
        with pytest.raises(ValueError, match="stride 260 of dim 2"):
            fa._flash_fwd_cuda(x, y, y, 0)
        with pytest.raises(ValueError, match="stride 260 of dim 2"):
            fa._flash_bwd_dq_cuda(y, x, y, y, lse, y, 0)
        with pytest.raises(ValueError, match="stride 260 of dim 2"):
            fa._flash_bwd_dkv_cuda(y, y, x, y, lse, lse, 0)
    assert not any(fa.LAUNCHES.values())
