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

"""The port's flash attention against the JAX package's Pallas kernels.

Same numpy inputs through both: the JAX side runs its kernels in interpret
mode on the CPU (as ``test_flash_attention.py`` does), the port its plain
versions. Tolerances are ``test_flash_attention.py``'s: 2e-5 on f32
outputs, 3e-4 on f32 gradients, 3e-2 on bf16 outputs. The Hopper kernels
are held against the plain versions on the card by
``test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayfed_tpu.models import transformer as jtfm
from rayfed_tpu.ops import flash_attention as jfa
from rayfed_tpu_torch.models import transformer as tfm
from rayfed_tpu_torch.ops import flash_attention as fa

# The suite runs in several worker processes on one host: a small torch
# thread pool keeps these tests from starving timing-sensitive ones.
torch.set_num_threads(2)


def _inputs(seed, shapes, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32).astype(dtype)
            for s in shapes]


def _both(arrs, jdtype=jnp.float32, tdtype=torch.float32):
    return ([jnp.asarray(a, jdtype) for a in arrs],
            [torch.from_numpy(a).to(tdtype) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("s,block", [(64, 16), (128, 128), (96, 32)])
def test_fwd_raw_matches_pallas(s, block):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(0, [(2, s, 2, 32)] * 3))
    jo, jl = jfa._flash_fwd_raw(jq, jk, jv, block, block, True, 0)
    to, tl = fa._flash_fwd_raw(tq, tk, tv, block, block, True, 0)
    assert to.shape == (2, s, 2, 32) and tl.shape == (2, s, 2)
    _close(to, jo, 2e-5)
    _close(tl, jl, 2e-5)


def test_fwd_raw_q_offset_and_short_queries():
    # Sq < Sk with the queries starting at q_offset (a ring step's shape).
    arrs = _inputs(1, [(1, 32, 2, 16), (1, 64, 2, 16), (1, 64, 2, 16)])
    (jq, jk, jv), (tq, tk, tv) = _both(arrs)
    jo, jl = jfa._flash_fwd_raw(jq, jk, jv, 16, 16, True, 32)
    to, tl = fa._flash_fwd_raw(tq, tk, tv, 16, 16, True, 32)
    _close(to, jo, 2e-5)
    _close(tl, jl, 2e-5)


@pytest.mark.parametrize("sq,sk,q_offset", [(64, 64, 0), (32, 64, 32)])
def test_bwd_passes_match_pallas(sq, sk, q_offset):
    """dq and dk/dv from the same (o, lse, do), as ring attention calls
    the internals."""
    arrs = _inputs(2, [(1, sq, 2, 16), (1, sk, 2, 16), (1, sk, 2, 16),
                       (1, sq, 2, 16)])
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(arrs)
    jo, jl = jfa._flash_fwd_raw(jq, jk, jv, 16, 16, True, q_offset)
    jgrads = jfa._flash_bwd_pallas(jq, jk, jv, jo, jl, jdo, 16, 16, True,
                                   q_offset)
    to = torch.from_numpy(np.array(jo))
    tl = torch.from_numpy(np.array(jl))
    tgrads = fa._flash_bwd_raw(tq, tk, tv, to, tl, tdo, 16, 16, True,
                               q_offset)
    for got, want in zip(tgrads, jgrads):
        _close(got, want, 3e-4)


def test_padded_head_dim_plain_path_matches_pallas():
    """D = 80, which the Hopper kernels run zero-padded to 128: the plain
    path (what a CPU tensor takes) against the Pallas kernels in
    interpret mode, forward and both backward passes."""
    arrs = _inputs(8, [(1, 64, 2, 80)] * 4)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(arrs)
    jo, jl = jfa._flash_fwd_raw(jq, jk, jv, 16, 16, True, 0)
    to, tl = fa._flash_fwd_raw(tq, tk, tv, 16, 16, True, 0)
    _close(to, jo, 2e-5)
    _close(tl, jl, 2e-5)
    jgrads = jfa._flash_bwd_pallas(jq, jk, jv, jo, jl, jdo, 16, 16, True, 0)
    tgrads = fa._flash_bwd_raw(tq, tk, tv, torch.from_numpy(np.array(jo)),
                               torch.from_numpy(np.array(jl)), tdo, 16, 16,
                               True, 0)
    for got, want in zip(tgrads, jgrads):
        _close(got, want, 3e-4)
    assert fa.kernel_head_dim(80) == 128 and fa.kernel_head_dim(64) == 64


# Head dims past 128: the kernels of both dtypes run them on their D=256
# plans, D below 256 zero-padded to it.
WIDE_HEAD_DIMS = [136, 160, 192, 256]


@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
def test_wide_head_dim_plain_path_matches_pallas(d):
    """The plain path at D > 128 against the Pallas kernels in interpret
    mode, f32: the forward and both backward passes, Sq < Sk with the
    queries at q_offset > 0 (a ring step's shape)."""
    sq, sk, q_offset = 32, 64, 32
    arrs = _inputs(9, [(1, sq, 2, d), (1, sk, 2, d), (1, sk, 2, d),
                       (1, sq, 2, d)])
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(arrs)
    jo, jl = jfa._flash_fwd_raw(jq, jk, jv, 16, 16, True, q_offset)
    to, tl = fa._flash_fwd_raw(tq, tk, tv, 16, 16, True, q_offset)
    _close(to, jo, 2e-5)
    _close(tl, jl, 2e-5)
    jgrads = jfa._flash_bwd_pallas(jq, jk, jv, jo, jl, jdo, 16, 16, True,
                                   q_offset)
    tgrads = fa._flash_bwd_raw(tq, tk, tv, torch.from_numpy(np.array(jo)),
                               torch.from_numpy(np.array(jl)), tdo, 16, 16,
                               True, q_offset)
    for got, want in zip(tgrads, jgrads):
        _close(got, want, 3e-4)


# The f32 D=256 plan's awkward geometries (64-row blocks against 16-row
# stages; chip_smoke.WIDE_SHAPES' ragged and q_offset cases at small B*H):
# the plain path the kernels are held to on the card, in f32, against the
# Pallas kernels in interpret mode, with chip_smoke's block sizes.
F32_WIDE_GEOMETRIES = [
    (2, 96, 160, 3, 136, 64),     # ragged tiles, Sq < Sk, q_offset
    (1, 136, 328, 3, 192, 150),   # q_offset off a stage boundary
    (1, 136, 328, 3, 256, 192),   # q_offset on a tile boundary
    (1, 100, 90, 2, 256, 20),     # queries past the last key
]


@pytest.mark.parametrize("b,sq,sk,h,d,q_offset", F32_WIDE_GEOMETRIES)
def test_f32_wide_geometry_plain_path_matches_pallas(b, sq, sk, h, d,
                                                     q_offset):
    bq, bk = fa._pow2_block(sq, 512), fa._pow2_block(sk, 512)
    arrs = _inputs(11, [(b, sq, h, d), (b, sk, h, d), (b, sk, h, d),
                        (b, sq, h, d)])
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(arrs)
    jo, jl = jfa._flash_fwd_raw(jq, jk, jv, bq, bk, True, q_offset)
    to, tl = fa._flash_fwd_raw(tq, tk, tv, bq, bk, True, q_offset)
    _close(to, jo, 2e-5)
    _close(tl, jl, 2e-5)
    jgrads = jfa._flash_bwd_pallas(jq, jk, jv, jo, jl, jdo, bq, bk, True,
                                   q_offset)
    tgrads = fa._flash_bwd_raw(tq, tk, tv, torch.from_numpy(np.array(jo)),
                               torch.from_numpy(np.array(jl)), tdo, bq, bk,
                               True, q_offset)
    for got, want in zip(tgrads, jgrads):
        _close(got, want, 3e-4)
    assert fa.kernel_head_dim(d, torch.float32) == 256


@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
def test_wide_head_dim_bf16_matches_pallas(d):
    """bf16 at D > 128, as ``test_bf16_matches_pallas`` holds D=16: the
    differentiable entry point's output and its gradients through the
    custom VJP, against the JAX package's, to the bf16 tolerance."""
    arrs = _inputs(10, [(1, 64, 2, d)] * 3)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, jnp.bfloat16, torch.bfloat16)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, block_q=16, block_k=16)
        return (o.astype(jnp.float32) ** 2).sum(), o

    (_, jo), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(jq, jk, jv)
    tq, tk, tv = (x.requires_grad_(True) for x in (tq, tk, tv))
    to = fa.flash_attention(tq, tk, tv, block_q=16, block_k=16)
    (to.float() ** 2).sum().backward()
    assert to.dtype == torch.bfloat16
    _close(to, jo, 3e-2)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _close(got, want, 3e-2)


@pytest.mark.parametrize("d,want", [(16, 16), (80, 128), (128, 128),
                                    (129, 256), (200, 256), (256, 256)])
def test_kernel_head_dim_in_bf16(d, want):
    assert fa.kernel_head_dim(d) == want
    assert fa.kernel_head_dim(d, torch.bfloat16) == want


@pytest.mark.parametrize("d,want", [(16, 16), (80, 128), (128, 128),
                                    (129, 256), (200, 256), (256, 256)])
def test_kernel_head_dim_in_f32(d, want):
    assert fa.kernel_head_dim(d, torch.float32) == want


@pytest.mark.parametrize("kind,kd,want", [
    ("flash_fwd", 128, "flash_fwd"),
    ("flash_bwd_dkv", 256, "flash_bwd_dkv_d256"),
    ("flash_bwd_dq_f32", 64, "flash_bwd_dq_f32"),
    ("flash_fwd_f32", 256, "flash_fwd_f32_d256"),
    ("flash_bwd_dq_f32", 256, "flash_bwd_dq_f32_d256"),
    ("flash_bwd_dkv_f32", 256, "flash_bwd_dkv_f32_d256"),
])
def test_launch_key_names_each_plan(kind, kd, want):
    assert fa._launch_key(kind, kd) == want
    assert want in fa.LAUNCHES


def test_kernel_head_dim_refusals_name_their_roadmap_rows():
    # f32 takes D=256 too (its own plan): only D > 256 is refused.
    assert fa.kernel_head_dim(160, torch.float32) == 256
    assert fa.kernel_head_dim(80, torch.float32) == 128
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(NotImplementedError,
                           match="Queue 2, 'head dims above 256'"):
            fa.kernel_head_dim(257, dtype)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.kernel_head_dim(64, torch.float16)


def test_autograd_matches_jax_grad():
    """The autograd.Function's backward against jax.grad through the
    custom_vjp, and the forward's value too."""
    arrs = _inputs(7, [(2, 64, 4, 32)] * 3)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs)

    def jloss(q, k, v):
        return (jfa.flash_attention(q, k, v, block_q=16, block_k=16) ** 2).sum()

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (x.requires_grad_(True) for x in (tq, tk, tv))
    tval = (fa.flash_attention(tq, tk, tv, block_q=16, block_k=16) ** 2).sum()
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=2e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _close(got, want, 3e-4)


def test_bf16_matches_pallas():
    arrs = _inputs(3, [(1, 32, 2, 16)] * 3)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, jnp.bfloat16, torch.bfloat16)
    jo = jfa.flash_attention(jq, jk, jv, block_q=16, block_k=16)
    to = fa.flash_attention(tq, tk, tv, block_q=16, block_k=16)
    assert to.dtype == torch.bfloat16
    _close(to, jo, 3e-2)


def test_make_flash_attn_fn_follows_min_block_rule():
    """Short sequences go to the dense attention exactly as in the
    reference; tiled ones go to flash. Both match the JAX attn_fn."""
    for s in (8, 32):  # 8 < min_block=16 -> dense; 32 -> flash
        arrs = _inputs(4, [(1, s, 2, 16)] * 3)
        (jq, jk, jv), (tq, tk, tv) = _both(arrs)
        want = jfa.make_flash_attn_fn(block_q=16, block_k=16)(jq, jk, jv)
        got = fa.make_flash_attn_fn(block_q=16, block_k=16)(tq, tk, tv)
        _close(got, want, 2e-5)
    tqkv = _both(_inputs(4, [(1, 8, 2, 16)] * 3))[1]
    assert torch.equal(fa.make_flash_attn_fn()(*tqkv),
                       tfm.causal_attention(*tqkv))


def test_causal_attention_matches_reference_with_offset():
    arrs = _inputs(5, [(1, 16, 2, 16), (1, 32, 2, 16), (1, 32, 2, 16)])
    (jq, jk, jv), (tq, tk, tv) = _both(arrs)
    _close(tfm.causal_attention(tq, tk, tv, q_offset=16),
           jtfm.causal_attention(jq, jk, jv, q_offset=16), 2e-5)


def test_cuda_wrappers_refuse_cpu_and_mixed_tensors():
    q = torch.zeros(1, 16, 1, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa._flash_fwd_cuda(q, q, q, 0)
    with pytest.raises(ValueError, match="all-CPU or all-CUDA"):
        fa._flash_fwd_raw(q, q.to("meta"), q, 16, 16, None, 0)


def test_plain_path_launches_no_kernel():
    fa.reset_launch_counts()
    tq, tk, tv = _both(_inputs(6, [(1, 32, 2, 16)] * 3))[1]
    tq.requires_grad_(True)
    fa.flash_attention(tq, tk, tv, block_q=16, block_k=16).sum().backward()
    assert fa.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0, "flash_fwd_d256": 0,
                           "flash_bwd_dq_d256": 0, "flash_bwd_dkv_d256": 0,
                           "flash_fwd_f32": 0, "flash_bwd_dq_f32": 0,
                           "flash_bwd_dkv_f32": 0, "flash_fwd_f32_d256": 0,
                           "flash_bwd_dq_f32_d256": 0,
                           "flash_bwd_dkv_f32_d256": 0}


@pytest.mark.parametrize("q_offset", [0, 5])
def test_reference_positional_arguments_match_the_jax_package(q_offset):
    """The reference's order (q, k, v, block_q, block_k, interpret,
    q_offset), positionally: ``interpret`` is taken at its place and
    ignored, so ``q_offset`` lands where the JAX package reads it."""
    sq, sk = 32, 48
    arrs = _inputs(8, [(1, sq, 2, 16), (1, sk, 2, 16), (1, sk, 2, 16),
                       (1, sq, 2, 16)])
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(arrs)
    args = (16, 16, True) if q_offset == 0 else (16, 16, True, q_offset)
    jo = jfa.flash_attention(jq, jk[:, :sq], jv[:, :sq], *args)
    to = fa.flash_attention(tq, tk[:, :sq], tv[:, :sq], *args)
    _close(to, jo, 2e-5)
    # The raw passes, as ring attention calls them: Sk > Sq at an offset.
    jo, jl = jfa._flash_fwd_raw(jq, jk, jv, 16, 16, True, q_offset)
    to, tl = fa._flash_fwd_raw(tq, tk, tv, 16, 16, True, q_offset)
    _close(to, jo, 2e-5)
    _close(tl, jl, 2e-5)
    jgrads = jfa._flash_bwd_pallas(jq, jk, jv, jo, jl, jdo, 16, 16, True,
                                   q_offset)
    tgrads = fa._flash_bwd_raw(tq, tk, tv, to, tl, tdo, 16, 16, True,
                               q_offset)
    for got, want in zip(tgrads, jgrads):
        _close(got, want, 3e-4)
