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
                           "flash_bwd_dkv": 0, "flash_fwd_f32": 0,
                           "flash_bwd_dq_f32": 0, "flash_bwd_dkv_f32": 0}


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
