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

"""Causal flash attention with a blockwise backward: Hopper kernels and
their plain PyTorch versions (port of ``rayfed_tpu/ops/flash_attention.py``).

The three Pallas TPU kernels take bf16 or f32 inputs; each has two
hand-written CUDA C++ counterparts for ``sm_90a``, one per dtype: the bf16
ones on ``wgmma`` (``csrc/flash_attention.cu``), the f32 ones in exact f32
(``csrc/flash_attention_f32.cu``): the forward on the CUDA cores, the two
backward passes on the tensor cores, each f32 product as three TF32
``mma.sync`` products:

- ``_flash_fwd_cuda`` launches ``flash_fwd_kernel`` or
  ``flash_fwd_f32_kernel``, which replace ``_flash_kernel`` (the forward);
- ``_flash_bwd_dq_cuda`` launches ``flash_bwd_dq_kernel`` or
  ``flash_bwd_dq_f32_kernel``, which replace ``_flash_bwd_dq_kernel`` (the
  dQ pass);
- ``_flash_bwd_dkv_cuda`` launches ``flash_bwd_dkv_kernel`` or
  ``flash_bwd_dkv_f32_kernel``, which replace ``_flash_bwd_dkv_kernel``
  (the dK/dV pass).

Every wrapper works by its tensors' device: a CPU tensor takes the plain
version (``_flash_*_plain``, which repeats the reference's blocked
arithmetic: ``-1e30`` masking, the ``1e-30`` clamp, f32 accumulation and
the casts to the storage dtype at the reference's places); a CUDA tensor
launches the kernel, or raises on a dtype, head dim or layout the kernel
does not take. There is no fallback between the two. ``LAUNCHES`` counts
kernel launches, so a run can show that it went through the kernels.

The kernels are built for head dims 16, 32, 64 and 128. Any other head
dim up to 128 runs zero-padded to the next of them (q, k, v and dO padded
along D, the scale kept at the true ``D**-0.5``, the outputs sliced back),
as the Pallas kernels take any D; a zero column adds nothing to a score,
so O, lse and the gradients are those of the true D, at the padded D's
work (D=80 on the D=128 kernel: 1.6x the products). Head dims above 128
raise: a D=256 instantiation needs its own register plan (ROADMAP Queue
2, "head dims above 128").

The kernels choose their own tiles (bf16: K1 128 queries x 128 keys, K2
128 queries x 64 keys, K3 128 keys x 64 queries; f32: K1 and K2 128
queries x 32 keys, K3 128 keys x 32 queries) and mask ragged edges,
whatever ``block_q``/``block_k`` say; the block sizes drive the plain
versions. The launch grid is (B·H, row tiles): B·H may reach 2^31-1, the
row tiles of the tiled sequence (Sq for K1 and K2, Sk for K3) 65535. Both dQ kernels also compute ``delta =
rowsum(dO * O)``, which the reference left to XLA between its two backward
passes. The entry points take the reference's arguments in its order;
its ``interpret`` flag is accepted and ignored, since the tensors' device
picks the path.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

_NEG_BIG = -1e30
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
#: Sequence rows each kernel's block owns, every kernel and both dtypes
#: (csrc: bf16 ``FwdCfg``/``DqCfg::kM`` and ``DkvCfg::kN``, 64 x 2
#: warpgroups; f32 ``kM``, 16 x 8 warps). The grid's y dimension counts
#: these tiles and may not pass 65535; its x dimension (B·H) 2^31-1.
_TILE_ROWS = 128
_GRID_Y_MAX = 65535
_GRID_X_MAX = 2**31 - 1

#: Launches of each CUDA kernel; a wrapper adds one where it launches.
LAUNCHES: Dict[str, int] = {
    "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
    "flash_fwd_f32": 0, "flash_bwd_dq_f32": 0, "flash_bwd_dkv_f32": 0,
}
#: The dtypes the kernels take, with the suffix of their C entry points
#: and ``LAUNCHES`` keys.
_KERNEL_DTYPES = {torch.bfloat16: "", torch.float32: "_f32"}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain versions (CPU path; the kernels' yardstick on the card)
# ---------------------------------------------------------------------------


def _bhsd(x):
    """(B, S, H, D) -> (B, H, S, D) f32 view of the values: bf16 x bf16
    products are exact in f32, so f32 matmuls of upcast inputs are the
    MXU's / tensor core's bf16 products with f32 accumulation."""
    return x.permute(0, 2, 1, 3).float()


def _causal_mask(q_pos0, n_q, k_pos0, n_k, device):
    q_pos = q_pos0 + torch.arange(n_q, device=device)[:, None]
    k_pos = k_pos0 + torch.arange(n_k, device=device)[None, :]
    return q_pos >= k_pos


def _flash_fwd_plain(q, k, v, block_q, block_k, q_offset):
    """The forward (``_flash_kernel``): online softmax over causal k/v
    blocks. Returns O (B, Sq, H, D) in q's dtype and lse (B, Sq, H) f32."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = d**-0.5
    qf, kf, vf = _bhsd(q), _bhsd(k), _bhsd(v)
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    for qi in range(sq // block_q):
        rows = slice(qi * block_q, (qi + 1) * block_q)
        qblk = qf[:, :, rows]
        last_q_pos = q_offset + qi * block_q + block_q - 1
        n_kb = min(last_q_pos // block_k + 1, sk // block_k)
        m = torch.full((b, h, block_q), _NEG_BIG, device=q.device)
        l = torch.zeros((b, h, block_q), device=q.device)
        acc = torch.zeros((b, h, block_q, d), device=q.device)
        for kb in range(n_kb):
            cols = slice(kb * block_k, (kb + 1) * block_k)
            s = (qblk @ kf[:, :, cols].transpose(-1, -2)) * scale
            mask = _causal_mask(q_offset + qi * block_q, block_q,
                                kb * block_k, block_k, q.device)
            s = torch.where(mask, s, _NEG_BIG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + p.to(v.dtype).float() @ vf[:, :, cols]
            m = m_new
        l_safe = torch.clamp(l, min=1e-30)
        out[:, :, rows] = (acc / l_safe[..., None]).to(q.dtype)
        lse[:, :, rows] = m + torch.log(l_safe)
    return (out.permute(0, 2, 1, 3).contiguous(),
            lse.permute(0, 2, 1).contiguous())


def _flash_bwd_dq_plain(q, k, v, o, lse, do, block_q, block_k, q_offset):
    """The dQ pass (``_flash_bwd_dq_kernel``) plus ``delta = rowsum(dO*O)``
    in f32. Returns dq (B, Sq, H, D) in q's dtype and delta (B, Sq, H)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = d**-0.5
    delta = (do.float() * o.float()).sum(dim=-1)
    qf, kf, vf, dof = _bhsd(q), _bhsd(k), _bhsd(v), _bhsd(do)
    lsef = lse.permute(0, 2, 1)[..., None]
    deltaf = delta.permute(0, 2, 1)[..., None]
    dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    for qi in range(sq // block_q):
        rows = slice(qi * block_q, (qi + 1) * block_q)
        last_q_pos = q_offset + qi * block_q + block_q - 1
        n_kb = min(last_q_pos // block_k + 1, sk // block_k)
        acc = torch.zeros((b, h, block_q, d), device=q.device)
        for kb in range(n_kb):
            cols = slice(kb * block_k, (kb + 1) * block_k)
            kblk = kf[:, :, cols]
            s = (qf[:, :, rows] @ kblk.transpose(-1, -2)) * scale
            mask = _causal_mask(q_offset + qi * block_q, block_q,
                                kb * block_k, block_k, q.device)
            p = torch.where(mask, torch.exp(s - lsef[:, :, rows]), 0.0)
            dp = dof[:, :, rows] @ vf[:, :, cols].transpose(-1, -2)
            ds = (p * (dp - deltaf[:, :, rows]) * scale).to(q.dtype).float()
            acc = acc + ds @ kblk
        dq[:, :, rows] = acc.to(q.dtype)
    return dq.permute(0, 2, 1, 3).contiguous(), delta


def _flash_bwd_dkv_plain(q, k, v, do, lse, delta, block_q, block_k,
                         q_offset):
    """The dK/dV pass (``_flash_bwd_dkv_kernel``): one k block at a time,
    streaming the q blocks at or after its diagonal. Returns dk, dv
    (B, Sk, H, D) in k's and v's dtypes."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = d**-0.5
    qf, kf, vf, dof = _bhsd(q), _bhsd(k), _bhsd(v), _bhsd(do)
    lsef = lse.permute(0, 2, 1)[..., None]
    deltaf = delta.permute(0, 2, 1)[..., None]
    dk = torch.empty((b, h, sk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, h, sk, d), dtype=v.dtype, device=q.device)
    for ki in range(sk // block_k):
        cols = slice(ki * block_k, (ki + 1) * block_k)
        kblk, vblk = kf[:, :, cols], vf[:, :, cols]
        first_q_pos = ki * block_k - q_offset
        qb_start = max(0, (first_q_pos - (block_q - 1)) // block_q)
        acc_k = torch.zeros((b, h, block_k, d), device=q.device)
        acc_v = torch.zeros((b, h, block_k, d), device=q.device)
        for qb in range(qb_start, sq // block_q):
            rows = slice(qb * block_q, (qb + 1) * block_q)
            qblk, doblk = qf[:, :, rows], dof[:, :, rows]
            s = (qblk @ kblk.transpose(-1, -2)) * scale
            mask = _causal_mask(q_offset + qb * block_q, block_q,
                                ki * block_k, block_k, q.device)
            p = torch.where(mask, torch.exp(s - lsef[:, :, rows]), 0.0)
            p_lo = p.to(q.dtype).float()
            acc_v = acc_v + p_lo.transpose(-1, -2) @ doblk
            dp = doblk @ vblk.transpose(-1, -2)
            ds = (p * (dp - deltaf[:, :, rows]) * scale).to(q.dtype).float()
            acc_k = acc_k + ds.transpose(-1, -2) @ qblk
        dk[:, :, cols] = acc_k.to(k.dtype)
        dv[:, :, cols] = acc_v.to(v.dtype)
    return dk.permute(0, 2, 1, 3).contiguous(), dv.permute(0, 2, 1, 3).contiguous()


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _check_qkv(name, x, b, s, h, d, device, dtype, padded=False):
    """Raise unless ``x`` is a (b, s, h, d) tensor the kernels take; a
    tensor to be zero-padded (``padded``) is copied, so any layout does."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, q on {device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the CUDA flash kernels take bfloat16 or float32; "
                        f"{name} is {x.dtype}")
    if x.dtype != dtype:
        raise TypeError(f"{name} is {x.dtype} and q {dtype}: the CUDA flash "
                        "kernels take one dtype for all of q, k, v, o, do")
    if tuple(x.shape) != (b, s, h, d):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {(b, s, h, d)}")
    if padded:
        return
    if x.stride(3) != 1 or any(st % 8 for st in x.stride()[:3]) \
            or x.data_ptr() % 16:
        raise ValueError(
            f"{name} layout not taken by the kernel: strides {x.stride()} "
            "need a unit head-dim stride, the others multiples of 8, and a "
            "16-byte aligned start"
        )


def _check_stat(name, x, b, s, h, device):
    if x.device != device or x.dtype != torch.float32 \
            or tuple(x.shape) != (b, s, h) or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 {(b, s, h)} "
                         f"tensor on {device}")


def _dims(q, k, v, o, do, q_offset):
    """The C entry points' ``dims``: B, Sq, Sk, H, D, q_offset, then the
    (b, s, h) element strides of q, k, v, o and do (0 where absent). The
    caller keeps the array alive across the call that reads it."""
    b, sq, h, d = q.shape
    strides = []
    for x in (q, k, v, o, do):
        strides += list(x.stride()[:3]) if x is not None else [0, 0, 0]
    return (ctypes.c_longlong * 21)(b, sq, k.shape[1], h, d, q_offset,
                                    *strides)


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run a head dim ``d`` at: ``d`` itself, or
    the next of ``KERNEL_HEAD_DIMS`` with q, k, v and dO zero-padded."""
    for kd in KERNEL_HEAD_DIMS:
        if d <= kd:
            return kd
    raise NotImplementedError(
        f"head dim {d}: the CUDA flash kernels take D <= "
        f"{KERNEL_HEAD_DIMS[-1]} (zero-padded up to one of "
        f"{KERNEL_HEAD_DIMS}); a D=256 instantiation needs its own register "
        f"plan — ROADMAP Queue 2, 'head dims above 128'"
    )


def _pad_head(x, kd):
    return x if x.shape[-1] == kd else torch.nn.functional.pad(
        x, (0, kd - x.shape[-1]))


def _geometry(q, k, q_offset, tiled):
    """(B, Sq, Sk, H, D, the kernel head dim) of a launch whose grid
    tiles ``tiled`` ("q" for K1 and K2, "k" for K3); raises where the
    kernels cannot run it."""
    if not q.is_cuda:
        raise ValueError(
            f"the CUDA flash kernels need CUDA tensors, got {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, D), got shape {tuple(q.shape)}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    kd = kernel_head_dim(d)
    if sq < 1 or sk < 1 or b * h < 1 or q_offset < 0:
        raise ValueError(f"unsupported geometry B={b} Sq={sq} Sk={sk} H={h} "
                         f"q_offset={q_offset}")
    if b * h > _GRID_X_MAX:
        raise ValueError(f"B·H = {b * h} passes the launch grid's x limit "
                         f"{_GRID_X_MAX}")
    s = sq if tiled == "q" else sk
    tiles = -(-s // _TILE_ROWS)
    if tiles > _GRID_Y_MAX:
        raise ValueError(
            f"S{tiled} = {s} is {tiles} tiles of {_TILE_ROWS} rows, past the "
            f"launch grid's y limit {_GRID_Y_MAX}")
    return b, sq, sk, h, d, kd


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _flash_fwd_cuda(q, k, v, q_offset):
    """K1: launches ``flash_fwd_kernel`` (bf16) or ``flash_fwd_f32_kernel``
    (f32); returns (O, lse)."""
    from rayfed_tpu_torch.ops import _native

    b, sq, sk, h, d, kd = _geometry(q, k, q_offset, "q")
    padded = kd != d
    for name, x, s in (("q", q, sq), ("k", k, sk), ("v", v, sk)):
        _check_qkv(name, x, b, s, h, d, q.device, q.dtype, padded)
    q, k, v = (_pad_head(x, kd) for x in (q, k, v))
    kind = "flash_fwd" + _KERNEL_DTYPES[q.dtype]
    o = torch.empty((b, sq, h, kd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    dims = _dims(q, k, v, None, None, q_offset)
    entry = getattr(_native.lib(), "rf_" + kind)
    with torch.cuda.device(q.device):
        code = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), ctypes.addressof(dims), d**-0.5,
            _stream(q.device),
        )
    _native.check(code, kind + "_kernel")
    LAUNCHES[kind] += 1
    return o[..., :d], lse


def _flash_bwd_dq_cuda(q, k, v, o, lse, do, q_offset):
    """K2: launches ``flash_bwd_dq_kernel`` (bf16) or
    ``flash_bwd_dq_f32_kernel`` (f32); returns (dq, delta)."""
    from rayfed_tpu_torch.ops import _native

    b, sq, sk, h, d, kd = _geometry(q, k, q_offset, "q")
    padded = kd != d
    for name, x, s in (("q", q, sq), ("k", k, sk), ("v", v, sk),
                       ("o", o, sq), ("do", do, sq)):
        _check_qkv(name, x, b, s, h, d, q.device, q.dtype, padded)
    _check_stat("lse", lse, b, sq, h, q.device)
    q, k, v, o, do = (_pad_head(x, kd) for x in (q, k, v, o, do))
    kind = "flash_bwd_dq" + _KERNEL_DTYPES[q.dtype]
    dq = torch.empty((b, sq, h, kd), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    dims = _dims(q, k, v, o, do, q_offset)
    entry = getattr(_native.lib(), "rf_" + kind)
    with torch.cuda.device(q.device):
        code = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
            ctypes.addressof(dims), d**-0.5, _stream(q.device),
        )
    _native.check(code, kind + "_kernel")
    LAUNCHES[kind] += 1
    return dq[..., :d], delta


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, q_offset):
    """K3: launches ``flash_bwd_dkv_kernel`` (bf16) or
    ``flash_bwd_dkv_f32_kernel`` (f32); returns (dk, dv)."""
    from rayfed_tpu_torch.ops import _native

    b, sq, sk, h, d, kd = _geometry(q, k, q_offset, "k")
    padded = kd != d
    for name, x, s in (("q", q, sq), ("k", k, sk), ("v", v, sk),
                       ("do", do, sq)):
        _check_qkv(name, x, b, s, h, d, q.device, q.dtype, padded)
    _check_stat("lse", lse, b, sq, h, q.device)
    _check_stat("delta", delta, b, sq, h, q.device)
    q, k, v, do = (_pad_head(x, kd) for x in (q, k, v, do))
    kind = "flash_bwd_dkv" + _KERNEL_DTYPES[q.dtype]
    dk = torch.empty((b, sk, h, kd), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, h, kd), dtype=v.dtype, device=q.device)
    dims = _dims(q, k, v, None, do, q_offset)
    entry = getattr(_native.lib(), "rf_" + kind)
    with torch.cuda.device(q.device):
        code = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            ctypes.addressof(dims), d**-0.5, _stream(q.device),
        )
    _native.check(code, kind + "_kernel")
    LAUNCHES[kind] += 1
    return dk[..., :d], dv[..., :d]


# ---------------------------------------------------------------------------
# Dispatch by device, autograd, public API
# ---------------------------------------------------------------------------


def _on_cpu(*xs) -> bool:
    """True for CPU tensors (plain path), False for CUDA ones (kernels);
    anything else, or a mix, is an error."""
    types = {x.device.type for x in xs}
    if types == {"cpu"}:
        return True
    if types == {"cuda"}:
        return False
    raise ValueError(f"flash attention needs all-CPU or all-CUDA tensors, "
                     f"got {sorted(types)}")


def _flash_fwd_raw(q, k, v, block_q, block_k, interpret=None, q_offset=0):
    """(O, lse) of causal attention; lse is (B, Sq, H) f32, the key the
    backward and the ring merge consume. ``interpret`` is the reference's
    Pallas flag, accepted at its position and ignored."""
    if _on_cpu(q, k, v):
        return _flash_fwd_plain(q, k, v, block_q, block_k, q_offset)
    return _flash_fwd_cuda(q, k, v, q_offset)


def _flash_bwd_raw(q, k, v, o, lse, do, block_q, block_k, interpret=None,
                   q_offset=0):
    """(dq, dk, dv) via the two backward passes (the counterpart of
    ``_flash_bwd_pallas``, with its arguments; ``interpret`` is ignored)."""
    if _on_cpu(q, k, v, o, lse, do):
        dq, delta = _flash_bwd_dq_plain(q, k, v, o, lse, do, block_q,
                                        block_k, q_offset)
        dk, dv = _flash_bwd_dkv_plain(q, k, v, do, lse, delta, block_q,
                                      block_k, q_offset)
        return dq, dk, dv
    dq, delta = _flash_bwd_dq_cuda(q, k, v, o, lse, do, q_offset)
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, q_offset)
    return dq, dk, dv


@torch.library.custom_op("rayfed_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 block_q: int, block_k: int,
                 q_offset: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The differentiable forward, (O, lse): the ``custom_vjp`` of the
    reference, whose residuals are (q, k, v, O, lse) and whose backward
    runs the two blockwise passes. It is an operator of its own (not an
    ``autograd.Function``) so that a selective checkpoint can name it:
    ``remat="attn"`` keeps its outputs and never runs K1 again in the
    backward (``models/transformer.py``)."""
    return _flash_fwd_raw(q, k, v, block_q, block_k, q_offset=q_offset)


def _flash_fwd_setup(ctx, inputs, output):
    q, k, v, block_q, block_k, q_offset = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.blocks = (block_q, block_k, q_offset)
    ctx.mark_non_differentiable(lse)


def _flash_fwd_backward(ctx, do, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    block_q, block_k, q_offset = ctx.blocks
    dq, dk, dv = _flash_bwd_raw(q, k, v, out, lse, do.contiguous(),
                                block_q, block_k, q_offset=q_offset)
    return dq, dk, dv, None, None, None


flash_fwd_op.register_autograd(_flash_fwd_backward,
                               setup_context=_flash_fwd_setup)


def flash_attention(q, k, v, block_q: int = 512, block_k: int = 512,
                    interpret: Optional[bool] = None, q_offset: int = 0):
    """Causal flash attention on (B, S, H, D) tensors; differentiable.

    ``q_offset`` shifts query positions (sequence-parallel callers pass the
    shard's global offset). Block sizes shrink to the largest power-of-two
    divisor of the sequence length, so they always tile it. ``interpret``
    stands where the reference has it and is ignored: CPU tensors take the
    plain versions, CUDA tensors the kernels.
    """
    block_q = min(block_q, _pow2_block(q.shape[1], cap=block_q))
    block_k = min(block_k, _pow2_block(k.shape[1], cap=block_k))
    return flash_fwd_op(q, k, v, block_q, block_k, int(q_offset))[0]


def _pow2_block(s: int, cap: int = 128) -> int:
    """Largest power-of-two divisor of ``s``, capped."""
    blk = 1
    while blk < cap and s % (blk * 2) == 0:
        blk *= 2
    return blk


def make_flash_attn_fn(block_q: int = 512, block_k: int = 512,
                       min_block: int = 16):
    """An ``attn_fn`` for ``models.transformer.forward``: (B, S, H, D)
    q/k/v -> (B, S, H, D), causal. Falls back to the dense attention when
    the sequence doesn't tile into blocks of at least ``min_block`` (the
    reference's rule, kept so both packages take the same path)."""
    from rayfed_tpu_torch.models.transformer import causal_attention

    def attn(q, k, v):
        bq = min(block_q, _pow2_block(q.shape[1], cap=block_q))
        bk = min(block_k, _pow2_block(k.shape[1], cap=block_k))
        if bq < min_block or bk < min_block:
            return causal_attention(q, k, v)
        return flash_attention(q, k, v, block_q=bq, block_k=bk)

    return attn


__all__ = [
    "flash_attention", "flash_fwd_op", "make_flash_attn_fn", "LAUNCHES",
    "reset_launch_counts", "KERNEL_HEAD_DIMS", "kernel_head_dim",
]
