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

"""int8 uniform quantization with error-feedback residuals (port of
``rayfed_tpu/privacy/quantize.py``).

Two consumers share the same per-leaf symmetric scheme
(``scale = max|x| / 127``, ``q = clip(round(x / scale), -127, 127)``):

- the WIRE tier: ``payload_wire_dtype="int8"`` extends the bf16/fp16
  lossy wire path in ``_private/serialization.py`` — stateless per
  frame, per-leaf scale rides the leaf descriptor (``"qs"``), 4x fewer
  bulk bytes than fp32;
- the DRIVER tier here: :class:`ErrorFeedbackQuantizer` keeps a
  per-party residual (EF-SGD, Karimireddy et al. 2019) so quantization
  error is carried into the next round's update instead of being lost.

Both run on the leaf's device and give the JAX package's bits: the scale
is ``amax / 127`` in f64, ``x / scale`` is an f64 division rounded half
to even, and the residuals are f64 tensors beside the leaves. Trees are
flattened in JAX's leaf order (sorted dict keys), so an envelope's
``scales`` and ``dtypes`` pair with its leaves in either package. A leaf
that is not a float16/32/64 tensor passes through unchanged: bfloat16
too, as in the JAX package, where numpy reads ml_dtypes' bfloat16 as
kind "V", not a float.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Tuple

import numpy as np
import torch

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.privacy.secagg import _cast, _leaves, dtype_name

INT8_LEVELS = 127.0


def _is_float(x: Any) -> bool:
    return (isinstance(x, torch.Tensor) and x.is_floating_point()
            and x.dtype != torch.bfloat16)


def quantize_leaf(arr: torch.Tensor) -> Tuple[torch.Tensor, float]:
    """Symmetric per-leaf int8 quantization on the leaf's device; returns
    ``(q, scale)``. An all-zero leaf keeps scale 1.0 so dequantization is
    well-defined."""
    amax = float(arr.detach().abs().max()) if arr.numel() else 0.0
    scale = amax / INT8_LEVELS if amax > 0.0 else 1.0
    q = torch.round(arr.detach().double() / scale)
    q = q.clamp_(-INT8_LEVELS, INT8_LEVELS)
    # numpy's cast writes 0 for a NaN (x86's conversion of NaN is
    # 0x80000000, whose low byte is 0); torch's is undefined.
    return q.nan_to_num_(nan=0.0).to(torch.int8), scale


def dequantize_leaf(q: torch.Tensor, scale: float, dtype) -> torch.Tensor:
    """``q * scale`` in f64, cast to ``dtype`` (a torch dtype or its
    numpy name) as numpy casts it."""
    name = dtype if isinstance(dtype, str) else dtype_name(dtype)
    return _cast(q.double() * float(scale), name)


def quantize_tree(tree: Any) -> Dict[str, Any]:
    """Quantize every float leaf; other leaves pass through. Returns a
    wire-clean envelope ``{"q", "scales", "dtypes"}`` whose ``q`` tree
    ships 1 byte per element; ``scales`` and ``dtypes`` follow JAX's
    leaf order, as does the ``q`` tree."""
    leaves, spec = _leaves(tree)
    q_leaves, scales, dtypes = [], [], []
    for leaf in leaves:
        if not _is_float(leaf):
            q_leaves.append(leaf)
            scales.append(None)
            dtypes.append(dtype_name(leaf.dtype)
                          if isinstance(leaf, torch.Tensor)
                          else np.asarray(leaf).dtype.name)
            continue
        q, scale = quantize_leaf(leaf)
        q_leaves.append(q)
        scales.append(float(scale))
        dtypes.append(dtype_name(leaf.dtype))
    return {
        "q": tree_util.tree_unflatten(q_leaves, spec),
        "scales": scales,
        "dtypes": dtypes,
    }


def dequantize_tree(envelope: Dict[str, Any]) -> Any:
    leaves, spec = _leaves(envelope["q"])
    out = []
    for leaf, scale, dt in zip(leaves, envelope["scales"],
                               envelope["dtypes"]):
        out.append(leaf if scale is None
                   else dequantize_leaf(torch.as_tensor(leaf), scale, dt))
    return tree_util.tree_unflatten(out, spec)


class ErrorFeedbackQuantizer:
    """Per-party error-feedback int8 quantization.

    ``quantize(party, tree)`` adds the party's carried residual to the
    tree, quantizes the corrected tree, and stores the new residual
    ``corrected - dequantized`` (f64, on the leaf's device) — so the
    error of round t is replayed into round t+1 rather than discarded.
    Residuals are keyed per party (one quantizer serves a whole driver)
    and per leaf position.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._residuals: Dict[str, Any] = {}

    def residual(self, party: str) -> Any:
        with self._lock:
            return self._residuals.get(party)

    def reset(self, party: str = None) -> None:
        with self._lock:
            if party is None:
                self._residuals.clear()
            else:
                self._residuals.pop(party, None)

    def quantize(self, party: str, tree: Any) -> Dict[str, Any]:
        with self._lock:
            residual = self._residuals.get(party)
        leaves, spec = _leaves(tree)
        if residual is not None:
            leaves = [
                _cast(x.double() + r, dtype_name(x.dtype)) if _is_float(x)
                else x
                for x, r in zip(leaves, _leaves(residual)[0])
            ]
            tree = tree_util.tree_unflatten(leaves, spec)
        envelope = quantize_tree(tree)
        restored = _leaves(dequantize_tree(envelope))[0]
        new_residual = [
            x.double() - y.double() if _is_float(x)
            else torch.zeros(tuple(np.shape(x)), dtype=torch.float64,
                             device=getattr(x, "device", None))
            for x, y in zip(leaves, restored)
        ]
        with self._lock:
            self._residuals[party] = tree_util.tree_unflatten(
                new_residual, spec)
        return envelope
