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
# the plain version's, as chip_smoke.py holds them. lse/delta are f32.


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,d,q_offset", [
    (2, 128, 128, 2, 16, 0),
    (1, 96, 160, 3, 32, 64),   # ragged tiles, Sq < Sk, q_offset
    (2, 256, 256, 2, 64, 0),
    (1, 512, 512, 4, 128, 0),
    # K1 tiles 128 queries x 128 keys, K2 128 queries x 64 keys, K3 128
    # keys x 64 queries:
    (2, 200, 200, 2, 128, 0),      # S not a multiple of 128 (nor of 64)
    (1, 136, 328, 3, 128, 192),    # Sq < Sk, q_offset on a tile boundary
    (1, 136, 328, 3, 128, 150),    # Sq < Sk, q_offset off it
    (4, 1024, 1024, 16, 128, 0),   # B*H = 64: blocks run in several waves
    (2, 1024, 1024, 4, 64, 0),     # D = 64 at S = 1024
    (2, 64, 64, 2, 128, 0),        # a 128-row block's second warpgroup
                                   # holds no valid row
    (1, 72, 200, 3, 128, 128),     # Sq = 72 < Sk, q_offset 128
])
def test_kernels_match_plain_on_card(cuda_device, b, sq, sk, h, d, q_offset):
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(s):
        return torch.randn((b, s, h, d), generator=g, device=cuda_device,
                           dtype=torch.float32).to(torch.bfloat16)

    q, k, v, do = rnd(sq), rnd(sk), rnd(sk), rnd(sq)
    bq, bk = fa._pow2_block(sq, 512), fa._pow2_block(sk, 512)
    o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, bq, bk, q_offset)
    o, lse = fa._flash_fwd_cuda(q, k, v, q_offset)
    assert tile_rel_err(o, o_ref) <= BF16_TILE_REL_TOL
    assert float((lse - lse_ref).abs().max()) < 1e-3
    dq_ref, delta_ref = fa._flash_bwd_dq_plain(q, k, v, o_ref, lse_ref, do,
                                               bq, bk, q_offset)
    dq, delta = fa._flash_bwd_dq_cuda(q, k, v, o_ref, lse_ref, do, q_offset)
    assert tile_rel_err(dq, dq_ref) <= BF16_TILE_REL_TOL
    assert float((delta - delta_ref).abs().max()) < 1e-3
    dk_ref, dv_ref = fa._flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta_ref,
                                             bq, bk, q_offset)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse_ref, delta_ref, q_offset)
    torch.cuda.synchronize()
    assert tile_rel_err(dk, dk_ref) <= BF16_TILE_REL_TOL
    assert tile_rel_err(dv, dv_ref) <= BF16_TILE_REL_TOL


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_untaken_inputs(cuda_device):
    x = torch.zeros((1, 64, 2, 16), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        fa._flash_fwd_cuda(x.float(), x.float(), x.float(), 0)
    y = torch.zeros((1, 64, 2, 48), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa._flash_fwd_cuda(y, y, y, 0)
    z = torch.zeros((1, 64, 2, 32), device=cuda_device,
                    dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="layout"):
        fa._flash_fwd_cuda(z, z, z, 0)
