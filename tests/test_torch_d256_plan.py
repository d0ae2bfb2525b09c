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

"""The warp-specialised bf16 K1 and K3 at D=256
(``rayfed_tpu_torch/csrc/flash_attention_d256.cu``), as far as the CPU can
hold them: their source's plan, the layouts the wrapper refuses before a
TMA tensor map sees them, and what ``chip_smoke.py`` reads of their build.
The kernels themselves run only on a card
(``tests/test_torch_cuda_kernels.py``)."""

import os
import re

import pytest
import torch

import chip_smoke
import chip_tile_sweep as sweep
from rayfed_tpu_torch.ops import _native
from rayfed_tpu_torch.ops import flash_attention as fa

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "rayfed_tpu_torch", "csrc")


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _constant(text, name):
    (value,) = re.findall(rf"constexpr int {name} = (\d+);", text)
    return int(value)


@pytest.mark.parametrize("producer,consumer", [
    ("kFwdProducerRegs", "kFwdConsumerRegs"),
    ("kDkvProducerRegs", "kDkvConsumerRegs"),
])
def test_register_hand_over_fits_the_launch(producer, consumer):
    # 384 threads a block: the launch holds 168 registers a thread (65536
    # / 384, rounded down to 8). setmaxnreg takes multiples of 8 in [24,
    # 256]; the producer warpgroup gives up what the two consumers take,
    # or their setmaxnreg.inc would wait forever.
    text = _source("flash_attention_d256.cu")
    prod, cons = _constant(text, producer), _constant(text, consumer)
    launch = 65536 // 384 // 8 * 8
    assert launch == 168
    for regs in (prod, cons):
        assert regs % 8 == 0 and 24 <= regs <= 256
    assert 128 * prod + 256 * cons <= 384 * launch
    assert cons > launch > prod


@pytest.mark.parametrize("name", sweep.D256_TILE_CONSTANTS)
def test_d256_tile_constants_live_in_their_own_source(name):
    assert sweep.source_of(name) == "flash_attention_d256.cu"
    assert _source("flash_attention_d256.cu").count(
        f"constexpr int {name} = ") == 1
    assert f"constexpr int {name} = " not in _source("flash_attention.cu")


@pytest.mark.parametrize("name", ["kFwdWG256", "kFwdN256", "kDkvWG256",
                                  "kDkvM256"])
def test_the_old_d256_plan_is_gone(name):
    # The cp.async plan of K1 and K3 at D=256 went with its constants; K2
    # keeps its plan in flash_attention.cu, and the C entry points hand K1
    # and K3 at D=256 to the warp-specialised source.
    text = _source("flash_attention.cu")
    assert name not in text
    assert name not in sweep.TILE_CONSTANTS
    assert "constexpr int kDqN256 = " in text
    assert "rf_d256::fwd(" in text and "rf_d256::dkv(" in text


@pytest.mark.parametrize("shape,sliced,match", [
    ((1, 64, 2, 260), (slice(None),) * 3 + (slice(0, 256),),
     "stride 260 of dim 2"),
    ((1, 64, 3, 2, 256), (slice(None), slice(None), 0),
     None),  # a strided view of a fused (B, S, 3, H, D) tensor is taken
    ((1, 64, 2, 264), (slice(None),) * 3 + (slice(1, 257),),
     "start 2 bytes past 16-byte alignment"),
    ((1, 64, 2, 512), (slice(None),) * 3 + (slice(0, 512, 2),),
     "head-dim stride 2"),
])
def test_layouts_the_tensor_maps_cannot_take_raise_naming_them(shape, sliced,
                                                               match):
    x = torch.zeros(shape, dtype=torch.bfloat16)[sliced]
    b, s, h, d = x.shape
    if match is None:
        fa._check_qkv("q", x, b, s, h, d, x.device, x.dtype)
        return
    with pytest.raises(ValueError, match=match):
        fa._check_qkv("q", x, b, s, h, d, x.device, x.dtype)
    # A head dim the wrapper zero-pads is copied, so any layout does.
    fa._check_qkv("q", x, b, s, h, d, x.device, x.dtype, padded=True)


def test_sass_counts_read_tma_and_mbarrier_instructions():
    sass = "\n".join([
        "\t\tFunction : _ZN12_GLOBAL__N_116flash_fwd_kernelILi256ELi80ELi2E"
        "Lb1ELb1EEEvNS_6Tma256ENS_6ParamsE",
        "        /*0100*/  SYNCS.EXCH.64 URZ, [UR4], UR6 ;",
        "        /*0110*/  UTMALDG.4D [UR8], [UR10] ;",
        "        /*0120*/  SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R3+URZ], R4 ;",
        "        /*0130*/  HGMMA.64x80x16.F32.BF16 R24, gdesc[UR4], R24 ;",
        "\t\tFunction : _ZN12_GLOBAL__N_121tma_tile_check_kernelILi64EEEv",
        "        /*0200*/  UTMALDG.4D [UR8], [UR10] ;",
    ])
    ops = chip_smoke.SASS_OPS + chip_smoke.TMA_SASS_OPS
    assert chip_smoke.parse_sass_counts(sass, ops) == {
        "flash_fwd_kernel<256>": {"HMMA": 0, "HGMMA": 1, "FFMA": 0,
                                  "UTMALDG": 1, "SYNCS": 2}}
    # The default counts stay the tensor-core and FFMA ones.
    assert chip_smoke.parse_sass_counts(sass) == {
        "flash_fwd_kernel<256>": {"HMMA": 0, "HGMMA": 1, "FFMA": 0}}


def test_kernel_line_and_fault_check_name_the_new_source():
    import chip_fault_check as fc

    src = {k["name"]: k["source"] for k in chip_smoke.KERNELS}
    for name in chip_smoke.D256_SOURCE_KERNELS:
        assert src[name] == "rayfed_tpu_torch/csrc/flash_attention_d256.cu"
    assert src["flash_bwd_dq_d256"].endswith("/flash_attention.cu")
    # Both new kernels carry a planted fault for chip_fault_check.py.
    assert len(fc.FAULTS["flash_attention_d256.cu"]) == 2
    # The tile check entry is bound with its nine arguments.
    assert len(_native._SIGNATURES["rf_tma_tile_check"]) == 9


def test_ptxas_report_files_other_entry_functions_apart():
    # The tile check kernel (flash_attention_d256.cu) is no flash kernel:
    # its report lines go under "?", not under the flash kernel compiled
    # before it, whose spill count they would otherwise replace.
    log = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_"
        "fwd_kernelILi16ELi2ELi128EEEvNS_6ParamsE' for 'sm_90a'\n"
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 141 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121tma_"
        "tile_check_kernelILi64EEEv14CUtensorMap_st' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 42 registers, used 1 barriers\n"
    )
    assert chip_smoke.ptxas_report(log) == [
        "flash_fwd_kernel<16>: 0 bytes stack frame, 8 bytes spill stores, "
        "8 bytes spill loads",
        "flash_fwd_kernel<16>: Used 141 registers, used 1 barriers",
        "?: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "?: Used 42 registers, used 1 barriers",
    ]
    assert chip_smoke.ptxas_spills(log)["flash_fwd_kernel<16>"] == 16
