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

"""``chip_tile_sweep.py``'s settings reach the committed kernel source:
each tile constant is defined there once and is rewritten as asked. CPU
only (the card run builds and times the copies)."""

import os
import re

import pytest

import chip_tile_sweep as sweep

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "rayfed_tpu_torch", "csrc")


def _source(name="flash_attention.cu"):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


@pytest.mark.parametrize("name", sweep.TILE_CONSTANTS)
def test_tile_constant_is_rewritten_once(name):
    text = _source(sweep.source_of(name))
    out = sweep.tiled_source(text, {name: 4096})
    assert f"constexpr int {name} = 4096;" in out
    assert f"constexpr int {name} = 4096;" not in text
    assert len(out.splitlines()) == len(text.splitlines())


def test_parse_setting():
    assert sweep.parse_setting("base") == {}
    assert sweep.parse_setting("kFwdN=64,kDkvM=32") == {"kFwdN": 64,
                                                       "kDkvM": 32}
    with pytest.raises(ValueError, match="not a tile setting"):
        sweep.parse_setting("kTile=32")
    with pytest.raises(ValueError, match="not a tile setting"):
        sweep.parse_setting("kFwdN=big")


def test_f32_constants_live_in_the_f32_source_only():
    for name in sweep.F32_TILE_CONSTANTS:
        assert sweep.source_of(name) == "flash_attention_f32.cu"
        assert f"constexpr int {name} = " not in _source()
    assert sweep.parse_setting("kDqF32W=4,kDqF32N=64") == {"kDqF32W": 4,
                                                          "kDqF32N": 64}


def test_f32_forward_geometry_is_swept_in_the_f32_source():
    # K1 f32's warps a block and rows a ring stage: defined once, in the
    # f32 source, and set by a sweep argument.
    f32 = _source("flash_attention_f32.cu")
    for name in ("kFwdF32W", "kFwdF32N"):
        assert name in sweep.F32_TILE_CONSTANTS
        assert f32.count(f"constexpr int {name} = ") == 1
        assert f"constexpr int {name} = " not in _source()
    assert sweep.parse_setting("kFwdF32W=4,kFwdF32N=64") == {"kFwdF32W": 4,
                                                            "kFwdF32N": 64}
    out = sweep.tiled_source(f32, {"kFwdF32W": 4, "kFwdF32N": 64})
    assert "constexpr int kFwdF32W = 4;" in out
    assert "constexpr int kFwdF32N = 64;" in out
    assert "constexpr int kDqF32N = 32;" in out  # K2's stays


def test_tiled_source_refuses_a_constant_it_cannot_find():
    with pytest.raises(ValueError, match="defined 0 times"):
        sweep.tiled_source("int x;", {"kFwdN": 64})


def test_mma_rate_times_the_product_the_f32_kernels_issue():
    # The `mma` argument's kernel issues the very instruction of
    # tf32.cuh's mma_tf32, and its rate counts 2 x 16 x 8 x 8 operations
    # a product.
    (instr,) = re.findall(r'"(mma\.sync[^ ]*) "', _source("tf32.cuh"))
    assert f'"{instr} "' in sweep.MMA_SOURCE
    assert sweep.mma_tflops(1, 1, 1, 1, 2048e-12) == 1.0
    assert max(sweep.MMA_CHAINS) == 8  # the template's largest
    with pytest.raises(ValueError, match="not a tile setting"):
        sweep.parse_setting("mma")  # main takes it before parse_setting
