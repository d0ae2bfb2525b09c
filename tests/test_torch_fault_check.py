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

"""``chip_fault_check.py``'s planted faults still land in the committed
kernel source: every anchor is found its stated number of times, so a
rewrite of a kernel cannot silently disarm the check. CPU only (the
patching is text; the card run reads the faulted kernels)."""

import os

import pytest

import chip_fault_check as fc

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "rayfed_tpu_torch", "csrc", "flash_attention.cu")


def _source():
    with open(SOURCE) as f:
        return f.read()


@pytest.mark.parametrize("i", range(len(fc.FAULTS)))
def test_fault_anchor_found_its_stated_number_of_times(i):
    anchor, _, count = fc.FAULTS[i]
    assert count >= 1
    assert _source().count(anchor) == count


def test_planted_source_inserts_every_fault_after_its_anchor():
    text = _source()
    planted = fc.planted_source(text)
    for anchor, line, count in fc.FAULTS:
        assert planted.count(anchor + line) == count
    assert len(planted) == len(text) + sum(
        len(line) * count for _, line, count in fc.FAULTS)
    # The faults name the tiles the module documents.
    joined = "".join(line for _, line, _ in fc.FAULTS)
    assert f"kt == {fc.SKIP_KT}" in joined
    assert f"/ 64 == {fc.SKIP_QT}" in joined


def test_planted_source_refuses_a_source_without_an_anchor():
    anchor = fc.FAULTS[0][0]
    with pytest.raises(ValueError, match="fault anchor found 0 times"):
        fc.planted_source(_source().replace(anchor, ""))
