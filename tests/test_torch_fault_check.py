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

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "rayfed_tpu_torch", "csrc")
FAULTS = [(name, i) for name, faults in sorted(fc.FAULTS.items())
          for i in range(len(faults))]


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _kinds(name):
    return [f[3] for f in fc.FAULTS[name]]


def test_every_kernel_source_has_its_faults():
    # One skipped tile per kernel: K1-K3 in bf16 and in f32, the bf16 K1
    # and K3 and the f32 K2 and K3 at D = 256 in their own sources; one
    # split fault, in the f32 kernels' shared split (tf32.cuh), with which
    # all of their products are split.
    assert sorted(fc.FAULTS) == ["flash_attention.cu",
                                 "flash_attention_d256.cu",
                                 "flash_attention_f32.cu",
                                 "flash_attention_f32_d256.cu", "tf32.cuh"]
    assert _kinds("flash_attention.cu") == ["skip"] * 3
    assert _kinds("flash_attention_d256.cu") == ["skip"] * 2
    assert _kinds("flash_attention_f32.cu") == ["skip"] * 3
    assert _kinds("flash_attention_f32_d256.cu") == ["skip"] * 2
    assert _kinds("tf32.cuh") == ["split"] * 2
    # Both f32 kernel sources take the split from that header.
    for name in ("flash_attention_f32.cu", "flash_attention_f32_d256.cu"):
        assert '#include "tf32.cuh"' in _source(name)
        assert "lo = __float_as_uint" not in _source(name)
    assert all(f[3] in fc.FAULT_KINDS
               for faults in fc.FAULTS.values() for f in faults)


@pytest.mark.parametrize("name,i", FAULTS)
def test_fault_anchor_found_its_stated_number_of_times(name, i):
    anchor, _, count, _ = fc.FAULTS[name][i]
    assert count >= 1
    assert _source(name).count(anchor) == count


@pytest.mark.parametrize("name", sorted(fc.FAULTS))
def test_planted_source_inserts_every_fault_after_its_anchor(name):
    text = _source(name)
    planted = fc.planted_source(name, text)
    skips = [f for f in fc.FAULTS[name] if f[3] == "skip"]
    for anchor, line, count, _ in skips:
        assert planted.count(anchor + line) == count
    assert len(planted) == len(text) + sum(
        len(line) * count for _, line, count, _ in skips)
    # The faults name the tiles the module documents: K1 and K2 a key
    # tile (by step index or first key), K3 a query tile.
    lines = [line for _, line, _, _ in skips]
    if not lines:
        # tf32.cuh: only the split fault, planted on request.
        assert planted == text
        return
    if name == "flash_attention_f32_d256.cu":
        # K2 and K3 f32 at D = 256, warp-specialised: the skipped tile's P
        # (K2) or P^T (K3) is zeroed, and dS with it.
        k2, k3 = lines
        assert f"k0 / 64 == {fc.SKIP_KT}) pr = 0.f;" in k2
        assert f"q0 / 64 == {fc.SKIP_QT}) pr = 0.f;" in k3
        return
    if name == "flash_attention_d256.cu":
        # K1 and K3 at D = 256, warp-specialised: no block-wide barrier to
        # keep; the skipped tile's scores are masked, its P^T zeroed.
        k1, k3 = lines
        assert f"k0 / 64 == {fc.SKIP_KT}) x = kNegBig;" in k1
        assert f"q0 / 64 == {fc.SKIP_QT}) x[4 * j + e] = 0.0f;" in k3
        return
    k1, k2, k3 = lines
    for line in (k1, k2):
        assert (f"kt == {fc.SKIP_KT} " in line
                or f"k0 / 64 == {fc.SKIP_KT})" in line)
    assert f"q0 / 64 == {fc.SKIP_QT})" in k3
    # Each keeps the barrier that frees its ring stage.
    assert all("__syncthreads(); continue;" in line for line in (k1, k2, k3))
    # A source without faults of its own passes through unchanged.
    assert fc.planted_source("other.cu", text) == text


def test_split_fault_makes_one_tf32_product_of_each_f32_product():
    name = "tf32.cuh"
    text = _source(name)
    planted = fc.planted_source(name, text, "split")
    splits = [f for f in fc.FAULTS[name] if f[3] == "split"]
    assert len(splits) == 2  # the nearest split, and hi = x with tf32_lo
    # lo is zeroed right after each split computes it, and nothing else
    # changes: no tile is skipped.
    want = text
    for anchor, line, count, _ in splits:
        assert count == 1 and "lo = 0u;" in line
        want = want.replace(anchor, anchor + line)
    assert planted == want
    assert "hi =" in text.split(splits[0][0])[0][-200:]
    assert fc.planted_source("flash_attention.cu",
                             _source("flash_attention.cu"), "split") \
        == _source("flash_attention.cu")
    # Its readings are the exact-f32 ones of the kernels that split, in
    # both of their tile plans.
    assert fc.SPLIT_CAUGHT_BY == (
        "K1 f32 O exact", "K1 f32 lse exact", "K2 f32 dq exact",
        "K3 f32 dk exact", "K3 f32 dv exact", "K1 f32 d256 O exact",
        "K1 f32 d256 lse exact", "K2 f32 d256 dq exact",
        "K3 f32 d256 dk exact", "K3 f32 d256 dv exact")
    with pytest.raises(ValueError, match="no fault kind"):
        fc.planted_source(name, text, "drop")


@pytest.mark.parametrize("name", sorted(fc.FAULTS))
def test_planted_source_refuses_a_source_without_an_anchor(name):
    anchor = fc.FAULTS[name][0][0]
    with pytest.raises(ValueError, match="fault anchor found 0 times"):
        fc.planted_source(name, _source(name).replace(anchor, ""))


def test_copy_port_passes_sources_and_headers_through_the_edit(tmp_path):
    # The split fault lives in a header (tf32.cuh): copy_port must hand
    # headers to the edit as well as sources.
    seen = []

    def edit(name, text):
        seen.append(name)
        return text

    fc.copy_port(str(tmp_path / "copy"), edit)
    assert "tf32.cuh" in seen and "flash_attention_f32_d256.cu" in seen
    assert sorted(seen) == sorted(n for n in os.listdir(CSRC)
                                  if n.endswith((".cu", ".cuh")))
