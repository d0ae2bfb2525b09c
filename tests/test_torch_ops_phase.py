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

"""``chip_smoke.py``'s phase 13 at tiny size on the CPU: the seeded chaos
FedAvg over TLS with telemetry on, every check of the phase, its first
job at one tree and its replay at another. That the two runs' fault
traces agree byte for byte across tree sizes is what lets the card run
replay its flagship tree's trace at a small tree. This module imports
no jax."""

import dataclasses

import torch

import chip_smoke
from rayfed_tpu_torch.models import transformer as tfm

torch.set_num_threads(2)


def test_ops_phase_runs_on_the_cpu_and_its_trace_ignores_the_tree_size():
    cfg = tfm.tiny_config()
    replay = dict(vocab=128, d_model=32, n_heads=2, n_layers=1, d_ff=96,
                  seq=8, batch=1)
    assert dataclasses.asdict(cfg)["d_model"] != replay["d_model"]
    full = chip_smoke.phase_ops("cpu", cfg, batch=2, seq=32, replay=replay,
                                get_timeout_s=3.0, replay_timeout_s=3.0,
                                timeout_s=240)
    root, other = (n for n, _ in chip_smoke.PARTIES)
    # The seed's draws: alice's first push delayed, her second corrupted,
    # her third dropped; its error envelope falls in the cut.
    assert [e["fault"] for e in full[root]["trace"]] == [
        "delay", "corrupt", "drop", "partition"]
    assert [e["fault"] for e in full[other]["trace"]] == ["corrupt"]
    assert full[root]["collector"]["seen"][other]["retransmits"] == 1
