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

"""The port's ``tracing.enable`` takes the JAX package's keyword
(``jax_annotations``, ``rayfed_tpu/tracing.py``) as the name of its own
``profiler_annotations``: a call written for the JAX package records
spans here, wrapped in ``torch.profiler`` annotations when asked."""

import pytest
from torch.profiler import ProfilerActivity, profile

from rayfed_tpu_torch import tracing


@pytest.fixture(autouse=True)
def _restore_tracing():
    saved = (tracing._enabled, tracing._use_profiler_annotations)
    tracing.clear()
    yield
    tracing._enabled, tracing._use_profiler_annotations = saved
    tracing.clear()


def _one_span():
    with tracing.span("send", "bob", "7", "8", nbytes=3):
        pass
    return tracing.get_spans("send")


@pytest.mark.parametrize("kwargs", [
    {"jax_annotations": True},
    {"profiler_annotations": True},
    {"jax_annotations": False},
    {},
], ids=["jax_annotations", "profiler_annotations", "jax_off", "default"])
def test_enable_records_spans_under_either_name(kwargs):
    tracing.disable()
    assert _one_span() == []
    tracing.enable(**kwargs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans = _one_span()
    assert [(s.kind, s.peer, s.upstream_seq_id, s.downstream_seq_id,
             s.nbytes) for s in spans] == [("send", "bob", "7", "8", 3)]
    annotated = any(e.key == "fed:send:bob:7->8"
                    for e in prof.key_averages())
    assert annotated == any(kwargs.values())


def test_enable_takes_the_reference_call_positionally_too():
    # The JAX package's enable(True) is enable(jax_annotations=True).
    tracing.enable(True)
    assert tracing.is_enabled() and tracing._use_profiler_annotations


def test_enable_refuses_both_names():
    with pytest.raises(TypeError, match="not both"):
        tracing.enable(profiler_annotations=True, jax_annotations=True)
    with pytest.raises(TypeError, match="not both"):
        tracing.enable(False, jax_annotations=False)
