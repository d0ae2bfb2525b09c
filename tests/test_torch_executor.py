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

"""The port's party-local executor, mirroring ``test_executor.py`` with
the same assertions; the values that flow between tasks are torch
tensors and trees of them."""

import time

import pytest
import torch

from rayfed_tpu_torch._private.executor import LocalExecutor


@pytest.fixture()
def executor():
    ex = LocalExecutor(max_workers=4)
    yield ex
    ex.shutdown(wait=False)


def test_simple_submit(executor):
    fut = executor.submit(lambda a, b: a + b,
                          (torch.tensor(1.0), torch.tensor(2.0)))
    assert torch.equal(fut.result(timeout=5), torch.tensor(3.0))


def test_future_args_resolved(executor):
    a = executor.submit(lambda: torch.full((3,), 10.0))
    b = executor.submit(lambda x: x + 1, (a,))
    c = executor.submit(lambda t: t["v"] * 2, ({"v": b},))
    assert torch.equal(c.result(timeout=5), torch.full((3,), 22.0))


def test_chain_deeper_than_pool(executor):
    # 10 chained tasks through a 4-worker pool: FIFO + deps-before-consumers
    # must not deadlock.
    fut = executor.submit(lambda: torch.zeros(2))
    for _ in range(10):
        fut = executor.submit(lambda x: x + 1, (fut,))
    assert torch.equal(fut.result(timeout=10), torch.full((2,), 10.0))


def test_num_returns(executor):
    futs = executor.submit(lambda: (1, 2, 3), num_returns=3)
    assert [f.result(timeout=5) for f in futs] == [1, 2, 3]


def test_num_returns_mismatch(executor):
    futs = executor.submit(lambda: (1, 2), num_returns=3)
    with pytest.raises(ValueError):
        futs[0].result(timeout=5)


def test_exception_propagates(executor):
    def boom():
        raise ValueError("boom")

    fut = executor.submit(boom)
    with pytest.raises(ValueError, match="boom"):
        fut.result(timeout=5)
    # A consumer of a failed future fails with the same error.
    downstream = executor.submit(lambda x: x, (fut,))
    with pytest.raises(ValueError, match="boom"):
        downstream.result(timeout=5)


def test_serial_lane_ordering(executor):
    lane = executor.new_lane()
    log = []

    def slow():
        time.sleep(0.05)
        log.append("first")

    def fast():
        log.append("second")

    f1 = executor.submit(slow, lane=lane)
    f2 = executor.submit(fast, lane=lane)
    f1.result(timeout=5)
    f2.result(timeout=5)
    assert log == ["first", "second"]
