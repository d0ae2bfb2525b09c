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

"""The port's input pipeline on ``device="cpu"`` (mirrors
``tests/test_data.py``): the same windows and blocks as the JAX package's
dataset and iterator, the iterator's end, close, latch and error
semantics, and a train step fed by it."""

import gc
import threading
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from rayfed_tpu import data as jdata
from rayfed_tpu_torch.data import (
    TokenDataset,
    make_batch_iterator,
    synthetic_lm_dataset,
)

torch.set_num_threads(2)


def _loader_alive():
    return any(t.name == "fedtpu-data-loader" and t.is_alive()
               for t in threading.enumerate())


def test_windows_cover_corpus_deterministically():
    ds = TokenDataset(np.arange(100, dtype=np.int32), seq_len=9, seed=7)
    assert len(ds) == 10
    e0 = [w.tolist() for w in ds.epoch(0)]
    assert e0 == [w.tolist() for w in ds.epoch(0)]
    assert e0 != [w.tolist() for w in ds.epoch(1)]
    assert sorted(w[0] for w in e0) == [i * 10 for i in range(10)]
    blocks = list(ds.batches(4, epoch=0, drop_remainder=False))
    assert [b.shape for b in blocks] == [(4, 10), (4, 10), (2, 10)]


@pytest.mark.parametrize("start_epoch", [0, 3])
def test_iterator_yields_the_jax_package_blocks(start_epoch):
    ours = synthetic_lm_dataset(vocab=64, n_tokens=16 * 17, seq_len=16, seed=5)
    theirs = jdata.synthetic_lm_dataset(64, 16 * 17, 16, seed=5)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    want = list(jdata.make_batch_iterator(theirs, 8, mesh, epochs=2,
                                          start_epoch=start_epoch))
    with make_batch_iterator(ours, 8, "cpu", epochs=2,
                             start_epoch=start_epoch, prefetch=2) as it:
        got = list(it)
    assert len(got) == len(want) == 4  # 16 windows / batch 8, two epochs
    for (x, y), (jx, jy) in zip(got, want):
        assert x.device.type == "cpu" and x.dtype == torch.int32
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        assert torch.equal(x[:, 1:], y[:, :-1])


def test_pipeline_feeds_train_step():
    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.parallel.train import make_fed_train_step

    cfg = tfm.tiny_config(compute_dtype=torch.float32)
    init_fn, step_fn = make_fed_train_step(cfg, "cpu", lr=1e-2)
    ds = synthetic_lm_dataset(cfg.vocab, n_tokens=8 * 17 * 3, seq_len=16)
    params, opt = init_fn(0)
    losses = []
    with make_batch_iterator(ds, 8, "cpu", epochs=1) as it:
        for inputs, targets in it:
            params, opt, loss = step_fn(params, opt, inputs, targets)
            losses.append(float(loss))
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_exhausted_iterator_keeps_raising_stopiteration():
    ds = synthetic_lm_dataset(64, n_tokens=17 * 4, seq_len=16)
    it = make_batch_iterator(ds, 2, "cpu", epochs=1)
    assert len(list(it)) == 2
    assert list(it) == []
    with pytest.raises(StopIteration):
        next(it)
    it.close()


def test_close_is_idempotent_and_latches():
    ds = synthetic_lm_dataset(64, n_tokens=17 * 8, seq_len=16)
    it = make_batch_iterator(ds, 2, "cpu", epochs=None)
    next(it)
    it.close()
    it.close()
    with pytest.raises(StopIteration):
        next(it)


def test_context_manager_and_gc_stop_loader_thread():
    ds = synthetic_lm_dataset(64, n_tokens=17 * 8, seq_len=16)
    with make_batch_iterator(ds, 2, "cpu", epochs=None) as it:
        next(it)
    assert not _loader_alive()
    it2 = make_batch_iterator(ds, 2, "cpu", epochs=None)
    next(it2)
    del it2
    gc.collect()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and _loader_alive():
        time.sleep(0.05)
    assert not _loader_alive()


def test_cross_thread_close_unblocks_waiting_consumer():
    ds = synthetic_lm_dataset(64, n_tokens=17 * 4, seq_len=16)
    it = make_batch_iterator(ds, 2, "cpu", epochs=None)
    got = []

    def consume():
        try:
            while True:
                got.append(next(it))
        except StopIteration:
            got.append("stopped")

    t = threading.Thread(target=consume)
    t.start()
    time.sleep(0.3)
    it.close()
    t.join(timeout=10)
    assert not t.is_alive(), "consumer stuck in next() after cross-thread close"
    assert got[-1] == "stopped"


class _Broken(TokenDataset):
    def batches(self, batch, epoch=0, drop_remainder=True):
        yield from super().batches(batch, epoch, drop_remainder)
        raise OSError("disk went away")


def test_loader_error_crosses_to_the_consumer_and_latches():
    ds = _Broken(np.arange(17 * 4, dtype=np.int32), seq_len=16)
    it = make_batch_iterator(ds, 2, "cpu", epochs=None)
    assert len([next(it) for _ in range(2)]) == 2
    with pytest.raises(RuntimeError, match="data loader failed") as err:
        next(it)
    assert isinstance(err.value.__cause__, OSError)
    with pytest.raises(StopIteration):
        next(it)
    it.close()


def test_a_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot show")
    ds = synthetic_lm_dataset(64, n_tokens=17 * 4, seq_len=16)
    with pytest.raises(RuntimeError, match="none is available"):
        make_batch_iterator(ds, 2)
    assert not _loader_alive()
