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

"""Input pipeline: tokenized LM data for the port.

A copy of ``rayfed_tpu/data.py``'s :class:`TokenDataset` and
:func:`synthetic_lm_dataset`, so both packages cut the same
(seq+1)-token windows from the same seed, and its prefetching iterator
:func:`make_batch_iterator` on one device instead of a mesh. Each party
builds its own dataset over its own shard of the corpus; data never
crosses the perimeter.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from rayfed_tpu_torch.utils import DeviceLike, resolve_device


class TokenDataset:
    """Deterministically-shuffled (seq+1)-token windows over a flat corpus.

    ``tokens`` may be any 1-D integer array-like, including ``np.memmap``
    (corpora larger than RAM stream from disk page-by-page).
    """

    def __init__(self, tokens, seq_len: int, seed: int = 0) -> None:
        self._tokens = np.asarray(tokens)  # no-copy for ndarray/memmap
        assert self._tokens.ndim == 1, "tokens must be a flat 1-D array"
        self._window = seq_len + 1  # inputs + shifted targets
        self._n_windows = len(self._tokens) // self._window
        assert self._n_windows > 0, (
            f"corpus of {len(self._tokens)} tokens is shorter than one "
            f"window ({self._window})"
        )
        self._seed = seed
        self.seq_len = seq_len

    def __len__(self) -> int:
        return self._n_windows

    def epoch(self, epoch: int) -> Iterator[np.ndarray]:
        """Windows of one epoch in a deterministic per-epoch order."""
        order = np.random.RandomState(
            (self._seed * 1_000_003 + epoch) % (2**31)
        ).permutation(self._n_windows)
        for w in order:
            start = int(w) * self._window
            yield np.asarray(self._tokens[start: start + self._window])

    def batches(self, batch: int, epoch: int = 0,
                drop_remainder: bool = True) -> Iterator[np.ndarray]:
        """(batch, seq+1) int32 blocks from one epoch."""
        buf = []
        for window in self.epoch(epoch):
            buf.append(window)
            if len(buf) == batch:
                yield np.stack(buf).astype(np.int32, copy=False)
                buf = []
        if buf and not drop_remainder:
            yield np.stack(buf).astype(np.int32, copy=False)


def make_batch_iterator(
    dataset: TokenDataset,
    batch: int,
    device: DeviceLike = None,
    *,
    epochs: Optional[int] = None,
    start_epoch: int = 0,
    prefetch: int = 1,
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Device-resident int32 ``(inputs, targets)`` pairs, prefetched.

    A loader thread stages the next ``prefetch`` batches while the current
    step computes: on a card it pins each block and copies it with
    ``non_blocking=True`` on its own stream, and the consumer's stream
    waits on the copy's event before the pair is handed out, so the
    transfer hides behind the step. ``device`` is CUDA unless it says
    otherwise. ``epochs=None`` iterates forever; the epoch schedule is
    deterministic, so a restarted job can resume at ``start_epoch``.
    """
    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()
    _END = object()          # clean end-of-stream

    class _LoaderError:
        # Errors cross the thread boundary explicitly: a dead loader must
        # surface its exception at the training loop, not masquerade as a
        # clean end of data.
        def __init__(self, exc: BaseException) -> None:
            self.exc = exc

    def stage(block: np.ndarray):
        host = (torch.from_numpy(np.ascontiguousarray(block[:, :-1])),
                torch.from_numpy(np.ascontiguousarray(block[:, 1:])))
        if not on_cuda:
            return host + (None,)
        with torch.cuda.stream(copy_stream):
            pair = tuple(t.pin_memory().to(dev, non_blocking=True)
                         for t in host)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return pair + (done,)

    def loader() -> None:
        epoch = start_epoch
        try:
            while not stop.is_set() and (
                epochs is None or epoch < start_epoch + epochs
            ):
                for block in dataset.batches(batch, epoch=epoch):
                    if stop.is_set():
                        return
                    q.put(stage(block))
                epoch += 1
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 - re-raised in consumer
            if not stop.is_set():
                q.put(_LoaderError(e))

    copy_stream = torch.cuda.Stream(dev) if on_cuda else None
    thread = threading.Thread(
        target=loader, name="fedtpu-data-loader", daemon=True
    )
    thread.start()

    class _Iter:
        def __init__(self):
            self._done = False

        def __iter__(self):
            return self

        def __next__(self):
            # A finished stream stays finished: q.get() with no live
            # producer would block forever, so exhaustion/close/error all
            # latch _done and keep raising StopIteration.
            if self._done:
                raise StopIteration
            while True:
                # Re-check _done between bounded gets: a concurrent
                # close() from another thread drains the queue (possibly
                # eating _END), and a get() with no deadline would then
                # block this consumer forever.
                try:
                    item = q.get(timeout=0.1)
                    break
                except queue.Empty:
                    if self._done:
                        raise StopIteration from None
            if item is _END:
                self._done = True
                raise StopIteration
            if isinstance(item, _LoaderError):
                self._done = True
                raise RuntimeError("data loader failed") from item.exc
            inputs, targets, done = item
            if done is not None:
                # The consumer's stream reads the pair only after its copy
                # landed, and the allocator keeps the pair's memory until
                # that stream's work on it is done.
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(done)
                inputs.record_stream(consumer)
                targets.record_stream(consumer)
            return inputs, targets

        def close(self) -> None:
            self._done = True
            stop.set()
            # Keep draining until the loader exits: a put-blocked loader
            # needs our get to wake up and observe the stop flag.
            while thread.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

        # Dropping the iterator without close() (break out of a `for`
        # over the infinite epochs=None stream) must not leak the loader
        # thread or the prefetched device batches it holds.
        def __del__(self):
            try:
                self.close()
            except BaseException:  # noqa: BLE001 - interpreter teardown
                pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.close()
            return False

    return _Iter()


def synthetic_lm_dataset(vocab: int, n_tokens: int, seq_len: int,
                         seed: int = 0) -> TokenDataset:
    """Random-token corpus for benchmarks and tests."""
    rng = np.random.RandomState(seed)
    return TokenDataset(
        rng.randint(0, vocab, size=n_tokens).astype(np.int32),
        seq_len, seed=seed,
    )
