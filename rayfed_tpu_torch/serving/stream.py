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

"""Token streaming for the serving plane (``rayfed_tpu/serving/stream.py``
with its imports renamed).

Sinks and streams around one tiny frame protocol on the inline
lane: the engine emits each sampled token into a *sink*; a consumer
iterates a *stream*. Frames are msgpack-clean dicts

    ``{"o": <offset of first token>, "t": [tokens], "f": <final?>}``

parked in the receiver's rendezvous store under the string seq pair
``("srv:stream:<id>", "<frame #>")`` — ``srv:`` is not a control
namespace, so frames queue like ordinary data until the consumer's
:class:`TokenStream` recvs them in order. A frame whose ``"o"`` is
below the tokens already seen is a *restart* (the engine preempted the
request to break a block-pool deadlock and will re-run it): the client
truncates to ``o`` and continues, so a preemption is invisible beyond
latency. An ``{"e": <repr>}`` frame propagates an engine-side failure.

Backpressure contract: the engine NEVER blocks on a consumer. A sink's
``push`` is O(1) bookkeeping; the remote sink sends at most
``serving.stream_window`` un-acked frames and *coalesces* further
tokens into the next frame while the transport catches up, so a slow
consumer costs at most ``max_new_tokens`` buffered ints — KV blocks are
freed at request finish regardless of how far the reader has gotten.

Multi-controller contract: stream ids are allotted by a deterministic
per-handle counter, so every driver names the same stream; the frames
themselves flow only serving party -> ``stream_to`` party, and only the
``stream_to`` party's driver may iterate the stream.
"""

# fedlint: disable-file=seq-divergence
# Streaming is asymmetric by design: only the ``stream_to`` party's
# driver iterates a TokenStream, so recvs and the raise/return exits
# they gate are necessarily role-local. Frames ride reserved
# srv:stream: seq ids outside the data DAG; FED002's lockstep rule is
# for drivers replaying the shared DAG, not this consumer loop.

from __future__ import annotations

import threading
from typing import Any, Dict, Iterator, List, Optional

from rayfed_tpu_torch.tenancy.context import JobScoped

#: seq-id namespace for stream frames (rendezvous parks them as data).
STREAM_SEQ_PREFIX = "srv:stream:"


class LocalTokenStream:
    """In-process sink + iterator: the engine pushes, a local thread
    iterates. Used directly when the consumer lives on the serving party
    (bench, tests, ``stream_to == serving party``)."""

    def __init__(self, stream_id: str = "local"):
        self.stream_id = stream_id
        self._tokens: List[int] = []
        self._done = False
        self._exc: Optional[BaseException] = None
        self._cond = threading.Condition()
        self._first_token_s: Optional[float] = None

    # -- sink side (engine thread; never blocks) ----------------------

    def push(self, offset: int, toks: List[int], final: bool) -> None:
        import time

        with self._cond:
            if self._first_token_s is None and toks:
                self._first_token_s = time.perf_counter()
            del self._tokens[offset:]
            self._tokens.extend(int(t) for t in toks)
            if final:
                self._done = True
            self._cond.notify_all()

    def reset(self) -> None:
        """Preemption: the request restarts from scratch."""
        self.push(0, [], False)

    def fail(self, exc: BaseException) -> None:
        with self._cond:
            self._exc = exc
            self._done = True
            self._cond.notify_all()

    # -- consumer side ------------------------------------------------

    @property
    def first_token_s(self) -> Optional[float]:
        with self._cond:
            return self._first_token_s

    def __iter__(self) -> Iterator[int]:
        seen = 0
        while True:
            with self._cond:
                while len(self._tokens) <= seen and not self._done:
                    self._cond.wait(0.05)
                if self._exc is not None:
                    raise self._exc
                chunk = self._tokens[seen:]
                done = self._done and not chunk
            for t in chunk:
                yield t
            seen += len(chunk)
            if done:
                return

    def tokens(self) -> List[int]:
        """Block until final, then the full sequence."""
        for _ in self:
            pass
        with self._cond:
            return list(self._tokens)


class RemoteStreamSink:
    """Engine-side sink that ships frames to ``dest_party`` over the
    inline lane. Window-limited and coalescing (see module docstring);
    every call runs on the engine thread and returns immediately —
    ``barriers.send`` is fire-and-forget, transport threads do the IO.
    """

    def __init__(self, dest_party: str, stream_id: str, window: int = 4):
        self.dest_party = dest_party
        self.stream_id = stream_id
        self.window = max(1, int(window))
        self._frame_n = 0
        self._inflight: List[Any] = []  # un-acked send futures
        self._buf: List[int] = []       # coalesced tokens awaiting a slot
        self._buf_offset = 0
        self._have_buf = False

    def _send(self, frame: Dict[str, Any]) -> None:
        from rayfed_tpu_torch.proxy import barriers

        fut = barriers.send(
            self.dest_party,
            frame,
            f"{STREAM_SEQ_PREFIX}{self.stream_id}",
            str(self._frame_n),
        )
        self._frame_n += 1
        self._inflight.append(fut)

    def _drain(self) -> None:
        self._inflight = [f for f in self._inflight if not f.done()]

    def push(self, offset: int, toks: List[int], final: bool) -> None:
        if self._have_buf and offset == self._buf_offset + len(self._buf):
            self._buf.extend(toks)
        else:
            self._buf = list(toks)
            self._buf_offset = offset
            self._have_buf = True
        self._drain()
        # The final frame always goes out (total frames are bounded by
        # max_new_tokens, so "always" cannot amplify); interim frames
        # wait for a window slot and coalesce meanwhile.
        if final or len(self._inflight) < self.window:
            self._send(
                {"o": self._buf_offset, "t": self._buf, "f": bool(final)}
            )
            self._buf_offset += len(self._buf)
            self._buf = []
            self._have_buf = False

    def reset(self) -> None:
        self.push(0, [], False)

    def fail(self, exc: BaseException) -> None:
        self._drain()
        self._send({"e": repr(exc)})


class StreamConsumerError(RuntimeError):
    """The serving engine failed this request; raised to the stream
    consumer (the response FedObject carries the full error)."""


class TokenStream:
    """Consumer handle for one streamed request.

    Iterate it ON the ``stream_to`` party only; other drivers hold the
    object for symmetry but must not consume (their proxy never receives
    these frames). Local streams (consumer == serving party) are handed
    an in-process :class:`LocalTokenStream` and never touch the wire.
    """

    def __init__(
        self,
        src_party: str,
        stream_id: str,
        *,
        local: Optional[LocalTokenStream] = None,
    ):
        self.src_party = src_party
        self.stream_id = stream_id
        self._local = local
        self._tokens: List[int] = []
        self._first_token_s: Optional[float] = None

    @property
    def first_token_s(self) -> Optional[float]:
        if self._local is not None:
            return self._local.first_token_s
        return self._first_token_s

    def __iter__(self) -> Iterator[int]:
        import time

        if self._local is not None:
            yield from self._local
            return
        from rayfed_tpu_torch._private.global_context import get_global_context
        from rayfed_tpu_torch.proxy import barriers

        ctx = get_global_context()
        if ctx is None:
            raise RuntimeError("rayfed_tpu_torch is not initialized")
        me = ctx.get_current_party()
        if me == self.src_party:
            # Consumer on the serving party: the submit task registers
            # an in-process LocalTokenStream (no wire frames to recv) —
            # wait for it to appear, then delegate.
            deadline = time.monotonic() + 60.0
            while self._local is None:
                self._local = pop_local_stream(self.stream_id)
                if self._local is None:
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"stream {self.stream_id!r} never registered "
                            "on the serving party (was the submit issued "
                            "with this stream_to?)"
                        )
                    time.sleep(0.005)
            yield from self._local
            return
        n = 0
        seen = 0
        while True:
            frame = barriers.recv(
                me,
                self.src_party,
                f"{STREAM_SEQ_PREFIX}{self.stream_id}",
                str(n),
            ).result()
            n += 1
            if "e" in frame:
                raise StreamConsumerError(frame["e"])
            offset = int(frame.get("o", seen))
            toks = [int(t) for t in frame.get("t", ())]
            if offset < seen:
                # Engine restart: the re-run is deterministic (same
                # version pin, same sampling rng), so frames below our
                # high-water mark are duplicates — skip them.
                toks = toks[seen - offset:] if offset + len(toks) > seen else []
            for t in toks:
                if self._first_token_s is None:
                    self._first_token_s = time.perf_counter()
                self._tokens.append(t)
                yield t
                seen += 1
            if frame.get("f"):
                return

    def tokens(self) -> List[int]:
        for _ in self:
            pass
        if self._local is not None:
            return self._local.tokens()
        return list(self._tokens)


# -- local stream registry (consumer on the serving party) -----------------

_local_streams: JobScoped = JobScoped(
    "serving.local_streams", default_factory=dict
)


def register_local_stream(stream_id: str) -> LocalTokenStream:
    stream = LocalTokenStream(stream_id)
    _local_streams.get()[stream_id] = stream
    return stream


def pop_local_stream(stream_id: str) -> Optional[LocalTokenStream]:
    return _local_streams.get().pop(stream_id, None)
