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

"""Party-local task execution engine.

This replaces the reference's L0 substrate — Ray tasks and actors
(`ray.remote(...).remote()` submission at ref ``fed/api.py:413-417`` and the
actor machinery at ``fed/_private/fed_actor.py``) — with an in-process
dataflow thread pool. Rationale (TPU-first): party-local "tasks" are mostly
jit-compiled JAX calls; XLA dispatch is already asynchronous and releases the
GIL during device execution, so threads give real overlap without Ray's
per-task IPC + serialization overhead (the reference's dominant cost in the
many-tiny-tasks benchmark, ``benchmarks/many_tiny_tasks_benchmark.py``).

Dataflow contract:
 - ``submit`` returns one (or ``num_returns``) ``concurrent.futures.Future``.
 - Arguments may contain Futures nested in pytrees; the worker resolves them
   before invoking the function — mirroring Ray's ObjectRef dereferencing as
   used via ``resolve_dependencies`` (ref ``fed/utils.py:48-83``).
 - Because every dependency Future is created before any task that consumes
   it, and the pool queue is FIFO, blocking waits inside workers cannot
   deadlock: a blocked task's dependency has always already been dequeued.
 - ``SerialLane`` provides actor semantics: one dedicated thread, methods
   execute one-at-a-time in submission order (Ray actor ordering guarantee).
"""

from __future__ import annotations

import contextvars
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from queue import Queue
from typing import Any, Callable, List, Optional, Sequence, Union

import torch

from rayfed_tpu_torch import tree_util


def _resolve(obj: Any) -> Any:
    """Replace every Future leaf in a pytree with its result (blocking;
    steals the producing task inline when it has not started yet)."""
    def leaf(x: Any) -> Any:
        if isinstance(x, Future):
            if not x.done():
                steal(x)
            return x.result()
        return x

    return tree_util.tree_map(leaf, obj)


def _deps_ready(obj: Any) -> bool:
    """True when no Future leaf in the pytree is still pending (failed
    futures count as ready — _resolve will surface their exception)."""
    ready = True

    def leaf(x: Any) -> Any:
        nonlocal ready
        if ready and isinstance(x, Future) and not x.done():
            ready = False
        return x

    tree_util.tree_map(leaf, obj)
    return ready


def try_resolved(obj: Any) -> "tuple[bool, Any]":
    """Non-blocking companion to :func:`_resolve` for the send fast path:
    (True, value) when ``obj`` is a plain value or an already-successful
    Future — the caller may proceed inline without a pool hop — else
    (False, None), meaning the value still needs the blocking dataflow
    path (pending, or failed: the worker path owns error enveloping)."""
    if isinstance(obj, Future):
        if obj.done() and obj.exception() is None:
            return True, obj.result()
        return False, None
    return True, obj


class _StealableTask:
    """A pool task a *blocked consumer* may claim and run on its own
    thread. On a busy (or single-core) host the pool-worker wake-up is a
    full context switch on the critical path; a consumer that is about to
    block in ``Future.result`` runs the producer inline instead. The
    claim flag makes pool worker and thief mutually exclusive — whoever
    claims first runs, the other does nothing."""

    __slots__ = ("fn", "args", "kwargs", "out", "num_returns",
                 "_lock", "_claimed", "_ctx")

    def __init__(self, fn, args, kwargs, out, num_returns, ctx=None):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.out = out
        self.num_returns = num_returns
        self._lock = threading.Lock()
        self._claimed = False
        # Submitter's contextvar snapshot: pool workers (and thieves on
        # foreign drivers) must resolve the same FedContext the task was
        # submitted under, or a co-tenant's JobScoped state would leak in.
        self._ctx = ctx

    def claim(self) -> bool:
        with self._lock:
            if self._claimed:
                return False
            self._claimed = True
            return True

    def run_if_unclaimed(self) -> None:
        if self.claim():
            self._execute()

    def _execute(self) -> None:
        if self._ctx is not None:
            self._ctx.run(_run_task, self.fn, self.args, self.kwargs,
                          self.out, self.num_returns)
        else:
            _run_task(self.fn, self.args, self.kwargs, self.out,
                      self.num_returns)
        # Drop payload refs promptly: the out-futures keep this shell
        # alive via their steal attribute until they are collected.
        self.fn = self.args = self.kwargs = self.out = self._ctx = None


_steal_depth = threading.local()
# Each inline steal nests _run_task/_resolve frames on the thief's stack;
# cap the nesting so a long dependency chain blocks (pool workers make
# progress independently) instead of hitting the recursion limit.
_STEAL_DEPTH_MAX = 20


def steal(fut: Future) -> None:
    """If ``fut`` belongs to a queued-but-unstarted pool task, run that
    task on the calling thread. No-op for lane (actor) tasks, transport
    futures, started/claimed tasks, or past the nesting cap."""
    task = getattr(fut, "_fedtpu_steal", None)
    if task is None:
        return
    depth = getattr(_steal_depth, "v", 0)
    if depth >= _STEAL_DEPTH_MAX or not task.claim():
        return
    _steal_depth.v = depth + 1
    try:
        task._execute()
    finally:
        _steal_depth.v = depth


def result_stealing(fut: Future, timeout: Optional[float] = None) -> Any:
    """``fut.result(timeout)`` preceded by an inline steal attempt — the
    entry point for API-level consumers (``fed.get``)."""
    if not fut.done():
        steal(fut)
    return fut.result(timeout)


def tensor_versions(value: Any) -> Optional[tuple]:
    """The in-place version counters of ``value``'s tensor leaves, in
    flatten order (None for an inference tensor, which keeps none); None
    when ``value`` holds no tensor."""
    try:
        leaves, _ = tree_util.tree_flatten(value)
    except Exception:  # noqa: BLE001 - unflattenable values hold no leaves
        return None
    versions = tuple(
        None if x.is_inference() else x._version
        for x in leaves if isinstance(x, torch.Tensor)
    )
    return versions or None


def set_result_versioned(fut: Future, value: Any) -> None:
    """Resolve ``fut`` with ``value``, first stamping its tensor leaves'
    versions on the future: a push registered only after resolution
    compares them, to refuse a value that a later task has since mutated
    in place (``proxy/barriers._capture_for_send``)."""
    fut._fedtpu_versions = tensor_versions(value)
    fut.set_result(value)


def _run_task(
    fn: Callable,
    args: Sequence[Any],
    kwargs: Optional[dict],
    out: Union[Future, List[Future]],
    num_returns: int,
) -> None:
    try:
        rargs = _resolve(list(args))
        rkwargs = _resolve(kwargs or {})
        result = fn(*rargs, **rkwargs)
    except BaseException as e:  # noqa: BLE001 - stored, not swallowed
        if num_returns == 1:
            out.set_exception(e)
        else:
            for f in out:
                f.set_exception(e)
        return
    if num_returns == 1:
        set_result_versioned(out, result)
    else:
        try:
            items = list(result)
            if len(items) != num_returns:
                raise ValueError(
                    f"task declared num_returns={num_returns} but returned "
                    f"{len(items)} values"
                )
        except BaseException as e:  # noqa: BLE001
            for f in out:
                f.set_exception(e)
            return
        for f, item in zip(out, items):
            set_result_versioned(f, item)


#: How long ``LocalExecutor.shutdown`` waits, in all, for its lane
#: threads to finish the task in hand and exit.
LANE_JOIN_TIMEOUT_S = 5.0


class SerialLane:
    """A single-threaded execution lane preserving submission order —
    the actor execution model (ref ``fed/_private/fed_actor.py``).

    The lane thread is a daemon, so ``LocalExecutor.shutdown`` joins it:
    a daemon thread that frees a tensor (releasing the GIL inside torch's
    deallocator) while the interpreter finalizes is made to exit inside
    that noexcept deallocator, and the process aborts ("terminate called
    without an active exception")."""

    def __init__(self, name: str = "fedtpu-actor-lane"):
        self._q: "Queue[Optional[Callable[[], None]]]" = Queue()
        self._lock = threading.Lock()
        self.killed = False
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            item()
            # Free the task's arguments and results now, not when the next
            # item arrives (perhaps the stop sentinel, at shutdown).
            del item

    def submit_thunk(self, thunk: Callable[[], None]) -> bool:
        """Enqueue; False if the lane was killed (caller must fail the
        task's futures itself — nothing will ever dequeue them)."""
        with self._lock:
            if self.killed:
                return False
            self._q.put(thunk)
            return True

    def kill(self) -> None:
        """Fail-fast teardown: queued-but-unexecuted thunks observe
        ``killed`` and fail their futures instead of silently vanishing."""
        with self._lock:
            self.killed = True
            self._q.put(None)

    def stop(self) -> None:
        self._q.put(None)

    def join(self, timeout: float) -> None:
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)


class LocalExecutor:
    """The party-local scheduler: a FIFO thread pool plus serial lanes."""

    def __init__(self, max_workers: int = 32):
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="fedtpu-exec"
        )
        self._lanes: List[SerialLane] = []
        self._lock = threading.Lock()

    def submit(
        self,
        fn: Callable,
        args: Sequence[Any] = (),
        kwargs: Optional[dict] = None,
        *,
        num_returns: int = 1,
        lane: Optional[SerialLane] = None,
        eager: bool = True,
    ) -> Union[Future, List[Future]]:
        if num_returns == 1:
            out: Union[Future, List[Future]] = Future()
        else:
            out = [Future() for _ in range(num_returns)]

        def fail_all(exc: BaseException) -> None:
            for f in out if isinstance(out, list) else [out]:
                f.set_exception(exc)

        def _charge_slot() -> Optional[str]:
            # Tenant quota on pool/lane occupancy ("executor_tasks"):
            # eager-inline tasks run on the caller's own thread and are
            # exempt — the quota caps how much of the SHARED worker pool
            # one tenant may hold. Raises TenantQuotaExceeded loudly.
            from rayfed_tpu_torch.tenancy.context import current_job
            from rayfed_tpu_torch.tenancy.qos import get_ledger

            job = current_job()
            get_ledger().charge(job, "executor_tasks", 1)
            first = out[0] if isinstance(out, list) else out
            first.add_done_callback(
                lambda _f: get_ledger().release(job, "executor_tasks", 1)
            )
            return job

        if lane is not None:
            from rayfed_tpu_torch.exceptions import FedActorKilledError

            _charge_slot()
            task_ctx = contextvars.copy_context()

            def thunk() -> None:
                if lane.killed:
                    fail_all(FedActorKilledError("actor was killed"))
                    return
                task_ctx.run(_run_task, fn, args, kwargs, out, num_returns)

            if not lane.submit_thunk(thunk):
                fail_all(FedActorKilledError("actor was killed"))
        elif eager and _deps_ready(list(args)) and _deps_ready(kwargs or {}):
            # Eager inline execution: every dependency is already
            # resolved, so the task has nothing to block on — running it
            # on the caller's thread skips the pool-dispatch wake-up AND
            # the consumer's wait wake-up (the future resolves before
            # submit returns). This cannot deadlock the driver: every
            # future in this system is created at submission time (task,
            # actor call, or transport recv), so anything a task could
            # wait on internally is already in flight and resolves
            # without the caller's help. The latency-critical chains
            # (small federated rounds) are exactly the ones whose tiny
            # tasks land here. Tasks submitted with ``eager=False`` opt
            # out: a task that BLOCKS until other submissions make
            # progress (e.g. a serving submit waiting on the batched
            # decode engine) must not occupy the caller's thread, or the
            # driver could never issue the concurrent work it waits on.
            _run_task(fn, args, kwargs, out, num_returns)
        else:
            _charge_slot()
            task = _StealableTask(
                fn, args, kwargs, out, num_returns,
                ctx=contextvars.copy_context(),
            )
            for f in out if isinstance(out, list) else [out]:
                f._fedtpu_steal = task
            self._pool.submit(task.run_if_unclaimed)
        return out

    def new_lane(self, name: str = "fedtpu-actor-lane") -> SerialLane:
        lane = SerialLane(name)
        with self._lock:
            self._lanes.append(lane)
        return lane

    def shutdown(self, wait: bool = True) -> None:
        with self._lock:
            lanes, self._lanes = self._lanes, []
        for lane in lanes:
            lane.stop()
        # Each lane finishes the task in hand and exits (bounded: a task
        # blocked on a peer that is gone keeps its lane past the wait).
        deadline = time.monotonic() + LANE_JOIN_TIMEOUT_S
        for lane in lanes:
            lane.join(max(0.0, deadline - time.monotonic()))
        self._pool.shutdown(wait=wait)
