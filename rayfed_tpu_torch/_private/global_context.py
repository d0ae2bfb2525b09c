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

"""Per-process global context: job identity, deterministic sequence ids,
shutdown-once flag, and the cleanup (send-drain) manager.

Capability parity: reference ``fed/_private/global_context.py:22-120``.
The monotonically increasing ``next_seq_id`` is THE cross-party ordering
mechanism — every party runs the same driver program, so every party numbers
every call site identically (reference ``fed_call_holder.py:67``); the pair
(producer seq id, consumer seq id) addresses each data-flow edge on the wire.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional


class GlobalContext:
    def __init__(
        self,
        job_name: str,
        current_party: str,
        sending_failure_handler: Optional[Callable[[Exception], None]] = None,
        exit_on_sending_failure: bool = False,
        continue_waiting_for_data_sending_on_error: bool = False,
        party_process_id: int = 0,
        party_num_processes: int = 1,
    ) -> None:
        self._job_name = job_name
        self._current_party = current_party
        # A party spanning several host processes elects process 0 the
        # leader: it alone owns the wire (proxies, sends); received
        # cross-party values are relayed to follower hosts over the
        # party's coordination service so every host can feed them into
        # the jitted multi-host computation.
        self._party_process_id = party_process_id
        self._party_num_processes = party_num_processes
        self._seq_count = 0
        self._seq_lock = threading.Lock()
        self._sending_failure_handler = sending_failure_handler
        self._exit_on_sending_failure = exit_on_sending_failure
        self._continue_waiting_for_data_sending_on_error = (
            continue_waiting_for_data_sending_on_error
        )
        self._atomic_shutdown_flag_lock = threading.Lock()
        self._atomic_shutdown_flag = True
        # The last *sending* error lives on the CleanupManager (the drain
        # thread records it); only received errors are tracked here.
        self._last_received_error: Optional[Exception] = None

        # Imported lazily to avoid a cycle (cleanup → barriers → context).
        from rayfed_tpu_torch._private.cleanup import CleanupManager
        from rayfed_tpu_torch._private.executor import LocalExecutor

        self._cleanup_manager = CleanupManager(
            current_party, self.acquire_shutdown_flag
        )
        # The party-local task engine (replaces Ray task submission,
        # ref fed/api.py:413-417).
        self._executor = LocalExecutor()

    # -- identity ---------------------------------------------------------
    def get_job_name(self) -> str:
        return self._job_name

    def get_current_party(self) -> str:
        return self._current_party

    def get_party_process_id(self) -> int:
        return self._party_process_id

    def get_party_num_processes(self) -> int:
        return self._party_num_processes

    def is_party_leader(self) -> bool:
        return self._party_process_id == 0

    # -- deterministic DAG numbering (ref global_context.py:45-47) --------
    def next_seq_id(self) -> int:
        with self._seq_lock:
            self._seq_count += 1
            return self._seq_count

    def peek_seq_id(self) -> int:
        """Current DAG position WITHOUT advancing it — advancing outside a
        call site would desynchronize this party from its peers."""
        with self._seq_lock:
            return self._seq_count

    def reset_seq_id(self, value: int = 0) -> None:
        """Restart the DAG numbering — ONLY safe at a membership epoch
        bump, where every party resets at the same program point and the
        barrier layer's epoch stamp keeps old-numbered in-flight frames
        in a disjoint key space."""
        with self._seq_lock:
            self._seq_count = value

    # -- cleanup / failure bookkeeping ------------------------------------
    def get_cleanup_manager(self):
        return self._cleanup_manager

    def get_executor(self):
        return self._executor

    def get_sending_failure_handler(self):
        return self._sending_failure_handler

    def get_exit_on_sending_failure(self) -> bool:
        return self._exit_on_sending_failure

    def get_continue_waiting_for_data_sending_on_error(self) -> bool:
        return self._continue_waiting_for_data_sending_on_error

    def set_last_received_error(self, err: Exception) -> None:
        self._last_received_error = err

    def get_last_received_error(self) -> Optional[Exception]:
        return self._last_received_error

    def acquire_shutdown_flag(self) -> bool:
        """Return True exactly once — the caller that wins performs shutdown.

        Reference ``global_context.py:70-87``: uses a non-blocking acquire so
        a signal handler re-entering during shutdown cannot deadlock.
        """
        if not self._atomic_shutdown_flag_lock.acquire(blocking=False):
            return False
        try:
            if not self._atomic_shutdown_flag:
                return False
            self._atomic_shutdown_flag = False
            return True
        finally:
            self._atomic_shutdown_flag_lock.release()


# Tenancy: one GlobalContext per job, resolved through the ambient
# FedContext (tenancy/context.py) so concurrent fed.init jobs in one
# process each see their own seq counters, cleanup manager and executor.
from rayfed_tpu_torch.tenancy.context import JobScoped

_contexts: "JobScoped[GlobalContext]" = JobScoped("global_context")
_context_lock = threading.Lock()  # fedlint: disable=global-mutable-singleton (guards per-job context slots; cleared by clear_global_context at shutdown)


def init_global_context(
    job_name: str,
    current_party: str,
    sending_failure_handler: Optional[Callable[[Exception], None]] = None,
    exit_on_sending_failure: bool = False,
    continue_waiting_for_data_sending_on_error: bool = False,
    party_process_id: int = 0,
    party_num_processes: int = 1,
) -> GlobalContext:
    from rayfed_tpu_torch.tenancy.context import current_job

    with _context_lock:
        job = current_job() or job_name
        existing = _contexts.peek(job)
        if existing is None:
            existing = GlobalContext(
                job_name,
                current_party,
                sending_failure_handler=sending_failure_handler,
                exit_on_sending_failure=exit_on_sending_failure,
                continue_waiting_for_data_sending_on_error=(
                    continue_waiting_for_data_sending_on_error
                ),
                party_process_id=party_process_id,
                party_num_processes=party_num_processes,
            )
            _contexts.set(existing, job=job)
        return existing


def get_global_context() -> Optional[GlobalContext]:
    return _contexts.peek()


def clear_global_context(wait_for_sending: bool = False) -> None:
    with _context_lock:
        ctx = _contexts.peek()
        if ctx is not None:
            # Drain BEFORE the context goes: a failed send's error
            # envelope is tracked on this context's cleanup manager
            # (barriers.send), so with the context already popped an
            # envelope queued during the drain went untracked, and the
            # proxies stopped under it before the peer had it.
            ctx.get_cleanup_manager().stop(wait_for_sending=wait_for_sending)
            _contexts.pop()
            ctx.get_executor().shutdown(wait=False)
