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

"""Single-consumer polling queue backing the send-drain threads.

Capability parity: reference ``fed/_private/message_queue.py:28-105`` — a
daemon thread pops callables off a deque; ``stop()`` enqueues a stop symbol
so in-flight sends drain first; a non-graceful stop from a signal-handler
context must not join the thread it is running on (reference
``message_queue.py:84-99``).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Optional

logger = logging.getLogger(__name__)

_STOP = object()


class MessageQueueManager:
    def __init__(self, msg_handler: Callable, failure_handler: Optional[Callable] = None,
                 thread_name: str = "fedtpu-msg-queue"):
        # One handler per message; returning False marks a handling failure.
        self._msg_handler = msg_handler
        self._failure_handler = failure_handler
        self._thread_name = thread_name
        self._queue: deque = deque()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def start(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return

            def _loop() -> None:
                while True:
                    try:
                        msg = self._queue.popleft()
                    except IndexError:
                        time.sleep(0.05)
                        continue
                    if msg is _STOP:
                        break
                    try:
                        ok = self._msg_handler(msg)
                    except Exception:  # noqa: BLE001 - drain must survive
                        logger.exception("message handler raised")
                        ok = False
                    if ok is False:
                        if self._failure_handler is not None:
                            try:
                                self._failure_handler()
                            except Exception:  # noqa: BLE001
                                logger.exception("failure handler raised")
                        break
                logger.debug("message queue %s exited", self._thread_name)

            self._thread = threading.Thread(
                target=_loop, name=self._thread_name, daemon=True
            )
            self._thread.start()

    def append(self, msg) -> None:
        self._queue.append(msg)

    def appendleft(self, msg) -> None:
        self._queue.appendleft(msg)

    def size(self) -> int:
        return len(self._queue)

    def is_started(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stop(self, graceful: bool = True) -> None:
        """Graceful: let queued sends drain, then join. Non-graceful: ask the
        thread to stop at the next pop without joining (safe from signal
        handlers running on arbitrary threads)."""
        if not self.is_started():
            return
        if threading.current_thread() is self._thread:
            # A handler asked its own queue to stop; just mark it.
            self._queue.appendleft(_STOP) if not graceful else self._queue.append(_STOP)
            return
        if graceful:
            self._queue.append(_STOP)
            self._thread.join()
        else:
            self._queue.appendleft(_STOP)
