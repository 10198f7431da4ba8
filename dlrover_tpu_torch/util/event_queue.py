"""Bounded in-process event queue.

Parity reference: dlrover/python/util/queue/queue.py (RayEventQueue — a
singleton bounded queue the Ray actors pump scheduling events through).

TPU shape: the single-controller master needs the same decoupling
between event producers (watchers, servicer RPCs, diagnosis) and the
consumer loop, without Ray: a thread-safe bounded deque where overflow
drops the OLDEST event (late scheduling news supersedes early news).

Counterpart of ``dlrover_tpu/util/event_queue.py``, under the same names.
"""

import threading
import time
from collections import deque
from typing import Any, Optional

from dlrover_tpu_torch.telemetry import counter


class EventQueue:
    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self, max_size: int = 1000):
        self._deque: deque = deque(maxlen=max_size)
        self._cond = threading.Condition()
        self._dropped = 0

    @classmethod
    def singleton_instance(cls, max_size: int = 1000) -> "EventQueue":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls(max_size)
            return cls._instance

    def put(self, event: Any) -> None:
        with self._cond:
            # maxlen drops from the left (oldest): deliberate — late
            # scheduling news supersedes early news — but COUNTED, so
            # a consumer falling behind is visible, not silent
            if (
                self._deque.maxlen is not None
                and len(self._deque) == self._deque.maxlen
            ):
                self._dropped += 1
                counter(
                    "dlrover_event_queue_dropped_total",
                    "Oldest events evicted by queue overflow",
                ).inc()
            self._deque.append(event)
            self._cond.notify()

    def get(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Pop the oldest event, blocking up to ``timeout`` (None waits
        forever); returns None on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._deque:
                remaining = (
                    None if deadline is None
                    else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return None
                if not self._cond.wait(remaining):
                    return None
            return self._deque.popleft()

    @property
    def dropped(self) -> int:
        """Events evicted (oldest-first) by overflow since creation."""
        with self._cond:
            return self._dropped

    def __len__(self) -> int:
        with self._cond:
            return len(self._deque)
