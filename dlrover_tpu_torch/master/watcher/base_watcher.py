"""Node event watching.

Parity reference: dlrover/python/master/watcher/base_watcher.py:20,28
(NodeEvent, NodeWatcher ABC) and the reference tests' pattern of feeding
hand-built events (tests/test_k8s_watcher.py).

A copy of ``dlrover_tpu/master/watcher/base_watcher.py``.
"""

import queue
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Iterator, List, Optional

from dlrover_tpu_torch.common.node import Node


@dataclass
class NodeEvent:
    event_type: str  # NodeEventType
    node: Node


class NodeWatcher(ABC):
    """Streams node lifecycle events from the platform."""

    @abstractmethod
    def watch(self) -> Iterator[NodeEvent]:
        """Block, yielding events until stopped."""

    @abstractmethod
    def list(self) -> List[Node]:
        """Snapshot of currently-known nodes."""

    def stop(self) -> None:
        pass


class InMemoryWatcher(NodeWatcher):
    """Queue-backed watcher: the platform (or a test) pushes events.

    This is the fake-cluster backbone (parity: reference tests feed
    V1Pod fixtures into the watcher), and the real local platform's
    process supervisor pushes into it too.
    """

    _STOP = object()

    def __init__(self):
        self._queue: "queue.Queue" = queue.Queue()
        self._nodes: dict = {}
        self._stopped = False

    def push(self, event: NodeEvent) -> None:
        key = (event.node.type, event.node.id)
        self._nodes[key] = event.node
        self._queue.put(event)

    def watch(self) -> Iterator[NodeEvent]:
        while not self._stopped:
            item = self._queue.get()
            if item is self._STOP:
                return
            yield item

    def list(self) -> List[Node]:
        return list(self._nodes.values())

    def stop(self) -> None:
        self._stopped = True
        self._queue.put(self._STOP)
