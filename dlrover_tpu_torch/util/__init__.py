"""Counterpart of ``dlrover_tpu/util/__init__.py``, under the same names."""

from dlrover_tpu_torch.util.event_queue import EventQueue
from dlrover_tpu_torch.util.state_store import (
    FileStore,
    MemoryStore,
    StateBackend,
    build_state_store,
)

__all__ = [
    "EventQueue",
    "FileStore",
    "MemoryStore",
    "StateBackend",
    "build_state_store",
]
