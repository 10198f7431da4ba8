"""In-master KV store backing distributed bootstrap.

Parity reference: dlrover/python/master/elastic_training/kv_store_service.py:18.
In the TPU stack this KV store carries the jax.distributed coordinator
address election (rank-0 agent writes, others read) instead of a torch
TCPStore replacement.
"""

import threading
from typing import Callable, Dict, Optional


class KVStoreService:
    def __init__(self,
                 listener: Optional[Callable[[Dict[str, bytes]], None]]
                 = None):
        self._lock = threading.Lock()
        self._store: Dict[str, bytes] = {}
        #: invoked with a snapshot after every mutation — the master's
        #: state journal persists it so coordinator-election keys and
        #: barrier counters survive a master restart
        self._listener = listener

    def _notify(self, snap: Dict[str, bytes]):
        if self._listener is None:
            return
        try:
            self._listener(snap)
        except Exception:
            pass  # persistence is best-effort; never fail the RPC

    def snapshot(self) -> Dict[str, bytes]:
        with self._lock:
            return dict(self._store)

    def load(self, data: Dict[str, bytes]):
        """Replace contents wholesale (master-restart restore)."""
        with self._lock:
            self._store = dict(data)

    def set(self, key: str, value: bytes):
        with self._lock:
            self._store[key] = value
            snap = dict(self._store)
        self._notify(snap)

    def get(self, key: str) -> bytes:
        with self._lock:
            return self._store.get(key, b"")

    def keys(self, prefix: str = "") -> list:
        """Sorted keys under a prefix — the checkpoint peer registry
        scans ``ckpt/peer/`` to learn who advertises which step."""
        with self._lock:
            return sorted(
                k for k in self._store if k.startswith(prefix)
            )

    def add(self, key: str, amount: int) -> int:
        """Atomic integer add (torch-Store-style counter semantics)."""
        with self._lock:
            cur = int(self._store.get(key, b"0") or b"0")
            cur += amount
            self._store[key] = str(cur).encode()
            snap = dict(self._store)
        self._notify(snap)
        return cur

    def delete(self, key: str):
        with self._lock:
            self._store.pop(key, None)
            snap = dict(self._store)
        self._notify(snap)

    def clear(self):
        with self._lock:
            self._store.clear()
        self._notify({})
