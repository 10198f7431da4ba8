"""Pluggable job-state stores.

Parity reference: dlrover/python/util/state/store_mananger.py (StoreManager
+ MemoryStoreManager singletons), memory_store.py, stats_backend.py.

Two backends: in-memory (tests / single master) and an atomic-rename
file store (one JSON file per key) that survives master restarts — the
persistence layer under the brain-shaped stats archive (brain/client.py)
without requiring the reference's MySQL-backed Brain deployment.

Counterpart of ``dlrover_tpu/util/state_store.py``, under the same names.
"""

import json
import os
import threading
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger

ENV_BACKEND = "DLROVER_STATE_BACKEND"


class StateBackend(ABC):
    """parity: the KV surface of memory_store.py / stats_backend.py."""

    @abstractmethod
    def set(self, key: str, value: Any) -> None: ...

    @abstractmethod
    def get(self, key: str, default: Any = None) -> Any: ...

    @abstractmethod
    def delete(self, key: str) -> None: ...

    @abstractmethod
    def keys(self, prefix: str = "") -> List[str]: ...

    def mutate(self, key: str, fn, default: Any = None) -> Any:
        """Atomic read-modify-write: ``set(key, fn(get(key, default)))``
        under whatever exclusion the backend can provide. Backends
        shared ACROSS PROCESSES (FileStore) must make this safe against
        concurrent mutators — a plain get+set from two masters loses
        one side's update."""
        value = fn(self.get(key, default))
        self.set(key, value)
        return value

    def set_many(self, items: Dict[str, Any]) -> None:
        """Apply a batch of writes as one commit where the backend can
        (FileStore uses a redo log so a crash mid-batch restores to
        either all or none of the batch). The base implementation is a
        plain loop — fine for MemoryStore, whose process dies with its
        data anyway."""
        for key, value in items.items():
            self.set(key, value)


class MemoryStore(StateBackend):
    def __init__(self):
        self._lock = threading.Lock()
        self._data: Dict[str, Any] = {}

    def mutate(self, key, fn, default=None):
        with self._lock:
            value = fn(self._data.get(key, default))
            self._data[key] = value
            return value

    def set(self, key, value):
        with self._lock:
            self._data[key] = value

    def get(self, key, default=None):
        with self._lock:
            return self._data.get(key, default)

    def delete(self, key):
        with self._lock:
            self._data.pop(key, None)

    def keys(self, prefix=""):
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))


class FileStore(StateBackend):
    """One JSON file per key under ``root``; writes are atomic
    (tmp + rename) so a killed master never leaves a torn value.
    Keys may contain '/' (mapped to subdirectories)."""

    #: redo-log filename for multi-key commits; NOT ``*.json`` so
    #: ``keys()`` never surfaces it as a store key
    TXN_FILE = "__txn__.redo"

    def __init__(self, root: str):
        self._root = root
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)
        #: keys replayed from an interrupted set_many commit (crash
        #: after the commit point, before all per-key files landed);
        #: callers surface this as a recovery event
        self.recovered_txn_keys: List[str] = self._recover_txn()

    def _path(self, key: str) -> str:
        safe = key.strip("/")
        if ".." in safe.split("/"):
            raise ValueError(f"invalid key {key!r}")
        return os.path.join(self._root, safe + ".json")

    def set(self, key, value):
        path = self._path(key)
        with self._lock:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(value, f)
            os.replace(tmp, path)

    def get(self, key, default=None):
        try:
            with open(self._path(key)) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return default

    def delete(self, key):
        try:
            os.remove(self._path(key))
        except OSError:
            pass

    def keys(self, prefix=""):
        out = []
        for dirpath, _, files in os.walk(self._root):
            for name in files:
                if not name.endswith(".json"):
                    continue
                rel = os.path.relpath(
                    os.path.join(dirpath, name), self._root
                )
                key = rel[: -len(".json")].replace(os.sep, "/")
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def _set_locked(self, key, value):
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(value, f)
        os.replace(tmp, path)

    def set_many(self, items):
        """All-or-nothing multi-key commit via a redo log: the batch is
        first written to one file (tmp + rename = the atomic commit
        point), then applied per key, then the log is removed. A crash
        before the rename leaves every key at its pre-batch value; a
        crash after it is replayed by the next FileStore on this root —
        so readers never observe a torn mix of old and new keys. This
        is the group-commit transaction under
        ``master/state_journal.py``'s write-behind lane."""
        if not items:
            return
        if len(items) == 1:
            ((key, value),) = items.items()
            self.set(key, value)
            return
        txn_path = os.path.join(self._root, self.TXN_FILE)
        with self._lock:
            for key in items:
                self._path(key)  # validate before the commit point
            tmp = txn_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"items": [[k, v] for k, v in items.items()]}, f)
            os.replace(tmp, txn_path)  # <- commit point
            for key, value in items.items():
                self._set_locked(key, value)
            os.remove(txn_path)

    def _recover_txn(self) -> List[str]:
        """Replay an interrupted set_many: the redo log is only present
        between the commit point and the cleanup, so its batch is
        committed by definition — finish applying it."""
        txn_path = os.path.join(self._root, self.TXN_FILE)
        try:
            with open(txn_path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            # absent (normal) or torn tmp-less partial — a torn redo
            # log is impossible via the rename, but a foreign file
            # shouldn't wedge the store either
            try:
                os.remove(txn_path)
            except OSError:
                pass
            return []
        keys = []
        with self._lock:
            for key, value in doc.get("items", []):
                self._set_locked(key, value)
                keys.append(key)
            os.remove(txn_path)
        logger.warning(
            "FileStore %s: replayed interrupted commit of %d key(s)",
            self._root, len(keys),
        )
        return keys

    def mutate(self, key, fn, default=None):
        """Cross-PROCESS atomic read-modify-write via an fcntl lock on
        a per-key sidecar: the store is advertised as shared by every
        master on the reservation, and threading.Lock is invisible to
        sibling processes (two masters appending to the cluster event
        log must not lose each other's entries)."""
        import fcntl

        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".lock", "a+") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                value = fn(self.get(key, default))
                self.set(key, value)
                return value
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)


_singletons: Dict[str, StateBackend] = {}
_singleton_lock = threading.Lock()


def build_state_store(
    backend: Optional[str] = None, path: Optional[str] = None
) -> StateBackend:
    """Factory + per-(backend, path) singleton (parity:
    StoreManager.build_store_manager / singleton_instance)."""
    backend = backend or os.getenv(ENV_BACKEND, "memory")
    key = f"{backend}:{path or ''}"
    with _singleton_lock:
        if key not in _singletons:
            if backend == "memory":
                _singletons[key] = MemoryStore()
            elif backend == "file":
                root = path or os.path.join(
                    os.path.expanduser("~"), ".dlrover_tpu", "state"
                )
                _singletons[key] = FileStore(root)
            else:
                raise ValueError(f"unknown state backend {backend!r}")
            logger.info("State store: %s", key)
        return _singletons[key]
