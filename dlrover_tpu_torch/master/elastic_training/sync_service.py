"""Named worker join-syncs and barriers.

Parity reference: dlrover/python/master/elastic_training/sync_service.py:26.
"""

import threading
from typing import Dict, Set

from dlrover_tpu_torch.common.log import default_logger as logger


class SyncService:
    def __init__(self, job_manager=None):
        self._lock = threading.Lock()
        self._job_manager = job_manager
        self._sync_objs_target: Dict[str, Set] = {}
        self._finished_barriers: Set[str] = set()

    def _worker_count(self) -> int:
        if self._job_manager is None:
            return 0
        try:
            return len(self._job_manager.get_running_workers())
        except Exception:
            return 0

    def join_sync(self, sync_name: str, node_type: str, node_id: int) -> bool:
        with self._lock:
            members = self._sync_objs_target.setdefault(sync_name, set())
            members.add((node_type, node_id))
            target = self._worker_count()
            return target > 0 and len(members) >= target

    def sync_finished(self, sync_name: str) -> bool:
        with self._lock:
            members = self._sync_objs_target.get(sync_name, set())
            target = self._worker_count()
            return target > 0 and len(members) >= target

    def barrier(self, barrier_name: str) -> bool:
        with self._lock:
            return barrier_name in self._finished_barriers

    def notify_barrier(self, barrier_name: str) -> bool:
        with self._lock:
            self._finished_barriers.add(barrier_name)
            logger.info("Barrier %s notified", barrier_name)
            return True

    def remove_exited_worker_sync(self, node_type: str, node_id: int):
        with self._lock:
            for members in self._sync_objs_target.values():
                members.discard((node_type, node_id))
