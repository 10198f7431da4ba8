"""TaskManager: datasets -> shards -> tasks, with straggler recovery.

Parity reference: dlrover/python/master/shard/task_manager.py:36
(get_dataset_task:91, report_dataset_task:119, recover_tasks:158,
_check_and_reassign_timeout_tasks:205).
"""

import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import NodeType, TaskType
from dlrover_tpu_torch.common.global_context import Context
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.shard.base_dataset_manager import (
    DatasetManger,
    DatasetShardCheckpoint,
    Task,
)
from dlrover_tpu_torch.master.shard.batch_dataset_manager import BatchDatasetManager
from dlrover_tpu_torch.master.shard.dataset_splitter import (
    DatasetSplitter,
    StreamingDatasetSplitter,
    new_dataset_splitter,
)
from dlrover_tpu_torch.master.shard.streaming_dataset_manager import (
    StreamingDatasetManager,
)
from dlrover_tpu_torch.telemetry import gauge, histogram

_context = Context.singleton_instance()

#: dispatch latency buckets: sub-ms in-memory pops up to multi-second
#: journal-bound group commits
_DISPATCH_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5,
)


class TaskManager:
    """Dispatches and recovers data-shard tasks across datasets."""

    def __init__(self, worker_restart_timeout: float = 0.0,
                 speed_monitor=None):
        self._lock = threading.Lock()
        self._worker_restart_timeout = worker_restart_timeout
        self._should_stop = False
        self._datasets: Dict[str, DatasetManger] = {}
        self._worker_client_version: Dict[int, float] = {}
        self._speed_monitor = speed_monitor
        self._task_timeout = _context.task_process_timeout
        self._thread: Optional[threading.Thread] = None
        self._state_journal = None
        # resolved once, not per dispatch (registry lookups are a dict
        # hit but the hot path shouldn't pay even that per task)
        self._dispatch_hist = histogram(
            "dlrover_shard_dispatch_seconds",
            "Wall time of one shard-dispatch call on the master, "
            "including the group-commit journal write",
            ["dataset"], buckets=_DISPATCH_BUCKETS,
        )
        self._dispatch_batch_gauge = gauge(
            "dlrover_shard_dispatch_batch_size",
            "Number of real shards handed out by the most recent "
            "dispatch call", ["dataset"],
        )

    def attach_state_journal(self, journal):
        """Write-through persistence: every shard-ledger mutation lands
        in the journal before the RPC reply leaves, so a restarted
        master resumes with the doing set the workers actually hold."""
        with self._lock:
            self._state_journal = journal

    def _persist_locked(self, dataset_name: str):
        """Persist one dataset's ledger; caller holds self._lock."""
        if self._state_journal is None:
            return
        ds = self._datasets.get(dataset_name)
        ckpt = getattr(ds, "checkpoint", None) if ds else None
        if ckpt is None:
            return
        try:
            self._state_journal.save_dataset_checkpoint(
                dataset_name, ckpt().to_json()
            )
        except Exception as e:  # never fail the dispatch on journal IO
            logger.warning(
                "state journal write failed for dataset %s: %s",
                dataset_name, e,
            )

    # ------------------------------------------------------------- datasets

    def new_dataset(
        self,
        batch_size: int,
        dataset_size: int,
        dataset_name: str,
        dataset_splitter: DatasetSplitter,
        task_type: str = TaskType.TRAINING,
        params: Optional[dict] = None,
    ):
        """Register a dataset. ``params`` are the raw shard params the
        worker reported — journaled so a restarted master can rebuild
        the splitter before any worker re-registers."""
        with self._lock:
            if dataset_name in self._datasets:
                logger.info("Dataset %s already registered", dataset_name)
                return
            if isinstance(dataset_splitter, StreamingDatasetSplitter):
                dataset = StreamingDatasetManager(
                    task_type, batch_size, dataset_splitter
                )
            else:
                dataset = BatchDatasetManager(
                    task_type, batch_size, dataset_splitter
                )
            self._datasets[dataset_name] = dataset
            if self._state_journal is not None and params is not None:
                try:
                    self._state_journal.save_dataset_params(
                        dataset_name, params
                    )
                except Exception as e:
                    logger.warning(
                        "state journal write failed for dataset %s "
                        "params: %s", dataset_name, e,
                    )
            self._persist_locked(dataset_name)
            logger.info(
                "New dataset %s: size=%d batch=%d type=%s",
                dataset_name, dataset_size, batch_size, task_type,
            )

    def get_dataset(self, name: str) -> Optional[DatasetManger]:
        with self._lock:
            return self._datasets.get(name)

    def reset_dataset(self, name: str):
        with self._lock:
            ds = self._datasets.get(name)
            if ds:
                ds.reset()
                # commit-before-reply: a reset that only lived in
                # memory would resurrect the old ledger on master
                # restart and re-deliver every shard of the epoch
                self._persist_locked(name)

    # ---------------------------------------------------------------- tasks

    def get_dataset_task(self, node_type: str, node_id: int,
                         dataset_name: str,
                         incarnation: int = -1) -> Task:
        return self.get_dataset_tasks(
            node_type, node_id, dataset_name, max_tasks=1,
            incarnation=incarnation,
        )[0]

    def get_dataset_tasks(self, node_type: str, node_id: int,
                          dataset_name: str, max_tasks: int = 1,
                          incarnation: int = -1) -> List[Task]:
        """Pop up to ``max_tasks`` shards in one call, group-committing
        the ledger: ONE journal write covers the whole batch, still
        written BEFORE the reply leaves — if the reply is lost with the
        master, the restored doing entries time out and requeue; if it
        arrives, the completion reports match. Returns at least one
        task; a WAIT or invalid task is only ever returned alone (the
        caller consumes real shards first, then polls).
        """
        max_tasks = max(1, max_tasks)
        t0 = time.perf_counter()
        tasks: List[Task] = []
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is None:
                return [Task.create_invalid_task()]
            for _ in range(max_tasks):
                task = ds.get_task(node_type, node_id, incarnation)
                if task.task_id < 0:
                    # WAIT/exhausted terminates the batch; surface it
                    # only when there is no real shard to deliver
                    if not tasks:
                        tasks.append(task)
                    break
                tasks.append(task)
            dispatched = sum(1 for t in tasks if t.task_id >= 0)
            if dispatched:
                # group commit: one FileStore mutate for the batch
                self._persist_locked(dataset_name)
        self._dispatch_batch_gauge.labels(dataset=dataset_name).set(
            dispatched
        )
        self._dispatch_hist.labels(dataset=dataset_name).observe(
            time.perf_counter() - t0
        )
        return tasks

    def report_dataset_task(self, dataset_name: str, task_id: int,
                            success: bool, err: str = ""):
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is None:
                raise ValueError(f"unknown dataset {dataset_name}")
            success, doing_task = ds.report_task_status(task_id, success)
            if doing_task is not None:
                self._persist_locked(dataset_name)
            if success and self._speed_monitor and doing_task:
                self._speed_monitor.add_task_completed(
                    doing_task.node_id, time.time() - doing_task.start_time
                )
                # shard-fed jobs' throughput signal (speed_monitor
                # defers to real global-step reports when they exist)
                self._speed_monitor.collect_batch_done(1, time.time())
            return success

    def recover_tasks(self, node_type: str, node_id: int):
        """Requeue all doing tasks of a failed node
        (parity: task_manager.py:158)."""
        with self._lock:
            for name, ds in self._datasets.items():
                recover = getattr(ds, "recover_tasks_of_node", None)
                if recover:
                    ids = recover(node_id)
                    if ids:
                        self._persist_locked(name)
                        logger.info(
                            "Recovered tasks %s of node %s in dataset %s",
                            ids, node_id, name,
                        )

    def relinquish_tasks(self, node_type: str, node_id: int,
                         dataset_name: str = "") -> int:
        """Proactive drain handoff (fault_tolerance/drain.py): requeue
        the node's in-flight tasks NOW, group-committed through the
        state journal, instead of waiting out the task-timeout
        watchdog. Exactly-once unchanged: a late completion report for
        a requeued task is rejected by ``report_task_status``. Empty
        ``dataset_name`` covers every dataset; returns the requeue
        count."""
        requeued = 0
        with self._lock:
            for name, ds in self._datasets.items():
                if dataset_name and name != dataset_name:
                    continue
                recover = getattr(ds, "recover_tasks_of_node", None)
                if recover:
                    ids = recover(node_id)
                    if ids:
                        requeued += len(ids)
                        self._persist_locked(name)
                        logger.info(
                            "Relinquished tasks %s of node %s in "
                            "dataset %s", ids, node_id, name,
                        )
        return requeued

    def finished(self) -> bool:
        """All registered datasets have dispatched and completed all tasks."""
        with self._lock:
            if not self._datasets:
                return False
            return all(ds.completed() for ds in self._datasets.values())

    def training_started(self) -> bool:
        with self._lock:
            started = any(
                ds.doing or ds.todo for ds in self._datasets.values()
            )
        return started or self.finished()

    # ------------------------------------------------------------ watchdog

    def start(self):
        self._thread = threading.Thread(
            target=self._check_and_reassign_timeout_tasks,
            name="task-timeout-watchdog", daemon=True,
        )
        self._thread.start()

    def stop(self):
        self._should_stop = True

    def _check_and_reassign_timeout_tasks(self):
        """1s loop requeueing tasks stuck past the timeout
        (parity: task_manager.py:205)."""
        while not self._should_stop:
            with self._lock:
                for name, ds in list(self._datasets.items()):
                    doing = getattr(ds, "get_doing_tasks", lambda: {})()
                    now = time.time()
                    requeued = False
                    for task_id, dt in list(doing.items()):
                        if now - dt.start_time > self._task_timeout:
                            logger.warning(
                                "Task %s timed out on node %s; requeue",
                                task_id, dt.node_id,
                            )
                            ds.report_task_status(task_id, success=False)
                            requeued = True
                    if requeued:
                        self._persist_locked(name)
            time.sleep(1)

    # ----------------------------------------------------------- checkpoint

    def get_dataset_checkpoint(
        self, dataset_name: str
    ) -> Optional[DatasetShardCheckpoint]:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is None:
                return None
            ckpt = getattr(ds, "checkpoint", None)
            return ckpt() if ckpt else None

    def restore_dataset_from_checkpoint(self, content: str,
                                        keep_doing: bool = False) -> bool:
        """Restore one dataset's ledger from checkpoint JSON.

        ``keep_doing=True`` is the master-restart path: in-flight tasks
        stay in flight under their original ids/owners (exactly-once
        across the restart); the default requeues them (worker-driven
        restore, where workers restart too)."""
        try:
            checkpoint = DatasetShardCheckpoint.from_json(content)
            with self._lock:
                ds = self._datasets.get(checkpoint.dataset_name)
                if ds is None:
                    return False
                ds.restore_checkpoint(checkpoint, keep_doing=keep_doing)
                self._persist_locked(checkpoint.dataset_name)
            return True
        except Exception as e:
            logger.error("Failed to restore shard checkpoint: %s", e)
            return False

    def get_dataset_epoch(self, dataset_name: str) -> int:
        with self._lock:
            ds = self._datasets.get(dataset_name)
        return ds.get_epoch() if ds else 0
