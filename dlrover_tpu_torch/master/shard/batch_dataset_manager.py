"""Batch (bounded) dataset manager.

Parity reference: dlrover/python/master/shard/batch_dataset_manager.py:29
(get_task:52, report_task_status, checkpoint:157).
"""

import time
from typing import Optional

from dlrover_tpu_torch.common.constants import NodeType, TaskType
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.shard.base_dataset_manager import (
    DatasetManger,
    DatasetShardCheckpoint,
    DoingTask,
    Task,
)
from dlrover_tpu_torch.master.shard.dataset_splitter import DatasetSplitter, Shard


class BatchDatasetManager(DatasetManger):
    """Dispatches row-range shards of a bounded dataset as tasks."""

    def __init__(self, task_type: str, batch_size: int,
                 dataset_splitter: DatasetSplitter):
        super().__init__(task_type, batch_size, dataset_splitter)
        self._max_task_completed_time = 0.0
        self._task_id = 0
        self._completed_step = 0

    def get_task(self, node_type: str, node_id: int,
                 incarnation: int = -1) -> Task:
        """Pop a todo task; refill from the splitter when drained."""
        self.reclaim_stale_incarnation(node_id, incarnation)
        if not self.todo and not self._dataset_splitter.epoch_finished():
            shards = self._dataset_splitter.create_shards()
            if shards:
                self._create_todo_tasks()
        if not self.todo:
            if self.pending_for_others(node_id):
                # drained, but a PEER's in-flight shards can still be
                # requeued (death, timeout): wait for the re-delivery
                # — the asker's own unreported tail is its own to
                # finish, so it gets end-of-queue, not a self-deadlock
                return Task.create_wait_task()
            # dataset exhausted (or only the asker's tail remains)
            return Task.create_invalid_task()
        task = self.todo.pop(0)
        self.doing[task.task_id] = DoingTask(
            task, node_id, time.time(), incarnation
        )
        logger.debug(
            "Assign task %s of dataset %s to %s-%s",
            task.task_id, self._dataset_splitter.dataset_name, node_type,
            node_id,
        )
        return task

    def _create_todo_tasks(self):
        for shard in self._dataset_splitter.get_shards():
            self.todo.append(Task(self._task_id, self._task_type, shard))
            self._task_id += 1

    def report_task_status(self, task_id: int, success: bool):
        doing_task = self.doing.pop(task_id, None)
        if doing_task is None:
            logger.warning("Unknown task %s reported", task_id)
            return False, None
        if not success:
            logger.warning(
                "Task %s failed on node %s; requeue",
                task_id, doing_task.node_id,
            )
            self.recover_task(doing_task.task)
            return False, doing_task
        elapsed = time.time() - doing_task.start_time
        self._max_task_completed_time = max(
            self._max_task_completed_time, elapsed
        )
        task = doing_task.task
        if task.task_type == TaskType.TRAINING:
            batchs = (task.shard.end - task.shard.start) // max(
                1, self._batch_size
            )
            self._completed_step += max(1, batchs)
        return True, doing_task

    def recover_task(self, task: Task):
        if not self._check_exceed_max_retry(task):
            self.todo.insert(0, task)

    def _check_exceed_max_retry(self, task: Task, max_retry: int = 3) -> bool:
        task.retry_count += 1
        if task.retry_count > max_retry:
            logger.error(
                "Drop task %s after %d retries", task.task_id,
                task.retry_count,
            )
            return True
        return False

    def recover_tasks_of_node(self, node_id: int):
        """Requeue all doing tasks of a dead node
        (parity: task re-assignment on node failure)."""
        ids = [
            tid for tid, dt in self.doing.items() if dt.node_id == node_id
        ]
        for tid in ids:
            doing_task = self.doing.pop(tid)
            self.recover_task(doing_task.task)
        return ids

    def completed(self) -> bool:
        return (
            not self.todo
            and not self.doing
            and self._dataset_splitter.epoch_finished()
        )

    def get_completed_step(self) -> int:
        return self._completed_step

    # ------------------------------------------------------------ checkpoint

    def checkpoint(self) -> DatasetShardCheckpoint:
        """Snapshot todo+doing shard ranges (parity:
        batch_dataset_manager.py:157), plus the task-id/owner detail a
        restarted master needs for an exactly-once resume."""
        todo = []
        todo_ids = []
        for task in self.todo:
            todo.append([task.shard.start, task.shard.end])
            todo_ids.append(task.task_id)
        doing = []
        doing_detail = []
        for doing_task in self.doing.values():
            doing.append(
                [doing_task.task.shard.start, doing_task.task.shard.end]
            )
            doing_detail.append([
                doing_task.task.task_id,
                doing_task.node_id,
                doing_task.task.shard.start,
                doing_task.task.shard.end,
                doing_task.incarnation,
            ])
        return DatasetShardCheckpoint(
            dataset_name=self._dataset_splitter.dataset_name,
            todo=todo,
            doing=doing,
            epoch=self._dataset_splitter.get_epoch(),
            splitter_epoch=self._dataset_splitter.get_epoch(),
            todo_ids=todo_ids,
            doing_detail=doing_detail,
            next_task_id=self._task_id,
            completed_step=self._completed_step,
        )

    def restore_checkpoint(self, checkpoint: DatasetShardCheckpoint,
                           keep_doing: bool = False):
        """Rebuild the task queues from a checkpoint.

        Default (worker-driven restore, the historical RPC path): doing
        shards are REQUEUED into todo with fresh ids — correct when the
        workers restart along with their progress.

        ``keep_doing=True`` (master restart behind live workers): the
        doing set is restored in place with its ORIGINAL task ids and
        owners, so a surviving worker's completion report for a shard it
        fetched before the crash is accepted instead of the shard being
        re-dispatched to someone else (duplicate consumption). Requires
        the detail fields; checkpoints without them fall back to the
        requeue path. start_time restarts at now — the task-timeout
        watchdog still reclaims shards whose owner died with the master.
        """
        self._dataset_splitter.set_epoch(checkpoint.epoch)
        self.todo = []
        self.doing = {}
        name = self._dataset_splitter.dataset_name
        if keep_doing and checkpoint.doing_detail is not None:
            self._task_id = max(self._task_id, checkpoint.next_task_id)
            self._completed_step = checkpoint.completed_step
            now = time.time()
            for task_id, node_id, start, end, incarnation in (
                    checkpoint.doing_detail):
                self.doing[task_id] = DoingTask(
                    Task(task_id, self._task_type, Shard(name, start, end)),
                    node_id, now, incarnation,
                )
            todo_ids = checkpoint.todo_ids or []
            for i, (start, end) in enumerate(checkpoint.todo):
                if i < len(todo_ids):
                    task_id = todo_ids[i]
                else:
                    task_id = self._task_id
                    self._task_id += 1
                self.todo.append(
                    Task(task_id, self._task_type, Shard(name, start, end))
                )
            return
        for start, end in checkpoint.doing + checkpoint.todo:
            self.todo.append(
                Task(self._task_id, self._task_type, Shard(name, start, end))
            )
            self._task_id += 1

    def get_doing_tasks(self):
        return self.doing
