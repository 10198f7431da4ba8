"""Streaming (unbounded) dataset manager.

Parity reference: dlrover/python/master/shard/streaming_dataset_manager.py:32.
"""

import time

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.shard.base_dataset_manager import (
    DatasetManger,
    DatasetShardCheckpoint,
    DoingTask,
    Task,
)
from dlrover_tpu_torch.master.shard.dataset_splitter import StreamingDatasetSplitter


class StreamingDatasetManager(DatasetManger):
    """Dispatches stream partition-offset shards as tasks."""

    def __init__(self, task_type: str, batch_size: int,
                 dataset_splitter: StreamingDatasetSplitter):
        super().__init__(task_type, batch_size, dataset_splitter)
        self._task_id = 0

    def get_task(self, node_type: str, node_id: int,
                 incarnation: int = -1) -> Task:
        self.reclaim_stale_incarnation(node_id, incarnation)
        if not self.todo:
            if self._dataset_splitter.create_shards():
                self._create_todo_tasks()
        if not self.todo:
            if self.pending_for_others(node_id):
                # the stream is drained but a PEER's shards are in
                # flight: their orphaned ranges may requeue any moment
                return Task.create_wait_task()
            return Task.create_invalid_task()
        task = self.todo.pop(0)
        self.doing[task.task_id] = DoingTask(
            task, node_id, time.time(), incarnation
        )
        return task

    def _create_todo_tasks(self):
        for shard in self._dataset_splitter.get_shards():
            self.todo.append(Task(self._task_id, self._task_type, shard))
            self._task_id += 1

    def report_task_status(self, task_id: int, success: bool):
        doing_task = self.doing.pop(task_id, None)
        if doing_task is None:
            logger.warning("Unknown streaming task %s", task_id)
            return False, None
        if not success:
            self.recover_task(doing_task.task)
            return False, doing_task
        return True, doing_task

    def recover_task(self, task: Task):
        self.todo.insert(0, task)

    def recover_tasks_of_node(self, node_id: int):
        ids = [
            tid for tid, dt in self.doing.items() if dt.node_id == node_id
        ]
        for tid in ids:
            self.recover_task(self.doing.pop(tid).task)
        return ids

    def completed(self) -> bool:
        return (
            not self.todo
            and not self.doing
            and self._dataset_splitter.epoch_finished()
        )

    def checkpoint(self) -> DatasetShardCheckpoint:
        todo = [[t.shard.start, t.shard.end] for t in self.todo]
        doing = [
            [dt.task.shard.start, dt.task.shard.end]
            for dt in self.doing.values()
        ]
        return DatasetShardCheckpoint(
            dataset_name=self._dataset_splitter.dataset_name,
            todo=todo,
            doing=doing,
            epoch=self._dataset_splitter.get_epoch(),
        )

    def restore_checkpoint(self, checkpoint: DatasetShardCheckpoint,
                           keep_doing: bool = False):
        # streaming checkpoints carry no task-id detail: keep_doing has
        # nothing to keep, so a master restart requeues in-flight offsets
        from dlrover_tpu_torch.master.shard.dataset_splitter import Shard

        self.todo = []
        self.doing = {}
        name = self._dataset_splitter.dataset_name
        for start, end in checkpoint.doing + checkpoint.todo:
            self.todo.append(
                Task(self._task_id, self._task_type, Shard(name, start, end))
            )
            self._task_id += 1

    def get_doing_tasks(self):
        return self.doing
