"""Dataset manager base types: Task, DoingTask, shard checkpoint.

Parity reference: dlrover/python/master/shard/base_dataset_manager.py:22,43,60.
"""

import json
import time
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import TaskType
from dlrover_tpu_torch.master.shard.dataset_splitter import DatasetSplitter, Shard


class Task:
    """A data-shard task assigned to one worker."""

    def __init__(self, task_id: int, task_type: str, shard: Shard):
        self.task_id = task_id
        self.task_type = task_type
        self.shard = shard
        self.retry_count = 0

    @classmethod
    def create_invalid_task(cls) -> "Task":
        return cls(-1, TaskType.NONE, Shard("", -1, -1))

    @classmethod
    def create_wait_task(cls) -> "Task":
        """Queue drained but the dataset is NOT complete (in-flight
        shards may still be requeued; a stream may produce more): the
        worker must poll, not exit — exiting here loses the re-delivery
        of an orphaned shard (parity: the reference's wait semantics)."""
        return cls(-1, TaskType.WAIT, Shard("", -1, -1))


@dataclass
class DoingTask:
    """An in-flight task: which worker holds it and since when."""

    task: Task
    node_id: int
    start_time: float
    #: worker-process incarnation the task was issued to (-1 unknown)
    incarnation: int = -1


class DatasetShardCheckpoint:
    """JSON-serializable shard progress of one dataset
    (parity: base_dataset_manager.py:60).

    The base fields (``todo``/``doing`` as bare ``[start, end]`` ranges)
    are the worker-facing checkpoint contract and stay unchanged. The
    optional detail fields carry what a RESTARTED MASTER needs to resume
    without double-dispatching in-flight shards: the original task ids,
    owners and incarnations of the doing set (see
    ``BatchDatasetManager.restore_checkpoint(keep_doing=True)``). Old
    checkpoints without them still load — ``from_json`` defaults apply.
    """

    def __init__(self, dataset_name: str, todo: List[List[int]],
                 doing: List[List[int]], epoch: int,
                 splitter_epoch: int = 0,
                 todo_ids: Optional[List[int]] = None,
                 doing_detail: Optional[List[List[int]]] = None,
                 next_task_id: int = 0,
                 completed_step: int = 0):
        self.dataset_name = dataset_name
        self.todo = todo  # [[start, end], ...]
        self.doing = doing
        self.epoch = epoch
        self.splitter_epoch = splitter_epoch
        #: task ids parallel to ``todo`` (master-restart detail)
        self.todo_ids = todo_ids
        #: [[task_id, node_id, start, end, incarnation], ...]
        self.doing_detail = doing_detail
        #: next unissued task id — restoring it keeps ids unique across
        #: a master restart (a reused id would collide with in-flight ones)
        self.next_task_id = next_task_id
        self.completed_step = completed_step

    def to_json(self) -> str:
        return json.dumps(self.__dict__)

    @classmethod
    def from_json(cls, content: str) -> "DatasetShardCheckpoint":
        d = json.loads(content)
        return cls(
            dataset_name=d["dataset_name"],
            todo=d.get("todo", []),
            doing=d.get("doing", []),
            epoch=d.get("epoch", 0),
            splitter_epoch=d.get("splitter_epoch", 0),
            todo_ids=d.get("todo_ids"),
            doing_detail=d.get("doing_detail"),
            next_task_id=d.get("next_task_id", 0),
            completed_step=d.get("completed_step", 0),
        )


class DatasetManger(ABC):
    """Manages todo/doing task queues of one dataset."""

    def __init__(self, task_type: str, batch_size: int,
                 dataset_splitter: DatasetSplitter):
        self.todo: List[Task] = []
        self.doing: Dict[int, DoingTask] = {}
        self._task_type = task_type
        self._batch_size = batch_size
        self._dataset_splitter = dataset_splitter
        self._start_time = time.time()

    @abstractmethod
    def get_task(self, node_type: str, node_id: int) -> Task:
        ...

    @abstractmethod
    def report_task_status(self, task_id: int, success: bool):
        ...

    @abstractmethod
    def completed(self) -> bool:
        ...

    @abstractmethod
    def recover_task(self, task: Task):
        ...

    def get_epoch(self) -> int:
        return self._dataset_splitter.get_epoch()

    def reclaim_stale_incarnation(self, node_id: int,
                                  incarnation: int) -> List[int]:
        """A fetch from incarnation k of a node proves its older
        incarnations are dead: requeue their in-flight shards NOW — a
        restarted worker resumes at the right offset without waiting
        out the task timeout. No-op for unknown incarnations."""
        if incarnation < 0:
            return []
        stale = [
            tid for tid, dt in self.doing.items()
            if dt.node_id == node_id
            and 0 <= dt.incarnation < incarnation
        ]
        for tid in stale:
            self.recover_task(self.doing.pop(tid).task)
        return stale

    def pending_for_others(self, node_id: int) -> bool:
        """In-flight work owned by OTHER nodes (whose death/requeue the
        asker should WAIT for; the asker's own current-incarnation tail
        is its own to report)."""
        return any(
            dt.node_id != node_id for dt in self.doing.values()
        )

    def reset(self):
        self.todo = []
        self.doing = {}
        self._dataset_splitter.set_epoch(0)
