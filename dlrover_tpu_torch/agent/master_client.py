"""The worker's client of the master, in process.

Counterpart of ``dlrover_tpu/agent/master_client.py``, of which the port
has so far the masterless half: :class:`LocalMasterClient` serves the
sharding protocol from a :class:`~dlrover_tpu_torch.master.shard.
task_manager.TaskManager` in the same process, and
:func:`build_master_client` / :func:`get_master_client` hand it out.
The gRPC ``MasterClient`` (reconnect supervision, relay failover) comes
with the launcher slice (ROADMAP.md, queue A): until then a master
address raises instead of falling back to the local client, which would
give each worker a dataset of its own. The agent's calls (kv store,
heartbeats, node status, shard relinquish) come with it, and the request
plane of serving (``serve_*``) with the serving slice.
"""

import os
from typing import List, Optional

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import NodeEnv, TaskType
from dlrover_tpu_torch.master.shard.dataset_splitter import (
    new_dataset_splitter,
)
from dlrover_tpu_torch.master.shard.task_manager import TaskManager
from dlrover_tpu_torch.telemetry import tracing

#: where the remote client stands in ROADMAP.md
_REMOTE_NOT_PORTED = (
    "the gRPC MasterClient is not ported yet (ROADMAP.md, queue A, "
    "'the launcher slice'); unset {env} to serve the dataset in process"
)


def _as_comm_task(task) -> comm.Task:
    return comm.Task(
        task_id=task.task_id, task_type=task.task_type,
        shard=comm.Shard(
            name=task.shard.name, start=task.shard.start,
            end=task.shard.end, record_indices=task.shard.record_indices,
        ),
    )


class LocalMasterClient:
    """Masterless client serving the sharding protocol in process
    (parity: ``dlrover_tpu/agent/master_client.py:893``)."""

    def __init__(self, node_id: int = 0, node_type: str = "worker"):
        self._node_id = node_id
        self._node_type = node_type
        self._task_manager = TaskManager()

    def report_dataset_shard_params(self, batch_size, num_epochs,
                                    dataset_size, shuffle,
                                    num_minibatches_per_shard, dataset_name,
                                    task_type=TaskType.TRAINING,
                                    storage_type="table"):
        splitter = new_dataset_splitter(
            shuffle=shuffle,
            shard_size=batch_size * num_minibatches_per_shard,
            dataset_size=dataset_size, num_epochs=num_epochs,
            dataset_name=dataset_name, storage_type=storage_type,
        )
        self._task_manager.new_dataset(
            batch_size, dataset_size, dataset_name, splitter, task_type
        )

    # the rpc.* spans mirror the remote servicer's, so a trace reads the
    # same whether the master is local or remote
    def get_task(self, dataset_name: str,
                 incarnation: int = -1) -> comm.Task:
        with tracing.span("rpc.get_task"):
            task = self._task_manager.get_dataset_task(
                self._node_type, self._node_id, dataset_name,
                incarnation=incarnation,
            )
        return _as_comm_task(task)

    def get_tasks(self, dataset_name: str, max_tasks: int = 1,
                  incarnation: int = -1) -> List[comm.Task]:
        with tracing.span("rpc.get_tasks"):
            tasks = self._task_manager.get_dataset_tasks(
                self._node_type, self._node_id, dataset_name,
                max_tasks=max_tasks, incarnation=incarnation,
            )
        return [_as_comm_task(t) for t in tasks]

    def report_task_result(self, dataset_name, task_id, err_message=""):
        with tracing.span("rpc.report_task_result"):
            accepted = self._task_manager.report_dataset_task(
                dataset_name, task_id, not err_message
            )
        return comm.Response(success=bool(accepted))

    def get_dataset_epoch(self, dataset_name: str) -> int:
        return self._task_manager.get_dataset_epoch(dataset_name)

    def get_shard_checkpoint(self, dataset_name: str) -> str:
        ckpt = self._task_manager.get_dataset_checkpoint(dataset_name)
        return ckpt.to_json() if ckpt else ""

    def report_shard_checkpoint(self, content: str) -> bool:
        """Restore the dataset's shard ledger; False when the checkpoint
        was refused (the JAX client returns nothing)."""
        return self._task_manager.restore_dataset_from_checkpoint(content)

    def report_global_step(self, step, timestamp=None):
        pass


_master_client = None


def build_master_client(master_addr: Optional[str] = None,
                        node_id: Optional[int] = None,
                        node_type: Optional[str] = None):
    """Build the (cached) master client from args or env. With no master
    address this is the in-process :class:`LocalMasterClient`; a master
    address raises ``NotImplementedError`` until the gRPC client is
    ported."""
    global _master_client
    master_addr = master_addr or os.getenv(NodeEnv.MASTER_ADDR, "")
    if master_addr:
        raise NotImplementedError(
            _REMOTE_NOT_PORTED.format(env=NodeEnv.MASTER_ADDR)
            + f" (master address {master_addr!r})"
        )
    if node_id is None:
        node_id = int(os.getenv(NodeEnv.NODE_ID, "0"))
    if node_type is None:
        node_type = os.getenv(NodeEnv.NODE_TYPE, "worker")
    _master_client = LocalMasterClient(node_id, node_type)
    return _master_client


def get_master_client():
    global _master_client
    if _master_client is None:
        _master_client = build_master_client()
    return _master_client
