"""Job manager for local (single-host / standalone) mode.

Parity reference: dlrover/python/master/node/local_job_manager.py:27 — pure
bookkeeping, no pod mutation; failures of the single host end the job.
"""

import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import NodeAction, NodeStatus, NodeType
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import Node


class LocalJobManager:
    """Tracks nodes of a standalone job in-memory."""

    def __init__(self, job_args=None, speed_monitor=None):
        self._job_args = job_args
        self._speed_monitor = speed_monitor
        self._job_nodes: Dict[str, Dict[int, Node]] = {
            NodeType.WORKER: {}
        }
        self._pending_actions: Dict[tuple, str] = {}

    def start(self):
        num_workers = 1
        if self._job_args is not None:
            num_workers = getattr(self._job_args, "node_num", 1)
        for i in range(num_workers):
            self._job_nodes[NodeType.WORKER][i] = Node(
                NodeType.WORKER, i, status=NodeStatus.RUNNING,
            )

    def stop(self):
        pass

    def add_node(self, node_type: str, node_id: int):
        self._job_nodes.setdefault(node_type, {})[node_id] = Node(
            node_type, node_id, status=NodeStatus.RUNNING
        )

    def get_node(self, node_type: str, node_id: int) -> Optional[Node]:
        return self._job_nodes.get(node_type, {}).get(node_id)

    def get_all_nodes(self) -> List[Node]:
        return [
            n for group in self._job_nodes.values() for n in group.values()
        ]

    def get_running_nodes(self) -> List[Node]:
        return [
            n for n in self.get_all_nodes()
            if n.status == NodeStatus.RUNNING
        ]

    def get_running_workers(self) -> List[Node]:
        return [
            n for n in self._job_nodes.get(NodeType.WORKER, {}).values()
            if n.status == NodeStatus.RUNNING
        ]

    def update_node_status(self, node_type: str, node_id: int, status: str,
                           exit_reason: str = "", restart_count: int = 0):
        node = self.get_node(node_type, node_id)
        if node is None:
            self.add_node(node_type, node_id)
            node = self.get_node(node_type, node_id)
        node.update_status(status)
        if exit_reason:
            node.set_exit_reason(exit_reason)
        if self._speed_monitor is not None:
            if status == NodeStatus.RUNNING:
                self._speed_monitor.add_running_worker(node_type, node_id)
            elif status in NodeStatus.terminal():
                self._speed_monitor.remove_running_worker(
                    node_type, node_id
                )

    def update_node_service_addr(self, node_type: str, node_id: int,
                                 address: str):
        node = self.get_node(node_type, node_id)
        if node:
            node.update_service_address(address)

    def update_node_resource_usage(self, node_type: str, node_id: int,
                                   cpu_percent: float, memory_mb: int,
                                   tpu_stats=None):
        node = self.get_node(node_type, node_id)
        if node:
            node.update_resource_usage(cpu_percent, memory_mb, tpu_stats)

    def collect_node_heartbeat(self, node_type: str, node_id: int,
                               timestamp: float) -> str:
        node = self.get_node(node_type, node_id)
        if node is None:
            self.add_node(node_type, node_id)
            node = self.get_node(node_type, node_id)
        node.heartbeat_time = timestamp
        action = self._pending_actions.pop((node_type, node_id), "")
        if action:
            node.hang = False
        return action

    def handle_training_hang(self, node_type: str, node_id: int,
                             message: str = ""):
        """Same restart-over-heartbeat contract as the distributed
        manager (dist_job_manager.handle_training_hang)."""
        node = self.get_node(node_type, node_id)
        logger.warning(
            "Training hang reported by %s-%s (%s) -> restart action",
            node_type, node_id, message,
        )
        if node is not None:
            node.hang = True
        self._pending_actions[(node_type, node_id)] = (
            NodeAction.RESTART_WORKER
        )

    def all_workers_exited(self) -> bool:
        workers = self._job_nodes.get(NodeType.WORKER, {})
        return bool(workers) and all(
            n.status in NodeStatus.terminal() for n in workers.values()
        )

    def all_workers_failed(self) -> bool:
        workers = self._job_nodes.get(NodeType.WORKER, {})
        return bool(workers) and all(
            n.status == NodeStatus.FAILED for n in workers.values()
        )
