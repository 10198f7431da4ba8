"""Per-role training node manager base.

Parity reference: dlrover/python/master/node/training_node.py:150
(TrainingNodeManager: scale up/down over the node dict, next-id
allocation) and the critical-node marking at :40-104 — on TPU, "critical"
means the host's chips belong to the active ICI slice, so its loss forces
a slice re-form.

Counterpart of ``dlrover_tpu/master/node/training_node.py``, with one
fault of the JAX package repaired: there ``add_node`` leaves the id
counter where it was, so a node the master learns of from its own
report (a worker started outside the scaler) has its id handed out
again by the next scale-up or relaunch, which then overwrites it in the
node table. Here ``add_node`` moves the counter past every id it holds
(ROADMAP.md, queue C).
"""

import threading
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import NodeStatus
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import Node


class TrainingNodeManager:
    def __init__(self, node_type: str,
                 nodes: Optional[Dict[int, Node]] = None):
        self._node_type = node_type
        self._nodes: Dict[int, Node] = nodes or {}
        self._lock = threading.Lock()
        self._next_id = max(self._nodes) + 1 if self._nodes else 0

    @property
    def nodes(self) -> Dict[int, Node]:
        with self._lock:
            return self._nodes

    def update_nodes(self, nodes: Dict[int, Node]):
        with self._lock:
            self._nodes = nodes
            self._next_id = max(nodes) + 1 if nodes else 0

    def next_node_id(self) -> int:
        with self._lock:
            return self._next_node_id_locked()

    def _next_node_id_locked(self) -> int:
        nid = self._next_id
        self._next_id += 1
        return nid

    def get_node(self, node_id: int) -> Optional[Node]:
        with self._lock:
            return self._nodes.get(node_id)

    def add_node(self, node: Node):
        with self._lock:
            self._nodes[node.id] = node
            # a node registered from outside (its own status report)
            # takes its id out of the pool
            self._next_id = max(self._next_id, node.id + 1)

    def running_nodes(self) -> List[Node]:
        # snapshot under the same lock add_node takes, so concurrent
        # relaunches can't mutate the dict mid-iteration
        with self._lock:
            return [
                n for n in self._nodes.values()
                if n.status == NodeStatus.RUNNING
            ]

    def alive_nodes(self) -> List[Node]:
        with self._lock:
            return [
                n for n in self._nodes.values()
                if n.status in (NodeStatus.PENDING, NodeStatus.RUNNING)
            ]

    def unfinished_nodes(self) -> List[Node]:
        """Alive PLUS in-flight (INITIAL) nodes — the provisioning diff
        base, so slow platform launches are not double-provisioned."""
        with self._lock:
            return [
                n for n in self._nodes.values()
                if not n.is_released and n.status in (
                    NodeStatus.INITIAL, NodeStatus.PENDING,
                    NodeStatus.RUNNING,
                )
            ]

    def all_nodes_exited(self) -> bool:
        """True only when every node has finished — unreleased INITIAL
        nodes (startup, relaunch-in-flight) count as unfinished, so the
        master does not fail a job before the platform reports the new
        node's status (parity: reference training_node.py:234-241)."""
        with self._lock:
            has_nodes = bool(self._nodes)
        return not self.unfinished_nodes() and has_nodes

    def scale_up_nodes(self, num: int, resource,
                       max_relaunch_count: Optional[int] = None
                       ) -> List[Node]:
        """Create bookkeeping entries for num new nodes; the scaler turns
        them into processes/VMs (parity: training_node.py:186)."""
        new_nodes = []
        with self._lock:
            for _ in range(num):
                nid = self._next_node_id_locked()
                kwargs = {}
                if max_relaunch_count is not None:
                    kwargs["max_relaunch_count"] = max_relaunch_count
                node = Node(
                    self._node_type, nid, config_resource=resource,
                    status=NodeStatus.INITIAL, **kwargs,
                )
                self._nodes[nid] = node
                new_nodes.append(node)
        logger.info(
            "Scale up %d %s nodes: %s", num, self._node_type,
            [n.id for n in new_nodes],
        )
        return new_nodes

    def scale_down_nodes(self, num: int) -> List[Node]:
        """Pick nodes to remove, newest first (parity:
        training_node.py:219)."""
        removed = []
        with self._lock:
            candidates = sorted(
                (n for n in self._nodes.values()
                 if n.status in (NodeStatus.INITIAL, NodeStatus.PENDING,
                                 NodeStatus.RUNNING)),
                key=lambda n: -n.id,
            )
            for node in candidates[:num]:
                node.is_released = True
                removed.append(node)
        logger.info(
            "Scale down %d %s nodes: %s", num, self._node_type,
            [n.id for n in removed],
        )
        return removed
