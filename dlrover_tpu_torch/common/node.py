"""Node state model.

Parity reference: dlrover/python/common/node.py:36,118 (NodeResource, Node).
Re-shaped for TPU hosts: resources carry TPU-chip counts and host RAM, and the
"critical node" notion maps to hosts whose loss breaks the ICI slice.
"""

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from dlrover_tpu_torch.common.constants import NodeExitReason, NodeStatus


@dataclass
class NodeResource:
    """Requested/used resource of one node (host).

    cpu: cores; memory: MB; tpu_chips: chips attached to the host.
    """

    cpu: float = 0.0
    memory: int = 0
    tpu_chips: int = 0
    tpu_type: str = ""
    gpu_stats: list = field(default_factory=list)
    image: str = ""
    priority: str = ""

    def to_resource_dict(self) -> Dict:
        return {
            "cpu": self.cpu,
            "memory": self.memory,
            "tpu_chips": self.tpu_chips,
            "tpu_type": self.tpu_type,
        }

    @classmethod
    def resource_str_to_node_resource(cls, resource_str: str) -> "NodeResource":
        """Parse "cpu=4,memory=8192,tpu_chips=4" into a NodeResource."""
        res = cls()
        if not resource_str:
            return res
        for kv in resource_str.split(","):
            k, _, v = kv.partition("=")
            k = k.strip()
            if k == "cpu":
                res.cpu = float(v)
            elif k == "memory":
                res.memory = int(float(v))
            elif k == "tpu_chips":
                res.tpu_chips = int(v)
            elif k == "tpu_type":
                res.tpu_type = v.strip()
        return res


@dataclass
class NodeGroupResource:
    """Resource of a node group (count x per-node resource)."""

    count: int = 0
    node_resource: NodeResource = field(default_factory=NodeResource)

    def update(self, count: int = 0, cpu: float = 0, memory: int = 0):
        if count > 0:
            self.count = count
        if cpu > 0:
            self.node_resource.cpu = cpu
        if memory > 0:
            self.node_resource.memory = memory

    @classmethod
    def new_empty(cls) -> "NodeGroupResource":
        return cls(0, NodeResource())


class Node:
    """Bookkeeping for one job node (TPU host / master / coworker)."""

    def __init__(
        self,
        node_type: str,
        node_id: int,
        config_resource: Optional[NodeResource] = None,
        name: Optional[str] = None,
        status: str = NodeStatus.INITIAL,
        start_time: Optional[float] = None,
        rank_index: Optional[int] = None,
        relaunch_count: int = 0,
        critical: bool = False,
        max_relaunch_count: int = 3,
        relaunchable: bool = True,
        service_addr: Optional[str] = None,
    ):
        self.type = node_type
        self.id = node_id
        self.name = name or f"{node_type}-{node_id}"
        self.status = status
        self.start_time = start_time
        self.rank_index = rank_index if rank_index is not None else node_id
        self.relaunch_count = relaunch_count
        self.critical = critical
        self.max_relaunch_count = max_relaunch_count
        self.relaunchable = relaunchable
        self.service_addr = service_addr

        self.create_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.is_released = False
        self.exit_reason: str = ""
        self.config_resource = config_resource or NodeResource()
        self.used_resource = NodeResource()
        self.start_hang_time: float = 0.0
        self.init_time = time.time()
        self.host_name: Optional[str] = None
        self.host_ip: Optional[str] = None
        self.hang = False
        self.heartbeat_time: float = 0.0
        # the node announced its own preemption (drain step 1) before
        # dying: its relaunch must not charge the relaunch budget
        self.preempt_announced = False
        # the agent's self-reported WORKER-process restart count
        # (observability only — healthy membership-change restarts
        # increment it, so it must never feed the relaunch budget)
        self.worker_restart_count: int = 0

    def update_info(
        self,
        name=None,
        start_time=None,
        create_time=None,
        host_name=None,
        host_ip=None,
        restart_training=False,
        relaunch_count=0,
    ):
        if name is not None:
            self.name = name
        if start_time is not None:
            self.start_time = start_time
        if create_time is not None:
            self.create_time = create_time
        if host_name:
            self.host_name = host_name
        if host_ip:
            self.host_ip = host_ip
        self.relaunch_count = max(self.relaunch_count, relaunch_count)

    def update_status(self, status: Optional[str] = None):
        if status is not None:
            self.status = status

    def update_resource_usage(self, cpu: float, memory: int, gpu_stats=None):
        self.used_resource.cpu = round(cpu, 2)
        self.used_resource.memory = memory
        if gpu_stats:
            self.used_resource.gpu_stats = gpu_stats

    def update_service_address(self, addr: str):
        self.service_addr = addr

    def get_relaunch_node_info(self, new_id: int,
                               charge_budget: bool = True) -> "Node":
        """Clone this node for a relaunch with a fresh id. An announced
        preemption passes ``charge_budget=False``: the reclaim is the
        platform's doing, not the node's, so the relaunch budget stays
        intact."""
        new_node = Node(
            node_type=self.type,
            node_id=new_id,
            config_resource=self.config_resource,
            status=NodeStatus.INITIAL,
            rank_index=self.rank_index,
            relaunch_count=self.relaunch_count + (1 if charge_budget
                                                 else 0),
            critical=self.critical,
            max_relaunch_count=self.max_relaunch_count,
        )
        return new_node

    def is_unrecoverable_failure(self) -> bool:
        """Whether relaunching cannot help (parity: common/node.py:230)."""
        if self.relaunch_count >= self.max_relaunch_count:
            return True
        if self.exit_reason in NodeExitReason.UNRECOVERABLE:
            return True
        if (
            self.exit_reason == NodeExitReason.OOM
            and self.config_resource.memory >= 1024 * 1024  # 1TB: cannot grow
        ):
            return True
        return False

    def set_exit_reason(self, reason: str):
        self.exit_reason = reason

    def update_priority(self, group_node_num: int):
        """Priority "half" rule: first half high, rest low
        (parity: scaler/pod_scaler.py priority handling)."""
        if self.config_resource.priority == "half":
            if self.rank_index < group_node_num // 2:
                self.config_resource.priority = "high"
            else:
                self.config_resource.priority = "low"

    def timeout(self, timeout_s: float) -> bool:
        now = time.time()
        return (
            self.create_time is not None
            and now - self.create_time > timeout_s
            and self.status in (NodeStatus.INITIAL, NodeStatus.PENDING)
        )

    def __repr__(self):
        return (
            f"Node(type={self.type}, id={self.id}, rank={self.rank_index}, "
            f"status={self.status})"
        )

    def to_dict(self) -> Dict:
        d = dict(self.__dict__)
        d.pop("config_resource", None)
        d.pop("used_resource", None)
        return d
