"""ScalePlan + Scaler interface.

Parity reference: dlrover/python/master/scaler/base_scaler.py:21,49
(ScalePlan with launch/remove node lists, Scaler ABC).

A copy of ``dlrover_tpu/master/scaler/base_scaler.py``.
"""

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Dict, List

from dlrover_tpu_torch.common.node import Node, NodeGroupResource


@dataclass
class ScalePlan:
    """What the cluster should look like after scaling.

    node_group_resources: target count+resource per node type.
    launch_nodes / remove_nodes: explicit node mutations.
    """

    node_group_resources: Dict[str, NodeGroupResource] = field(
        default_factory=dict
    )
    launch_nodes: List[Node] = field(default_factory=list)
    remove_nodes: List[Node] = field(default_factory=list)

    def empty(self) -> bool:
        return not (
            self.node_group_resources
            or self.launch_nodes
            or self.remove_nodes
        )

    def merge(self, other: "ScalePlan") -> None:
        self.node_group_resources.update(other.node_group_resources)
        self.launch_nodes.extend(other.launch_nodes)
        self.remove_nodes.extend(other.remove_nodes)


class Scaler(ABC):
    """Turns ScalePlans into platform mutations (processes / TPU VMs /
    pods). Parity: base_scaler.py:49."""

    def __init__(self, job_name: str):
        self._job_name = job_name

    @abstractmethod
    def scale(self, plan: ScalePlan) -> None:
        """Apply the plan."""

    def supports_role(self, node_type: str) -> bool:
        """Whether this platform can launch ``node_type`` nodes with
        the right workload. Default: workers only — side-job roles
        (evaluator) need a per-role command/entrypoint the platform
        must explicitly support, or they would silently launch the
        training workload under the wrong role."""
        from dlrover_tpu_torch.common.constants import NodeType

        return node_type == NodeType.WORKER

    def add_avoid_hosts(self, hosts: List[str]) -> None:
        """MERGE ``hosts`` into the platform's placement blacklist
        (quarantined repeat offenders join the Brain's list, never
        replace it). Default: no placement control — platforms that
        allocate fresh machines from a fleet API have nothing to avoid."""

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass
