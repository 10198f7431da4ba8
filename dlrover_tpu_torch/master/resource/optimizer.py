"""Resource plans + optimizer interface.

Parity reference: dlrover/python/master/resource/optimizer.py:48
(ResourcePlan), resource/job.py:171 (JobResourceOptimizer ABC).

A copy of ``dlrover_tpu/master/resource/optimizer.py``.
"""

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Dict, List

from dlrover_tpu_torch.common.node import NodeGroupResource


@dataclass
class ResourcePlan:
    """Target resources per node group, produced by an optimizer."""

    node_group_resources: Dict[str, NodeGroupResource] = field(
        default_factory=dict
    )
    comment: str = ""
    #: specific node ranks a shrink plan wants removed (stragglers)
    remove_ranks: List[int] = field(default_factory=list)
    #: throughput-grow plans set this to the proposed worker count so
    #: the scaler RAISES the job's target (a structured contract — the
    #: comment is for humans); 0 for every other plan kind
    grow_target: int = 0

    def empty(self) -> bool:
        return not self.node_group_resources


class ResourceOptimizer(ABC):
    """parity: resource/job.py:171 — produces ResourcePlans from runtime
    stats; the Brain-backed variant is a drop-in (brain/client)."""

    @abstractmethod
    def init_job_resource(self, job_resource) -> ResourcePlan:
        """Plan for job start."""

    @abstractmethod
    def generate_job_resource_plan(self) -> ResourcePlan:
        """Periodic plan from runtime metrics."""

    @abstractmethod
    def adjust_oom_resource(self, node) -> None:
        """Grow a node's memory request after an OOM kill."""
