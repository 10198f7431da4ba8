"""Allowed node status transitions (parity: master/node/status_flow.py:122).

The state machine gates which k8s/process events mutate master bookkeeping and
whether a transition should trigger a relaunch decision.

A copy of ``dlrover_tpu/master/node/status_flow.py``.
"""

from dataclasses import dataclass

from dlrover_tpu_torch.common.constants import NodeStatus

ALLOWED_TRANSITIONS = {
    NodeStatus.INITIAL: {
        NodeStatus.PENDING,
        NodeStatus.RUNNING,
        NodeStatus.SUCCEEDED,
        NodeStatus.FAILED,
        NodeStatus.DELETED,
    },
    NodeStatus.PENDING: {
        NodeStatus.RUNNING,
        NodeStatus.SUCCEEDED,
        NodeStatus.FAILED,
        NodeStatus.DELETED,
    },
    NodeStatus.RUNNING: {
        NodeStatus.SUCCEEDED,
        NodeStatus.FAILED,
        NodeStatus.DELETED,
        NodeStatus.BREAKDOWN,
    },
    NodeStatus.SUCCEEDED: {NodeStatus.DELETED},
    NodeStatus.FAILED: {NodeStatus.DELETED},
    NodeStatus.BREAKDOWN: {NodeStatus.DELETED, NodeStatus.FAILED},
    NodeStatus.DELETED: set(),
    NodeStatus.UNKNOWN: {
        NodeStatus.PENDING,
        NodeStatus.RUNNING,
        NodeStatus.SUCCEEDED,
        NodeStatus.FAILED,
        NodeStatus.DELETED,
    },
}

#: transitions after which the master must consider relaunching the node
RELAUNCH_TRIGGERS = {
    (NodeStatus.INITIAL, NodeStatus.FAILED),
    (NodeStatus.PENDING, NodeStatus.FAILED),
    (NodeStatus.RUNNING, NodeStatus.FAILED),
    (NodeStatus.INITIAL, NodeStatus.DELETED),
    (NodeStatus.PENDING, NodeStatus.DELETED),
    (NodeStatus.RUNNING, NodeStatus.DELETED),
}


@dataclass
class NodeStateFlow:
    from_status: str
    to_status: str
    should_relaunch: bool


def get_node_state_flow(from_status: str, event_type: str, to_status: str):
    """Return the NodeStateFlow for a transition, or None if disallowed."""
    if from_status == to_status:
        return None
    allowed = ALLOWED_TRANSITIONS.get(from_status, set())
    if to_status not in allowed:
        return None
    should_relaunch = (from_status, to_status) in RELAUNCH_TRIGGERS
    return NodeStateFlow(from_status, to_status, should_relaunch)
