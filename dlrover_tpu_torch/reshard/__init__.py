"""Reshard-in-place: online mesh transitions without restarting the
world.

A world-size change (node lost, node joined, quarantine eviction,
drain notice) becomes an in-process state migration instead of a
restart:

* master side — :class:`~dlrover_tpu_torch.reshard.coordinator.
  TransitionCoordinator` detects the change, computes the new world,
  and broadcasts a versioned :class:`~dlrover_tpu_torch.reshard.order.
  TransitionOrder` over the KV store.
* worker side — :class:`~dlrover_tpu_torch.reshard.transition.
  MeshTransition` adopts the order exactly-once and executes it at
  the next step boundary; :mod:`~dlrover_tpu_torch.reshard.migrate` moves
  the state (a copy on the device for held boxes, digest-verified
  peer/store fetch for lost ones).

docs/ELASTICITY.md has the state machine, the wire format and the
abort → restart-the-world fallback contract.

Counterpart of ``dlrover_tpu/reshard/__init__.py``, under the same names.
"""

from dlrover_tpu_torch.reshard.coordinator import (  # noqa: F401
    TransitionCoordinator,
    reshard_enabled,
    reshard_opted_in,
)
from dlrover_tpu_torch.reshard.order import (  # noqa: F401
    KIND_ABORT,
    KIND_GROW,
    KIND_PROMOTE,
    KIND_SHRINK,
    SPARE_KEY_PREFIX,
    TRANSITION_ORDER_KEY,
    TransitionOrder,
)
from dlrover_tpu_torch.reshard.spare import (  # noqa: F401
    HotSpare,
    PrewarmedSource,
)
from dlrover_tpu_torch.reshard.transition import MeshTransition  # noqa: F401

__all__ = [
    "TransitionCoordinator",
    "TransitionOrder",
    "MeshTransition",
    "HotSpare",
    "PrewarmedSource",
    "TRANSITION_ORDER_KEY",
    "SPARE_KEY_PREFIX",
    "KIND_SHRINK",
    "KIND_GROW",
    "KIND_PROMOTE",
    "KIND_ABORT",
    "reshard_enabled",
    "reshard_opted_in",
]
