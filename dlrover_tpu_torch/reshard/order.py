"""TransitionOrder: the versioned wire format of a mesh transition.

One order describes one world-size change end to end: which ranks
survive, which were lost or joined, and the position each survivor
takes in the new world. Orders are broadcast over the master KV store
under :data:`TRANSITION_ORDER_KEY` and adopted exactly-once by id —
the same pattern the sentinel uses for rollback orders
(``sentinel/rollback_order``), so a re-broadcast or a late poll can
never double-apply a transition.

Encoding is plain JSON (the KV store carries bytes); unknown fields
are ignored on decode so the order can grow fields without breaking
mid-upgrade workers. See docs/ELASTICITY.md for the full wire
contract.

Counterpart of ``dlrover_tpu/reshard/order.py``, under the same names.
"""

import json
from dataclasses import asdict, dataclass, field
from typing import List, Optional

#: KV-store key the master broadcasts transition orders under; every
#: worker polls it on the step cadence (MeshTransition.poll_order)
TRANSITION_ORDER_KEY = "reshard/transition_order"

#: order kinds: a shrink drops ranks, a grow adds them, a promote
#: swaps a lost rank for a pre-warmed hot spare at constant world
#: size, an abort cancels a still-open transition and hands the
#: incident to the restart-the-world fallback
KIND_SHRINK = "shrink"
KIND_GROW = "grow"
KIND_PROMOTE = "promote"
KIND_ABORT = "abort"

#: KV-store prefix hot spares register under (``reshard/spare/<rank>``)
#: BEFORE reporting RUNNING, so the coordinator never grows them in —
#: they idle warm until a node loss promotes one
SPARE_KEY_PREFIX = "reshard/spare/"


@dataclass
class TransitionOrder:
    """One mesh transition, fully described.

    ``survivors`` lists the *old* ranks that continue, sorted; a
    survivor's new index is its position in that list, so the order
    itself IS the rank remap — no second message needed.
    """

    id: int = 0                # monotonically increasing per master
    kind: str = ""             # shrink | grow | abort
    step: int = 0              # detection step (0 when unknown)
    old_world_size: int = 0
    world_size: int = 0
    survivors: List[int] = field(default_factory=list)
    lost: List[int] = field(default_factory=list)
    joined: List[int] = field(default_factory=list)
    aborted_id: int = 0        # for KIND_ABORT: the order it cancels
    reason: str = ""
    #: traceparent ("trace_id-span_id") stamped at cut time so every
    #: rank's adoption span chains under the master's order_cut span;
    #: empty when tracing is off. Old decoders drop it.
    trace: str = ""

    def new_index(self, old_rank: int) -> Optional[int]:
        """The rank's position in the new world, or None when it is
        not part of it (it was lost, or this is an abort)."""
        try:
            return self.survivors.index(int(old_rank))
        except ValueError:
            return None

    def to_json(self) -> bytes:
        return json.dumps(asdict(self), sort_keys=True).encode()

    @classmethod
    def from_json(cls, raw) -> "TransitionOrder":
        if isinstance(raw, (bytes, bytearray)):
            raw = raw.decode()
        data = json.loads(raw)
        if not isinstance(data, dict):
            raise ValueError(f"transition order must be an object, "
                             f"got {type(data).__name__}")
        known = {f for f in cls.__dataclass_fields__}  # noqa: C416
        return cls(**{k: v for k, v in data.items() if k in known})
