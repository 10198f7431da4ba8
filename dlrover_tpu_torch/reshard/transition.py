"""MeshTransition: worker-side executor of transition orders.

The survivor's half of reshard-in-place. The trainer polls the KV
store on the step cadence (``ElasticTrainer.report_step`` does it for
free once a transition is attached); a broadcast
:class:`~dlrover_tpu_torch.reshard.order.TransitionOrder` is adopted
exactly-once by id — the sentinel's rollback-order pattern — and
parked until the next step boundary, where the step loop executes it
without process exit:

1. ``pop_pending()`` — take the order at a clean boundary.
2. re-form the collective world among survivors (a new process group
   of the shrunken/augmented membership) and rebuild the mesh's groups
   for the new world (``ElasticTrainer.execute_reshard``).
3. migrate state (:mod:`dlrover_tpu_torch.reshard.migrate`): boxes this
   rank holds are served from its live tensors and copied on the
   device; boxes whose holders died are assembled from peers' RAM tier
   or the store, digest-verified — then ``note_migrated()`` books the
   per-source move counts.
4. re-arm the data plane and report ``completed`` so the master can
   close the transition.

Every phase report rides the supervised ``report_reshard`` RPC; a
``stale``/``abort`` answer (or an adopted ``kind=abort`` broadcast)
flips :attr:`fallback` and the worker takes the restart-the-world
path it always had.

Counterpart of ``dlrover_tpu/reshard/transition.py``, under the same names.
"""

import os
import time
from typing import Dict, Optional

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.reshard.order import (
    KIND_ABORT,
    TRANSITION_ORDER_KEY,
    TransitionOrder,
)
from dlrover_tpu_torch.telemetry import counter, record, tracing


def _moves_counter():
    return counter(
        "dlrover_reshard_shard_moves_total",
        "Shards moved during mesh transitions, by source tier",
        ["source"],
    )


class MeshTransition:
    """Order plumbing + transition bookkeeping for one rank."""

    def __init__(self, master_client=None, node_rank: int = 0):
        self._client = master_client
        self._node_rank = int(node_rank)
        #: highest order id already acted on (orders are re-read from
        #: KV every poll; the id makes adoption exactly-once)
        self._seen_order_id = 0
        self._pending: Optional[TransitionOrder] = None
        self._adopted_at = 0.0
        #: this rank must fall back to the restart-the-world path (an
        #: abort was adopted, or the master called our report stale)
        self._fallback = False
        #: this rank is not part of the new world (a drain-notice
        #: shrink can reach a still-alive rank): finish up and exit
        self._excluded = False

    @classmethod
    def from_env(cls, master_client=None) -> Optional["MeshTransition"]:
        """Build from the process env; None when disabled."""
        if os.environ.get("DLROVER_TPU_RESHARD", "1") in ("0", "off"):
            return None
        return cls(
            master_client=master_client,
            node_rank=int(os.environ.get(NodeEnv.NODE_RANK, "0")),
        )

    # ---------------------------------------------------------------- state

    @property
    def node_rank(self) -> int:
        return self._node_rank

    @property
    def fallback(self) -> bool:
        return self._fallback

    @property
    def excluded(self) -> bool:
        return self._excluded

    def pending(self) -> Optional[TransitionOrder]:
        return self._pending

    def pop_pending(self) -> Optional[TransitionOrder]:
        """Take the parked order at a step boundary (clears it)."""
        order, self._pending = self._pending, None
        return order

    # -------------------------------------------------------------- polling

    def poll_order(self) -> Optional[TransitionOrder]:
        """Check the master KV store for a transition order (the step
        cadence poll; errors never take training down)."""
        if self._client is None:
            return self._pending
        try:
            raw = self._client.kv_store_get(TRANSITION_ORDER_KEY)
        except Exception as e:
            logger.warning("transition-order poll failed: %s", e)
            return self._pending
        if raw:
            try:
                self._adopt(TransitionOrder.from_json(raw))
            except (ValueError, TypeError, KeyError) as e:
                logger.warning("bad transition order %r: %s", raw, e)
        return self._pending

    def _adopt(self, order: TransitionOrder) -> None:
        if order.id <= self._seen_order_id:
            return
        prev_seen = self._seen_order_id
        self._seen_order_id = order.id
        if order.kind == KIND_ABORT:
            if prev_seen < order.aborted_id:
                # this incarnation never saw the aborted order (a
                # relaunched process reading a stale broadcast): the
                # abort is not addressed to it — falling back here
                # would loop relaunches forever
                return
            if (self._pending is not None
                    and order.aborted_id == self._pending.id):
                self._pending = None
            # the abort closes the reshard window on this ledger and
            # opens restart (EVENT_RULES) — the fallback path's cost
            record(
                "reshard.aborted", order_id=order.aborted_id,
                reason=order.reason, node_rank=self._node_rank,
            )
            self._fallback = True
            return
        new_index = order.new_index(self._node_rank)
        if new_index is None:
            # not in the new world: this rank is the one being shed
            self._excluded = True
            logger.info(
                "transition order %d excludes rank %d: standing down",
                order.id, self._node_rank,
            )
            return
        # the newest order defines membership: a latecomer can read a
        # stale broadcast cut before it existed (which excluded it)
        # and then be grown in by the next order
        self._excluded = False
        self._pending = order
        self._adopted_at = time.time()
        # adopt under the order's carried trace context: cut ->
        # broadcast -> per-rank adoption reads as ONE chain in
        # `dump --trace` even though it crossed the KV store
        with tracing.trace_context(
            *tracing.parse_traceparent(order.trace)
        ), tracing.span("reshard.adopt", {
            "order": order.id, "rank": self._node_rank,
        }):
            record(
                "reshard.adopted", order_id=order.id,
                order_kind=order.kind,
                new_index=new_index, world_size=order.world_size,
                node_rank=self._node_rank,
            )

    # ------------------------------------------------------------ agreement

    def agree_step(self, order: TransitionOrder, compute_fn,
                   poll: float = 0.2, timeout: float = 30.0) -> int:
        """Pin the restore step for ``order`` across every survivor.

        Survivors reach the step boundary at different times, and the
        fastest ones resume saving (and committing) the moment their
        migration lands — so "the newest committed step" is NOT a
        stable answer; a slow rank reading it later can pick a step
        that did not exist when the first rank chose, and the
        migration aborts on the mismatch. Instead exactly ONE
        survivor decides: the first to claim the order's agreement
        key (an atomic KV counter) runs ``compute_fn`` and publishes
        the result; everyone else reads the published value. Returns
        the agreed step (negative = the decider found nothing to
        restore)."""
        if self._client is None:
            return int(compute_fn())
        key = f"reshard/agree/{order.id}/step"
        try:
            n = self._client.kv_store_add(f"{key}/claim", 1)
        except Exception as e:
            logger.warning("step-agreement claim failed (%s); "
                           "deciding locally", e)
            return int(compute_fn())
        if n == 1:
            value = int(compute_fn())
            self._client.kv_store_set(key, str(value).encode())
            record(
                "reshard.step_pinned", order_id=order.id,
                step=value, node_rank=self._node_rank,
            )
            return value
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                raw = self._client.kv_store_get(key)
            except Exception:
                raw = b""
            if raw:
                return int(raw)
            time.sleep(poll)
        raise TimeoutError(
            f"no pinned restore step for order {order.id} "
            f"within {timeout}s"
        )

    # ------------------------------------------------------------ reporting

    def report_phase(self, order: TransitionOrder,
                     phase: str) -> Optional[str]:
        """Tell the master how far this rank got; returns the
        master's action (``ok``/``stale``/``abort``) or None when
        masterless. A non-ok answer flips :attr:`fallback`."""
        if self._client is None:
            return None
        resp = self._client.report_reshard(
            order_id=order.id, phase=phase
        )
        action = getattr(resp, "action", None) if resp else None
        if action in ("abort", "stale"):
            self._fallback = True
        return action

    def note_migrated(self, order: TransitionOrder,
                      stats: Optional[Dict[str, int]] = None,
                      duration_s: float = 0.0) -> Optional[str]:
        """State migration landed: journal the per-source move counts
        (live redistribution / local archive / peer RAM / store /
        in-process device_put), bump the move counters, and report
        the phase."""
        from dlrover_tpu_torch.reshard.migrate import MOVE_SOURCES

        stats = stats or {}
        record(
            "reshard.migrated", order_id=order.id,
            node_rank=self._node_rank,
            live=int(stats.get("live", 0)),
            local=int(stats.get("local", 0)),
            peer=int(stats.get("peer", 0)),
            store=int(stats.get("store", 0)),
            device=int(stats.get("device", 0)),
            digest_mismatch=int(stats.get("digest_mismatch", 0)),
            bytes=int(stats.get("bytes", 0)),
            duration_s=round(float(duration_s), 6),
        )
        moves = _moves_counter()
        for source in MOVE_SOURCES:
            n = int(stats.get(source, 0))
            if n > 0:
                moves.labels(source=source).inc(n)
        return self.report_phase(order, "migrated")

    def complete(self, order: TransitionOrder) -> Optional[str]:
        """The whole transition is done on this rank (world re-formed,
        state migrated, data plane re-armed)."""
        return self.report_phase(order, "completed")

    def abort(self, order: TransitionOrder, reason: str) -> Optional[str]:
        """This rank cannot finish the transition: journal it, tell
        the master (which broadcasts the abort), and fall back."""
        record(
            "reshard.aborted", order_id=order.id, reason=reason,
            node_rank=self._node_rank,
        )
        self._fallback = True
        return self.report_phase(order, "aborted")
