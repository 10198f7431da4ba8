"""TransitionCoordinator: master-side brain of reshard-in-place.

Every scale event used to be restart-the-world: survivors exit,
re-rendezvous, rebuild, restore. The coordinator turns a world-size
change into an *online* transition instead (ElasWave's
reconfiguration-as-a-first-class-operation, PAPERS.md): on a node
loss (heartbeat timeout, quarantine, drain notice) or a node join it
computes the surviving/augmented world, broadcasts a versioned
:class:`~dlrover_tpu_torch.reshard.order.TransitionOrder` over the KV
store, and tracks per-survivor progress acks until the transition
completes — or aborts into the existing restart-the-world path.

Contract highlights (the full state machine is in docs/ELASTICITY.md):

* **one transition at a time** — a second failure while an order is
  open aborts the open order; overlapping remaps are undecidable.
* **budget** — at most ``DLROVER_TPU_MAX_RESHARDS`` online
  transitions per job; past it, failures take the restart path.
* **abort watchdog** — survivors that do not complete within
  ``DLROVER_TPU_RESHARD_ABORT_TIMEOUT`` seconds trigger an abort
  broadcast (``kind=abort``) and the fallback callback re-enables
  relaunch for the lost ranks.
* **exactly-once ledger** — the lost rank's in-flight dataset tasks
  are relinquished back to the shard ledger the moment the order is
  cut, so survivors pick them up with no index lost or doubled.

Counterpart of ``dlrover_tpu/reshard/coordinator.py``, under the same names.
"""

import os
import threading
import time
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.reshard.order import (
    KIND_ABORT,
    KIND_GROW,
    KIND_PROMOTE,
    KIND_SHRINK,
    SPARE_KEY_PREFIX,
    TRANSITION_ORDER_KEY,
    TransitionOrder,
)
from dlrover_tpu_torch.telemetry import gauge, record, tracing


def reshard_enabled() -> bool:
    """Worker-side arming: poll for transition orders unless
    ``DLROVER_TPU_RESHARD=0``/``off``. Polling against a master that
    never cuts orders is a no-op KV read, so workers default on."""
    return os.environ.get("DLROVER_TPU_RESHARD", "1") not in ("0", "off")


def reshard_opted_in() -> bool:
    """Master-side arming: the coordinator changes the RECOVERY
    SEMANTICS of every worker loss (online shrink + relaunch
    suppression instead of restart-the-world), so it engages only on
    explicit opt-in — ``DLROVER_TPU_RESHARD=1``/``on``. Jobs without
    the flag keep the restart path for every scale event."""
    return os.environ.get("DLROVER_TPU_RESHARD", "").lower() in (
        "1", "on", "true",
    )


class TransitionCoordinator:
    """Detect loss/join, cut the order, shepherd it to completion."""

    def __init__(
        self,
        kv_store,
        task_manager=None,
        goodput=None,
        max_transitions: Optional[int] = None,
        abort_timeout: Optional[float] = None,
        min_world: int = 1,
        fallback_fn: Optional[Callable[[TransitionOrder], None]] = None,
    ):
        self._kv = kv_store
        self._task_manager = task_manager
        self._goodput = goodput
        self._max = int(
            os.environ.get("DLROVER_TPU_MAX_RESHARDS", "8")
            if max_transitions is None else max_transitions
        )
        self._abort_timeout = float(
            os.environ.get("DLROVER_TPU_RESHARD_ABORT_TIMEOUT", "120")
            if abort_timeout is None else abort_timeout
        )
        self._min_world = max(1, int(min_world))
        self._fallback_fn = fallback_fn
        self._lock = threading.RLock()
        self._seq = 0
        self._world: List[int] = []
        #: True once the first training rendezvous round completed:
        #: the initial membership is established, so a LATER unseen
        #: RUNNING rank is a real node join, not bring-up stragglers
        self._sealed = False
        self._active: Optional[TransitionOrder] = None
        self._active_since = 0.0
        self._acks: Dict[int, str] = {}
        self._done = 0

    # ------------------------------------------------------------ membership

    def note_node_running(self, rank: int) -> Optional[TransitionOrder]:
        """A worker reported RUNNING: it is mesh-transition material.

        Before the world is sealed (:meth:`seal_world`), RUNNING
        reports are initial bring-up and only widen the membership.
        After the seal, an unseen rank is a REAL join: cut a grow
        order so the newcomer adopts at the step boundary and
        receives its shard set live from peers.
        Registered hot spares are deliberately NOT grown in — they
        idle warm until a loss promotes them
        (:meth:`note_node_lost`).
        """
        rank = int(rank)
        with self._lock:
            if rank in self._world:
                return None
            if rank in self._spare_ranks():
                return None
            if not self._sealed:
                self._world.append(rank)
                self._world.sort()
                return None
        return self.note_node_join(rank, reason="node_join")

    def seal_world(self) -> None:
        """The training rendezvous completed a round: the membership
        is established. Called by the master on every completed round
        (dist_master wires the rendezvous round listener here), so a
        world unsealed by an abort re-seals as soon as the relaunched
        fleet re-forms."""
        with self._lock:
            if not self._sealed and self._world:
                self._sealed = True
                logger.info(
                    "reshard world sealed at %s: later unseen ranks "
                    "are joins", self._world,
                )

    @property
    def sealed(self) -> bool:
        with self._lock:
            return self._sealed

    def _spare_ranks(self) -> List[int]:
        """Ranks pre-registered as hot spares (KV scan — the spare
        writes ``reshard/spare/<rank>`` before reporting RUNNING)."""
        ranks = []
        for key in self._kv.keys(SPARE_KEY_PREFIX):
            try:
                ranks.append(int(key[len(SPARE_KEY_PREFIX):]))
            except ValueError:
                continue
        return sorted(ranks)

    def _claim_spare_locked(self, lost_rank: int) -> Optional[int]:
        """Take the lowest eligible registered spare off the bench
        (deletes its registration so it cannot be claimed twice)."""
        for spare in self._spare_ranks():
            if spare == lost_rank or spare in self._world:
                continue
            try:
                self._kv.delete(f"{SPARE_KEY_PREFIX}{spare}")
            except Exception as e:
                logger.warning("spare %d claim failed: %s", spare, e)
                continue
            return spare
        return None

    @property
    def world(self) -> List[int]:
        with self._lock:
            return list(self._world)

    @property
    def active_order(self) -> Optional[TransitionOrder]:
        with self._lock:
            return self._active

    @property
    def transitions_done(self) -> int:
        with self._lock:
            return self._done

    def set_fallback(
        self, fn: Optional[Callable[[TransitionOrder], None]]
    ) -> None:
        with self._lock:
            self._fallback_fn = fn

    # ------------------------------------------------------------- detection

    def note_node_lost(self, rank: int,
                       reason: str = "") -> Optional[TransitionOrder]:
        """A member died (heartbeat timeout, quarantine, drain). Cut a
        shrink order when an online transition is possible; return
        None to let the caller take the restart-the-world path."""
        rank = int(rank)
        with self._lock:
            if self._active is not None:
                if rank in self._active.survivors:
                    # a second casualty mid-transition: the open remap
                    # is undecidable — abort into the restart path
                    self._abort_locked(
                        f"survivor rank {rank} lost mid-transition"
                    )
                return None
            if rank not in self._world:
                return None
            if self._done >= self._max:
                logger.warning(
                    "reshard budget exhausted (%d); node %d takes the "
                    "restart path", self._max, rank,
                )
                return None
            survivors = sorted(r for r in self._world if r != rank)
            if len(survivors) < self._min_world:
                return None
            record(
                "reshard.detected", node_rank=rank, reason=reason,
                old_world_size=len(self._world),
            )
            spare = self._claim_spare_locked(rank)
            self._seq += 1
            if spare is not None:
                # a warm spare stands in for the casualty: the world
                # size holds, the spare takes the dead rank's shard
                # set (it pre-warmed the step from peers), and no
                # batch-size/sampler resize is needed
                order = TransitionOrder(
                    id=self._seq, kind=KIND_PROMOTE,
                    old_world_size=len(self._world),
                    world_size=len(survivors) + 1,
                    survivors=sorted(survivors + [spare]),
                    lost=[rank], joined=[spare],
                    reason=reason,
                )
                record(
                    "spare.promoted", order_id=self._seq,
                    spare_rank=spare, lost_rank=rank,
                )
            else:
                order = TransitionOrder(
                    id=self._seq, kind=KIND_SHRINK,
                    old_world_size=len(self._world),
                    world_size=len(survivors),
                    survivors=survivors, lost=[rank],
                    reason=reason,
                )
            self._open_locked(order)
        if self._goodput is not None:
            self._goodput.note_fault(cause="reshard", node_id=rank)
        self._rebalance(order, rank)
        return order

    def note_node_join(self, rank: int,
                       reason: str = "") -> Optional[TransitionOrder]:
        """A fresh worker wants in. Grow the world online; while a
        transition is open the join waits for the next RUNNING report
        (the caller retries on its status cadence)."""
        rank = int(rank)
        with self._lock:
            if self._active is not None or rank in self._world:
                return None
            if self._done >= self._max or not self._world:
                return None
            survivors = sorted(self._world + [rank])
            record(
                "reshard.detected", node_rank=rank, reason=reason,
                old_world_size=len(self._world),
            )
            self._seq += 1
            order = TransitionOrder(
                id=self._seq, kind=KIND_GROW,
                old_world_size=len(self._world),
                world_size=len(survivors),
                survivors=survivors, joined=[rank],
                reason=reason,
            )
            self._open_locked(order)
        return order

    def _open_locked(self, order: TransitionOrder) -> None:
        # the cut span roots the transition's causal chain: its
        # traceparent rides the order over KV, and every survivor's
        # adoption span parents back here
        with tracing.span("reshard.order_cut", {
            "order": order.id, "kind": order.kind,
        }):
            order.trace = tracing.traceparent() or ""
            self._broadcast(order)
        record(
            # `kind` is the event name's slot in record(); the order
            # kind travels as order_kind
            "reshard.ordered", order_id=order.id, order_kind=order.kind,
            world_size=order.world_size, lost=order.lost,
            joined=order.joined,
        )
        self._active = order
        self._active_since = time.time()
        # the joining rank acks too: it has to adopt the order and
        # take its place before the transition counts as complete
        self._acks = {r: "" for r in order.survivors}

    def _broadcast(self, order: TransitionOrder) -> None:
        self._kv.set(TRANSITION_ORDER_KEY, order.to_json())

    def _rebalance(self, order: TransitionOrder, rank: int) -> None:
        """Requeue the lost rank's in-flight dataset tasks so the
        shard ledger stays exactly-once across the resize (the crash
        rewind generalized to a world change)."""
        requeued = 0
        if self._task_manager is not None:
            try:
                requeued = self._task_manager.relinquish_tasks(
                    "worker", rank
                )
            except Exception as e:
                logger.warning("reshard ledger rebalance failed: %s", e)
        record(
            "reshard.rebalanced", order_id=order.id, node_rank=rank,
            requeued=requeued,
        )

    # ------------------------------------------------------------- progress

    def note_worker_phase(self, rank: int, order_id: int,
                          phase: str) -> str:
        """A survivor reported transition progress over the
        ``report_reshard`` RPC. Returns the action the worker should
        take: ``ok`` (carry on), ``stale`` (drop — the order is no
        longer the active one), or ``abort`` (fall back)."""
        rank = int(rank)
        with self._lock:
            if self._active is None or int(order_id) != self._active.id:
                return "stale"
            if phase == "aborted":
                self._abort_locked(f"rank {rank} aborted the transition")
                return "abort"
            if rank in self._acks:
                self._acks[rank] = phase
            if all(p == "completed" for p in self._acks.values()):
                self._complete_locked()
            return "ok"

    def _complete_locked(self) -> None:
        order, duration = self._active, time.time() - self._active_since
        record(
            "reshard.completed", order_id=order.id,
            order_kind=order.kind,
            world_size=order.world_size,
            duration_s=round(duration, 6),
        )
        gauge(
            "dlrover_reshard_duration_seconds",
            "Wall-clock of the last completed mesh transition",
        ).set(duration)
        self._world = list(order.survivors)
        self._active = None
        self._acks = {}
        self._done += 1
        if self._goodput is not None:
            self._goodput.mark_recovered("reshard")

    # --------------------------------------------------------------- aborts

    def abort(self, reason: str) -> None:
        with self._lock:
            self._abort_locked(reason)

    def check_abort(self, now: Optional[float] = None) -> None:
        """Watchdog tick (the master run loop): an order still open
        past the abort timeout falls back to restart-the-world."""
        now = time.time() if now is None else now
        with self._lock:
            if (self._active is not None
                    and now - self._active_since > self._abort_timeout):
                self._abort_locked(
                    f"transition {self._active.id} timed out after "
                    f"{self._abort_timeout:.0f}s"
                )

    def _abort_locked(self, reason: str) -> None:
        if self._active is None:
            return
        order = self._active
        logger.error("RESHARD ABORT (order %d): %s", order.id, reason)
        record(
            "reshard.aborted", order_id=order.id, reason=reason,
            pending=[r for r, p in self._acks.items()
                     if p != "completed"],
        )
        # broadcast the abort under a fresh id so survivors that
        # already adopted the order learn to stand down exactly-once
        self._seq += 1
        self._broadcast(TransitionOrder(
            id=self._seq, kind=KIND_ABORT, aborted_id=order.id,
            reason=reason,
        ))
        # the lost ranks leave the membership either way — the
        # fallback relaunches them as fresh incarnations
        self._world = [r for r in self._world if r not in order.lost]
        self._active = None
        self._acks = {}
        # the fallback restarts the world: un-seal so the relaunched
        # incarnations' RUNNING reports re-widen the membership
        # instead of cutting spurious grow orders; the next completed
        # rendezvous round re-seals
        self._sealed = False
        # the attempt spends budget either way: a job that keeps
        # aborting degrades to always-restart instead of looping
        self._done += 1
        if self._goodput is not None:
            self._goodput.mark_recovered("reshard")
        if self._fallback_fn is not None:
            try:
                self._fallback_fn(order)
            except Exception as e:
                logger.warning("reshard fallback hook failed: %s", e)
