"""Master-side rendezvous for elastic TPU training.

Parity reference: dlrover/python/master/elastic_training/rdzv_manager.py:52
(RendezvousManager, _check_rdzv_completed:106, ElasticTrainingRendezvousManager
:205, NetworkCheckRendezvousManager:249, _group_nodes:294).

TPU shape: a "node" is one TPU host (TPU-VM worker). The comm world the
manager hands back maps node_rank -> local accelerator-process count; agents
turn it into ``jax.distributed.initialize(coordinator_addr, num_processes,
process_id)``. ``node_unit`` maps to the slice granularity — an ICI-connected
slice only functions with all its hosts present, so worlds are truncated to
multiples of node_unit exactly like the reference truncates allreduce worlds.
"""

import math
import time
from abc import ABC, abstractmethod
from threading import Lock
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.constants import NetworkFailureReason
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import counter, gauge, histogram, record, tracing

#: seconds from first join to round completion: sub-second same-host
#: re-forms up to multi-minute fleet-wide cold starts
_ROUND_BUCKETS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
    600.0,
)


def _observe_round(name: str, rdzv_round: int, world: Dict[int, int],
                   started_ts: float) -> None:
    """One completed rendezvous round -> histogram + journal."""
    duration = max(0.0, time.time() - started_ts) if started_ts else 0.0
    counter(
        "dlrover_rdzv_rounds_total",
        "Completed rendezvous rounds", ["name"],
    ).labels(name=name).inc()
    histogram(
        "dlrover_rdzv_round_duration_seconds",
        "First join to round completion", ["name"],
        buckets=_ROUND_BUCKETS,
    ).labels(name=name).observe(duration)
    gauge(
        "dlrover_rdzv_world_size",
        "Node count of the latest completed round", ["name"],
    ).labels(name=name).set(len(world))
    record(
        "rendezvous.complete", name=name, round=rdzv_round,
        nodes=sorted(world), world_size=len(world),
        duration_s=round(duration, 3),
    )
    # retroactive span (first join -> completion): rendezvous rounds
    # show up on the merged timeline next to the step/checkpoint spans
    tracing.add_span(
        "rdzv." + name,
        started_ts if started_ts else time.time() - duration,
        duration,
        attrs={"round": rdzv_round, "world_size": len(world)},
    )


class RendezvousParameters:
    def __init__(self, min_nodes: int = 1, max_nodes: int = 1,
                 waiting_timeout: float = 30.0, node_unit: int = 1,
                 join_timeout: float = 600.0):
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.waiting_timeout = waiting_timeout
        self.node_unit = max(1, node_unit)
        self.join_timeout = join_timeout


class RendezvousManager(ABC):
    """Tracks waiting nodes and decides when a round completes."""

    def __init__(self):
        self._lock = Lock()
        self._alive_nodes = set()
        self._succeeded_nodes = set()
        self._waiting_nodes: Dict[int, int] = {}  # node_rank -> local procs
        self._rdzv_nodes: Dict[int, int] = {}  # the latest completed world
        self._lastcall_time = 0.0
        self._rdzv_params = RendezvousParameters()
        #: set once rank 0 reports the real min/max — before that, NO
        #: round may complete: a fast-starting node joining against the
        #: min=max=1 defaults would otherwise form a solo world while
        #: the rest of the fleet is still launching
        self._params_reported = False
        self._rdzv_round = 0
        self._node_unit = 1
        self._start_rdzv_ts = 0.0
        self._latest_rdzv_nodes: List[int] = []
        self._start_waiting_ts = 0.0
        self._round_listener = None
        self._params_listener = None

    def set_round_listener(self, listener):
        """``listener(round)`` fires after every completed round — the
        master's state journal persists it so rounds stay monotonic
        across a master restart (the round number keys the coordinator
        election in the KV store; a reset would reuse stale entries)."""
        with self._lock:
            self._round_listener = listener

    def restore_round(self, rdzv_round: int):
        """Master-restart restore: resume the round counter; membership
        is rebuilt live as agents re-join."""
        with self._lock:
            self._rdzv_round = max(self._rdzv_round, int(rdzv_round))

    def _notify_round_locked(self):
        if self._round_listener is None:
            return
        try:
            self._round_listener(self._rdzv_round)
        except Exception:
            pass  # best-effort persistence; never fail the rendezvous

    def set_params_listener(self, listener):
        """``listener(params_dict)`` fires on every params report — the
        master's state journal persists it; round completion is gated
        on params, so a restarted master that lost them could never
        form a world again."""
        self._params_listener = listener

    def update_rdzv_params(self, min_nodes: int, max_nodes: int,
                           waiting_timeout: float, node_unit: int,
                           join_timeout: float = 600.0):
        with self._lock:
            self._rdzv_params = RendezvousParameters(
                min_nodes, max_nodes, waiting_timeout, node_unit,
                join_timeout,
            )
            self._params_reported = True
            self._node_unit = max(1, node_unit)
            logger.info(
                "Rendezvous params: min=%d max=%d timeout=%s node_unit=%d",
                min_nodes, max_nodes, waiting_timeout, node_unit,
            )
        if self._params_listener is not None:
            try:
                self._params_listener({
                    "min_nodes": min_nodes, "max_nodes": max_nodes,
                    "waiting_timeout": waiting_timeout,
                    "node_unit": node_unit, "join_timeout": join_timeout,
                })
            except Exception:
                pass  # best-effort persistence; never fail the report

    def get_rdzv_round(self) -> int:
        with self._lock:
            return self._rdzv_round

    def add_alive_node(self, node_id: int):
        with self._lock:
            self._alive_nodes.add(node_id)

    def remove_alive_node(self, node_id: int):
        with self._lock:
            self._alive_nodes.discard(node_id)
            if node_id in self._waiting_nodes:
                del self._waiting_nodes[node_id]

    def mark_node_succeeded(self, node_id: int):
        """A normal exit: the node leaves the alive set WITHOUT tripping
        the shrink signal — survivors finishing their last steps must not
        be restarted because a peer completed first."""
        with self._lock:
            self._succeeded_nodes.add(node_id)
        self.remove_alive_node(node_id)

    def join_rendezvous(self, node_rank: int, local_world_size: int) -> int:
        """A node (TPU host agent) joins the next round; returns round."""
        with self._lock:
            if not self._waiting_nodes:
                self._start_rdzv_ts = time.time()
            if node_rank not in self._waiting_nodes:
                self._waiting_nodes[node_rank] = local_world_size
                self._lastcall_time = time.time()
            self._succeeded_nodes.discard(node_rank)
            # joining proves liveness; a later failed/deleted status report
            # prunes the node (servicer.rpc_update_node_status), which lets
            # num_nodes_waiting see a spare as a REPLACEMENT for it
            self._alive_nodes.add(node_rank)
            return self._rdzv_round

    def num_nodes_waiting(self) -> int:
        """Number of nodes waiting for a NEW round. Nonzero signals running
        agents to re-rendezvous (membership change)."""
        with self._lock:
            if not self._rdzv_nodes:
                return len(self._waiting_nodes)
            waiting = set(self._waiting_nodes)
            # normally-exited members don't count: their absence is not a
            # failure the survivors need to react to
            members = set(self._rdzv_nodes) - self._succeeded_nodes
            survivors = members & self._alive_nodes
            if not waiting and survivors == members:
                # full current world alive, nobody new: nothing to do
                return 0
            # a current-world member re-joined: node loss/restart, the world
            # must re-form
            if waiting & members:
                return len(self._waiting_nodes)
            # Signal iff the next-round world would DIFFER from the current
            # one. A node_unit leftover (3 joiners, unit=2) re-truncates to
            # the same world -> signalling would livelock agents in restart
            # loops; but a spare replacing a dead member, a full unit of
            # growth, or a DEAD MEMBER the survivors must shed (the master
            # pruned it from the alive set on heartbeat loss/failure; the
            # waiting set may be empty then) forms a different world and
            # must signal.
            candidates = sorted(waiting | survivors)
            p = self._rdzv_params
            keep = min(
                (len(candidates) // self._node_unit) * self._node_unit,
                p.max_nodes,
            )
            if keep < max(p.min_nodes, 1):
                return 0
            if set(candidates[:keep]) != members:
                # at least 1 even when nobody waits (pure shrink): agents
                # only compare this against zero
                return max(1, len(self._waiting_nodes))
            return 0

    def _check_rdzv_completed_locked(self):
        """Completion rule (parity: rdzv_manager.py:106): complete when
        max_nodes joined, or min_nodes joined and waiting_timeout elapsed
        since last join; truncate world to a node_unit multiple.

        Returns the world dict for the new round, or None if incomplete.
        Truncated nodes STAY in the waiting set for the next round (they
        are not members of this world and keep polling)."""
        p = self._rdzv_params
        n = len(self._waiting_nodes)
        if n == 0 or not self._params_reported:
            return None
        if n >= p.max_nodes:
            ranks = sorted(self._waiting_nodes)[: p.max_nodes]
        elif (
            n >= p.min_nodes
            and time.time() - self._lastcall_time >= p.waiting_timeout
        ):
            # keep only a node_unit multiple
            keep = (n // self._node_unit) * self._node_unit
            if keep < p.min_nodes or keep == 0:
                return None
            ranks = sorted(self._waiting_nodes)[:keep]
        else:
            return None
        world = {r: self._waiting_nodes[r] for r in ranks}
        for r in ranks:
            del self._waiting_nodes[r]
        return world

    @abstractmethod
    def get_comm_world(
        self, node_rank: int
    ) -> Tuple[int, int, Dict[int, int]]:
        """Return (round, group, world) — world empty if round incomplete."""

    def report_network_check_result(self, node_rank: int, normal: bool,
                                    elapsed: float):
        pass


class ElasticTrainingRendezvousManager(RendezvousManager):
    """The training rendezvous (parity: rdzv_manager.py:205)."""

    def get_comm_world(self, node_rank):
        with self._lock:
            world = self._check_rdzv_completed_locked()
            if world is not None:
                # every completion starts a NEW round, even with unchanged
                # membership: restarted processes must re-elect a live
                # coordinator, so the round number (which keys the
                # coordinator KV entry) has to advance
                self._rdzv_round += 1
                self._rdzv_nodes = dict(sorted(world.items()))
                self._latest_rdzv_nodes = list(self._rdzv_nodes)
                logger.info(
                    "Rendezvous round %d complete: nodes %s",
                    self._rdzv_round, list(self._rdzv_nodes),
                )
                _observe_round(
                    "training", self._rdzv_round, self._rdzv_nodes,
                    self._start_rdzv_ts,
                )
                self._notify_round_locked()
            # a node that has re-joined is waiting for the NEXT round —
            # never hand it the stale world it used to belong to
            if (
                node_rank in self._rdzv_nodes
                and node_rank not in self._waiting_nodes
            ):
                return self._rdzv_round, 0, self._rdzv_nodes
            return self._rdzv_round, 0, {}


class NetworkCheckRendezvousManager(RendezvousManager):
    """Pre-flight network check rendezvous (parity: rdzv_manager.py:249).

    Round 0 pairs nodes {0,1},{2,3},... so each pair runs an allgather probe
    over ICI/DCN; round 1 pairs each abnormal node with a known-good one to
    localize whether the fault is the node itself.
    """

    def __init__(self):
        super().__init__()
        self._node_status: Dict[int, bool] = {}
        self._node_times: Dict[int, float] = {}
        self._reported_nodes = set()
        self._node_groups: List[Dict[int, int]] = []
        self._singleton_nodes: set = set()
        self._check_round = 2
        #: probe-evidence rounds kept for straggler localization. A
        #: verdict therefore DECAYS after this many later rounds the
        #: node did not participate in — deliberate: evidence from a
        #: long-gone epoch of the job should not evict a node forever.
        self.MAX_ROUNDS_KEPT = 64
        # per-round probe evidence for straggler localization: the
        # probe is COLLECTIVE, so a slow node drags its whole group's
        # elapsed time — one round cannot tell the straggler from its
        # victims; intersecting slow-group membership across rounds
        # with different pairings can (get_straggler_nodes)
        self._round_times: Dict[int, Dict[int, float]] = {}
        self._round_groups: Dict[int, List[set]] = {}

    def update_rdzv_params(self, min_nodes, max_nodes, waiting_timeout,
                           node_unit, join_timeout=600.0):
        super().update_rdzv_params(
            min_nodes, max_nodes, waiting_timeout, node_unit, join_timeout
        )
        # the probe must cover every joined node; never truncate
        self._node_unit = 1

    def get_comm_world(self, node_rank):
        with self._lock:
            world = self._check_rdzv_completed_locked()
            if world is not None:
                self._rdzv_round += 1
                self._rdzv_nodes = dict(sorted(world.items()))
                _observe_round(
                    "network_check", self._rdzv_round,
                    self._rdzv_nodes, self._start_rdzv_ts,
                )
                self._notify_round_locked()
                # bounded history, NOT a cycle clear: a new cohort's
                # check (replacement/restored nodes probing each
                # other) must not wipe other nodes' verdicts — a
                # localized straggler would be forgotten the moment
                # fresh capacity ran its own pre-flight. Verdict
                # correctness across cohorts is handled per
                # participant (get_straggler_nodes: a node's own last
                # two informative participations), so old rounds only
                # need pruning for memory.
                # prune the UNION of keys: a round whose probers died
                # before reporting exists only in _round_groups and
                # would otherwise leak for the master's lifetime
                all_rounds = sorted(
                    set(self._round_times) | set(self._round_groups)
                )
                for stale in all_rounds[: -self.MAX_ROUNDS_KEPT]:
                    self._round_times.pop(stale, None)
                    self._round_groups.pop(stale, None)
                self._node_groups = self._group_nodes(
                    self._rdzv_round, self._rdzv_nodes
                )
                self._round_groups[self._rdzv_round] = [
                    set(g) for g in self._node_groups
                ]
                logger.info(
                    "Network-check round %d groups: %s",
                    self._rdzv_round, self._node_groups,
                )
                self._reported_nodes = set()
            if node_rank not in self._waiting_nodes:
                for group_idx, group in enumerate(self._node_groups):
                    if node_rank in group:
                        return self._rdzv_round, group_idx, group
            return self._rdzv_round, 0, {}

    def _group_nodes(self, round_num: int,
                     world: Dict[int, int]) -> List[Dict[int, int]]:
        """Pairwise grouping (parity: rdzv_manager.py:294)."""
        round_idx = (round_num - 1) % self._check_round
        node_groups: List[Dict[int, int]] = []
        self._singleton_nodes = set()
        ranks = sorted(world)
        if round_idx == 0:
            cur: Dict[int, int] = {}
            for r in ranks:
                cur[r] = world[r]
                if len(cur) == 2:
                    node_groups.append(cur)
                    cur = {}
            if cur:
                if node_groups:
                    node_groups[-1].update(cur)
                else:
                    node_groups.append(cur)
        else:
            # re-pair FAILED nodes and straggler SUSPECTS (members of
            # the previous round's slow groups) with known-good
            # partners: the second pairing localizes both fault and
            # slowness (the common member of two slow groups)
            suspects = self._straggler_suspects()
            abnormal = [
                r for r in ranks
                if not self._node_status.get(r, True) or r in suspects
            ]
            # log only the PREVIOUS round's times (what this re-pair
            # decided from) — dumping all 64 retained rounds per
            # grouping would flood master logs on long-lived jobs
            prev = max(self._round_times) if self._round_times else None
            logger.info(
                "Re-pair round %d: suspects=%s abnormal=%s "
                "prev_round_times=%s", round_num, sorted(suspects),
                abnormal,
                {
                    k: round(v, 1)
                    for k, v in self._round_times.get(prev, {}).items()
                } if prev is not None else {},
            )
            normal = [r for r in ranks if r not in abnormal]
            for a in abnormal:
                if normal:
                    n0 = normal.pop(0)
                    node_groups.append({a: world[a], n0: world[n0]})
                else:
                    # no healthy partner left: a solo probe exercises no
                    # inter-host link, so its success must not clear the
                    # abnormal status (see report_network_check_result)
                    self._singleton_nodes.add(a)
                    node_groups.append({a: world[a]})
            leftover = {r: world[r] for r in normal}
            if leftover:
                node_groups.append(leftover)
        return node_groups

    def report_network_check_result(self, node_rank: int, normal: bool,
                                    elapsed: float,
                                    rdzv_round: Optional[int] = None):
        with self._lock:
            self._reported_nodes.add(node_rank)
            # latest round wins: a node that failed round 0 but passes the
            # round-1 re-pair with a known-good partner is healthy (its round-0
            # partner was the broken one) — unless it probed alone, which
            # proves nothing about its links
            if normal and node_rank in self._singleton_nodes:
                normal = self._node_status.get(node_rank, False)
            self._node_status[node_rank] = normal
            self._node_times[node_rank] = elapsed
            if rdzv_round is None:
                rdzv_round = self._rdzv_round
            self._round_times.setdefault(
                rdzv_round, {}
            )[node_rank] = elapsed

    def network_check_success(self) -> Tuple[bool, str]:
        """Decide overall health and localize broken nodes
        (parity: rdzv_manager.py:368)."""
        with self._lock:
            if len(self._reported_nodes) < len(self._rdzv_nodes):
                return False, NetworkFailureReason.WAITING_NODE
            if not self._node_status:
                return False, NetworkFailureReason.NO_INIT
            if all(self._node_status.get(r, False)
                   for r in self._rdzv_nodes):
                return True, ""
            return False, NetworkFailureReason.NODE_FAILURE

    def get_fault_nodes(self) -> List[int]:
        with self._lock:
            return [
                r for r in self._rdzv_nodes
                if not self._node_status.get(r, True)
            ]

    def _slow_sets(self, ratio: float) -> List[Tuple[set, set]]:
        """Per recorded round: ``(participants, slow_members)`` where
        slow_members are the probe groups whose elapsed time exceeds
        ratio x the round's fastest group. Rounds with fewer than two
        timed groups carry no signal."""
        out: List[Tuple[set, set]] = []
        for rnd in sorted(self._round_times):
            times = self._round_times[rnd]
            groups = self._round_groups.get(rnd) or [
                {r} for r in times
            ]
            gtimes = []
            for g in groups:
                ts = [times[m] for m in g if m in times]
                if ts:
                    gtimes.append((g, max(ts)))
            if len(gtimes) < 2:
                continue
            fastest = min(t for _, t in gtimes)
            if fastest <= 0:
                continue
            participants: set = set()
            slow: set = set()
            for g, t in gtimes:
                participants |= g
                if t > ratio * fastest:
                    slow |= g
            out.append((participants, slow))
        return out

    def _straggler_suspects(self, ratio: float = 2.0) -> set:
        """Union of slow-group members so far (round-1 re-pairing)."""
        sets = [slow for _, slow in self._slow_sets(ratio)]
        return set().union(*sets) if sets else set()

    def get_straggler_nodes(self, ratio: float = 2.0) -> List[int]:
        """Localized stragglers.

        The probe is collective, so a slow node inflates every group
        member's elapsed time; localization needs two rounds with
        DIFFERENT pairings — the straggler is the common member of its
        slow groups (parity role: rdzv_manager.py:368's two-round
        fault localization, applied to slowness). Verdicts are scoped
        PER PARTICIPANT: a node is a straggler when its own last two
        informative PARTICIPATIONS both found it slow — a later check
        round over a different node subset (a relaunched slice probing
        itself) must neither clear nor smear verdicts for nodes it
        never probed. When the probes were collective (any recorded
        group has >=2 members), a single informative round CANNOT
        localize — blame would smear over the whole slow group and a
        shrink could evict a healthy victim — so a node needs two
        participations. The per-node median threshold applies only
        when times are genuinely per-node (solo probes, no group
        bookkeeping)."""
        with self._lock:
            rounds = self._slow_sets(ratio)
            if rounds:
                all_participants = set().union(
                    *(p for p, _ in rounds)
                )
                localized = set()
                for node in all_participants:
                    mine = [
                        slow for participants, slow in rounds
                        if node in participants
                    ]
                    if len(mine) >= 2 and all(
                        node in slow for slow in mine[-2:]
                    ):
                        localized.add(node)
                if localized:
                    return sorted(localized)
                # nothing localized: fall through — the grouped guard
                # below returns [] while group-level evidence exists
            grouped = any(
                any(len(g) >= 2 for g in groups)
                for groups in self._round_groups.values()
            )
            if grouped:
                # group-level evidence exists but only len(sets) < 2
                # informative rounds: wait for the re-pairing round
                return []
            if not self._node_times:
                return []
            times = sorted(self._node_times.values())
            median = times[len(times) // 2]
            if median <= 0:
                return []
            return [
                r for r, t in self._node_times.items()
                if t > ratio * median
            ]
