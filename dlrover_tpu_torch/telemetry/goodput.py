"""Goodput ledger: job-wide time attribution across restarts.

A copy of ``dlrover_tpu/telemetry/goodput.py``. Fault-tolerance work is
only worth what it saves: this module keeps the number the papers lead
with (fault-tolerant HSDP at 100k GPUs, ElasWave) -- what fraction of
wall-clock was useful training (goodput), where the rest went (badput
by cause), and how fast the job recovers (MTTR / MTBF) -- computed
across process restarts.

Three layers, one vocabulary:

  * :class:`PhaseLedger` -- a per-process phase state machine. At any
    instant the process is in exactly one :class:`Phase`; transitions
    close the open interval, so phase totals sum to elapsed time by
    construction. No new instrumentation points: transitions are
    derived from journal events that already fire (``hang.detected``,
    ``agent.master_lost``, ``scale.restart``, ``rendezvous.joined`` --
    see :data:`EVENT_RULES`) via a journal tap, plus two existing hook
    sites (``ElasticTrainer.report_step`` marks ``training``,
    ``maybe_checkpoint``'s measured stall credits ``ckpt_stall``).
    Every transition/credit is itself journaled (``goodput.phase`` /
    ``goodput.credit``) so the offline reconstruction is exact.
  * :class:`GoodputAggregator` -- master side. Per-process snapshots
    ride in on ``report_global_step`` (optional fields), the status
    report's goodput section or the dedicated ``report_goodput`` RPC;
    the aggregator folds them into job totals, attributes the *gap*
    between a dead process's last report and its successor's first
    ledger second as ``restart`` badput, and tracks fault windows for
    MTTR/MTBF. ``to_state`` / ``restore_state`` round-trip the account;
    the master persists it through the state journal
    (``master/state_journal.py``) when it has a state dir.
  * :func:`reconstruct` -- offline. Replays any journal file into the
    same summary shape: exact where ``goodput.*`` events exist, and
    heuristic (:data:`EVENT_RULES` applied to the generic events) for
    journals recorded before the live ledger existed.

Exposure: ``GET /goodput`` (telemetry/http.py), ``python -m
dlrover_tpu_torch.telemetry.dump --goodput``, and the flight-recorder
snapshot (every crash dump says what phase the job died in).
"""

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import journal as journal_mod
from dlrover_tpu_torch.telemetry import registry as registry_mod

__all__ = [
    "Phase",
    "PHASES",
    "BADPUT_CAUSES",
    "PhaseLedger",
    "GoodputAggregator",
    "install",
    "default_ledger",
    "reset_default_ledger",
    "report_fields",
    "local_snapshot",
    "set_job_provider",
    "http_payload",
    "reconstruct",
    "render_report",
]


class Phase:
    """Canonical phase names. Every phase string in the codebase must
    be one of these members (enforced by the AST lint in
    tests/test_tracing.py)."""

    INIT = "init"              # process start, compile, restore, warmup
    RENDEZVOUS = "rendezvous"  # waiting for the world to form
    TRAINING = "training"      # the only goodput phase
    CKPT_STALL = "ckpt_stall"  # train thread blocked on checkpointing
    HANG = "hang"              # stall window flagged by the detector
    RESTART = "restart"        # fault-to-recovery (incl. master loss)
    PREEMPT = "preempt"        # reclaim notice -> drain -> relaunch
    ROLLBACK = "rollback"      # sentinel trip -> last-good restore
    RESHARD = "reshard"        # online mesh transition (no restart)
    SERVING = "serving"        # inference replica answering requests
    IDLE = "idle"              # unattributed


PHASES: Tuple[str, ...] = (
    Phase.INIT, Phase.RENDEZVOUS, Phase.TRAINING, Phase.CKPT_STALL,
    Phase.HANG, Phase.RESTART, Phase.PREEMPT, Phase.ROLLBACK,
    Phase.RESHARD, Phase.SERVING, Phase.IDLE,
)

#: badput breakdown keys: every phase that is neither useful work
#: (training for a trainer, serving for an inference replica) nor
#: unattributed
BADPUT_CAUSES: Tuple[str, ...] = (
    Phase.INIT, Phase.RENDEZVOUS, Phase.CKPT_STALL, Phase.HANG,
    Phase.RESTART, Phase.PREEMPT, Phase.ROLLBACK, Phase.RESHARD,
)


class PhaseLedger:
    """Continuous per-process time attribution.

    The process is in exactly one phase at any instant; ``transition``
    closes the open interval and ``credit`` retroactively re-labels the
    trailing seconds of it (a checkpoint stall is only known after the
    fact). Totals therefore sum to elapsed wall-clock by construction.
    Thread-safe; journal emission happens outside the lock so a tap
    observing our own events can never deadlock."""

    def __init__(self, start_ts: Optional[float] = None,
                 phase: str = Phase.INIT, journal_events: bool = True):
        if phase not in PHASES:
            raise ValueError(f"unknown phase {phase!r}")
        self._lock = threading.Lock()
        self._start = time.time() if start_ts is None else float(start_ts)
        self._mark = self._start
        self._phase = phase
        self._totals: Dict[str, float] = {p: 0.0 for p in PHASES}
        self._journal = journal_events
        self._resume_phase = phase  # where to return after a fault phase
        self._closed = False

    # ------------------------------------------------------------- mutation

    def transition(self, phase: str, ts: Optional[float] = None) -> None:
        """Enter ``phase`` at ``ts`` (now). No-op when already there."""
        if phase not in PHASES:
            raise ValueError(f"unknown phase {phase!r}")
        with self._lock:
            if self._closed or phase == self._phase:
                return
            ts = self._now(ts)
            self._totals[self._phase] += max(0.0, ts - self._mark)
            prev = self._phase
            if prev not in (Phase.HANG, Phase.RESTART, Phase.PREEMPT,
                            Phase.ROLLBACK, Phase.RESHARD):
                # a fault phase ends by returning to what it interrupted
                self._resume_phase = prev
            self._phase = phase
            self._mark = ts
        if self._journal:
            journal_mod.record("goodput.phase", phase=phase, prev=prev,
                               at=ts)

    def credit(self, phase: str, seconds: float,
               ts: Optional[float] = None) -> float:
        """Attribute the trailing ``seconds`` ending at ``ts`` to
        ``phase`` without leaving the current phase. Clamped to the
        open interval (time can only be re-labeled, never invented);
        returns the seconds actually credited."""
        if phase not in PHASES:
            raise ValueError(f"unknown phase {phase!r}")
        with self._lock:
            if self._closed:
                return 0.0
            ts = self._now(ts)
            span = max(0.0, ts - self._mark)
            credited = max(0.0, min(float(seconds), span))
            self._totals[self._phase] += span - credited
            self._totals[phase] += credited
            self._mark = ts
        if self._journal and credited > 0.0:
            journal_mod.record("goodput.credit", phase=phase,
                               credit_s=round(credited, 6), at=ts)
        return credited

    def on_step(self) -> None:
        """A training step completed: the cheap per-step hook. Enters
        ``training`` from wherever the process was (also how hang /
        restart windows close: the next step proves recovery)."""
        with self._lock:
            already = self._phase == Phase.TRAINING
        if not already:
            self.transition(Phase.TRAINING)

    def resume(self, ts: Optional[float] = None) -> None:
        """Leave a fault phase (hang/restart) back to the phase it
        interrupted."""
        with self._lock:
            target = self._resume_phase
        self.transition(target, ts=ts)

    def close(self, ts: Optional[float] = None) -> Dict[str, Any]:
        """Final flush at process exit: closes the open interval and
        journals a ``goodput.snapshot`` carrying the full totals, the
        offline reconstruction's ground truth for this process."""
        ts = self._now(ts)
        snap = self.snapshot(now=ts)
        with self._lock:
            if self._closed:
                return snap
            self._totals[self._phase] += max(0.0, ts - self._mark)
            self._mark = ts
            self._closed = True
        if self._journal:
            journal_mod.record("goodput.snapshot", **{
                "phase": snap["phase"],
                "start_ts": snap["start_ts"],
                "elapsed_s": snap["elapsed_s"],
                "phases": snap["phases"],
            })
        return snap

    @staticmethod
    def _now(ts: Optional[float]) -> float:
        return time.time() if ts is None else float(ts)

    # -------------------------------------------------------------- reading

    @property
    def phase(self) -> str:
        with self._lock:
            return self._phase

    @property
    def start_ts(self) -> float:
        return self._start

    def totals(self, now: Optional[float] = None) -> Dict[str, float]:
        """Per-phase seconds including the open interval."""
        with self._lock:
            now = max(self._now(now), self._mark)
            out = dict(self._totals)
            if not self._closed:
                out[self._phase] += now - self._mark
        return out

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        with self._lock:
            # a closed ledger is frozen: elapsed stays equal to the sum
            # of its phase totals no matter when the snapshot is read
            now = (self._mark if self._closed
                   else max(self._now(now), self._mark))
            phases = dict(self._totals)
            if not self._closed:
                phases[self._phase] += now - self._mark
            start, phase = self._start, self._phase
        elapsed = max(0.0, now - start)
        return {
            "start_ts": start,
            "ts": now,
            "phase": phase,
            "elapsed_s": round(elapsed, 6),
            "phases": {k: round(v, 6) for k, v in phases.items()},
            "goodput_percent": _pct(phases.get(Phase.TRAINING, 0.0),
                                    elapsed),
            "attributed_percent": _pct(
                elapsed - phases.get(Phase.IDLE, 0.0), elapsed
            ),
        }


def _pct(part: float, whole: float) -> float:
    return round(100.0 * part / whole, 3) if whole > 0 else 0.0


# ---------------------------------------------------------------- event tap
#
# Phase transitions derived from journal events that ALREADY fire —
# the "no new instrumentation points" contract. The same rules drive
# the live ledger (via the journal tap) and the offline heuristic
# reconstruction of pre-ledger journals.


def _on_hang(led: PhaseLedger, ts: float, data: Dict) -> None:
    # the stall started `stalled_for` seconds ago: re-label it
    stalled = float(data.get("stalled_for", 0.0) or 0.0)
    if stalled > 0:
        led.credit(Phase.HANG, stalled, ts=ts)
    led.transition(Phase.HANG, ts=ts)


def _on_rdzv_joined(led: PhaseLedger, ts: float, data: Dict) -> None:
    # the whole wait since init/restart began was rendezvous queueing;
    # what follows (worker spawn, compile) is init again
    if led.phase in (Phase.INIT, Phase.RESTART, Phase.RENDEZVOUS):
        led.credit(Phase.RENDEZVOUS, float("inf"), ts=ts)
        led.transition(Phase.INIT, ts=ts)


EVENT_RULES: Dict[str, Callable[[PhaseLedger, float, Dict], None]] = {
    "hang.detected":
        _on_hang,
    "agent.master_lost":
        lambda led, ts, data: led.transition(Phase.RESTART, ts=ts),
    "agent.master_reconnected":
        lambda led, ts, data: led.resume(ts=ts),
    "scale.restart":
        lambda led, ts, data: led.transition(Phase.RESTART, ts=ts),
    "fault.injected":
        lambda led, ts, data: led.transition(Phase.RESTART, ts=ts),
    "rendezvous.joined":
        _on_rdzv_joined,
    # the drain sequence opens the preempt window; the process dies in
    # it, and the master books the relaunch gap under the same cause
    "preempt.notice":
        lambda led, ts, data: led.transition(Phase.PREEMPT, ts=ts),
    # a sentinel trip (or an adopted rollback order from another
    # rank's trip) opens the rollback window; the first post-restore
    # step closes it via on_step, like hang windows
    "anomaly.detected":
        lambda led, ts, data: led.transition(Phase.ROLLBACK, ts=ts),
    "rollback.ordered":
        lambda led, ts, data: led.transition(Phase.ROLLBACK, ts=ts),
    # an adopted mesh-transition order opens the reshard window on the
    # surviving rank's ledger; the first post-migration step closes it
    # via on_step. An abort falls through to the restart-the-world
    # path, so its time books as restart from the abort on
    "reshard.adopted":
        lambda led, ts, data: led.transition(Phase.RESHARD, ts=ts),
    "reshard.aborted":
        lambda led, ts, data: led.transition(Phase.RESTART, ts=ts),
    # a serving replica's useful-work phase opens when its weights are
    # loaded and it starts answering (serving/worker.py) — without this
    # rule serve time books as idle; same rule drives the offline
    # heuristic replay, so serving incarnations reconstruct too
    "serve.worker_ready":
        lambda led, ts, data: led.transition(Phase.SERVING, ts=ts),
}


_state_lock = threading.Lock()
_default_ledger: Optional[PhaseLedger] = None
_job_provider: Optional[Callable[[], Dict]] = None


def _tap(event: Dict[str, Any]) -> None:
    led = _default_ledger
    if led is None:
        return
    kind = event.get("kind", "")
    if kind.startswith("goodput."):
        return  # our own breadcrumbs
    rule = EVENT_RULES.get(kind)
    if rule is None:
        return
    try:
        rule(led, float(event.get("ts") or time.time()),
             event.get("data") or {})
    except Exception as e:  # telemetry never takes training down
        logger.warning("goodput tap failed on %s: %s", kind, e)


def install(phase: str = Phase.INIT) -> PhaseLedger:
    """Arm the process-wide ledger (idempotent): creates it and taps
    the event journal so existing events drive phase transitions."""
    global _default_ledger
    with _state_lock:
        if _default_ledger is None:
            _default_ledger = PhaseLedger(phase=phase)
            journal_mod.add_tap(_tap)
            # birth breadcrumb: anchors the offline replay's start_ts
            journal_mod.record(
                "goodput.phase", phase=phase, prev="",
                at=_default_ledger.start_ts,
            )
        return _default_ledger


def default_ledger() -> Optional[PhaseLedger]:
    """The live process ledger, or None before :func:`install`."""
    return _default_ledger


def reset_default_ledger() -> None:
    """Drop the process ledger and its journal tap (tests)."""
    global _default_ledger
    with _state_lock:
        _default_ledger = None
        journal_mod.remove_tap(_tap)


def report_fields() -> Dict[str, Any]:
    """Ledger fields piggybacked on ``report_global_step`` (empty dict
    when no ledger is armed — the wire message omits nothing)."""
    led = _default_ledger
    if led is None:
        return {}
    snap = led.snapshot()
    return {
        "goodput_phases": snap["phases"],
        "goodput_elapsed_s": snap["elapsed_s"],
        "goodput_start_ts": snap["start_ts"],
        "goodput_phase": snap["phase"],
    }


def local_snapshot() -> Optional[Dict[str, Any]]:
    led = _default_ledger
    return led.snapshot() if led is not None else None


# ------------------------------------------------------------- master side


class GoodputAggregator:
    """Folds per-process ledger snapshots into the job-level account.

    Each report is cumulative for its (node, pid) incarnation, so the
    latest snapshot per incarnation is the whole truth about it; the
    un-ledgered gap between a dead incarnation's coverage and its
    successor's start is ``restart`` badput (the window no process was
    alive to attribute). Fault windows feed MTTR/MTBF; ``to_state`` /
    ``restore_state`` round-trip through the master state journal so a
    master kill costs accuracy nothing — the master's own downtime is
    restored as one more fault window."""

    def __init__(self, persist_fn: Optional[Callable[[Dict], None]] = None,
                 persist_interval: float = 1.0):
        self._lock = threading.Lock()
        self._procs: Dict[str, Dict[str, Any]] = {}
        self._faults: List[Dict[str, Any]] = []
        self._job_start: Optional[float] = None
        self._persist_fn = persist_fn
        self._persist_interval = persist_interval
        self._last_persist = 0.0

    def set_persist_fn(self, fn: Optional[Callable[[Dict], None]],
                       interval: float = 1.0) -> None:
        self._persist_fn = fn
        self._persist_interval = interval

    # ------------------------------------------------------------- feeding

    def observe_report(self, node_id: int, pid: int, start_ts: float,
                       elapsed_s: float, phases: Dict[str, float],
                       phase: str = "", host: str = "",
                       final: bool = False,
                       ts: Optional[float] = None,
                       job: str = "default") -> None:
        """One process snapshot off the wire. Never raises."""
        try:
            self._observe(node_id, pid, start_ts, elapsed_s, phases,
                          phase, host, final, ts, job)
        except Exception as e:
            logger.warning("goodput report dropped: %s", e)

    def _observe(self, node_id, pid, start_ts, elapsed_s, phases,
                 phase, host, final, ts, job="default"):
        if not phases or start_ts <= 0:
            return
        ts = time.time() if ts is None else float(ts)
        job = job or "default"
        # default-job keys keep the pre-job shape so existing state
        # journals restore verbatim; other jobs prefix theirs so two
        # jobs reusing (node_id, pid) can never collide
        key = (
            f"{int(node_id)}:{int(pid)}" if job == "default"
            else f"{job}/{int(node_id)}:{int(pid)}"
        )
        with self._lock:
            if self._job_start is None or start_ts < self._job_start:
                self._job_start = float(start_ts)
            entry = self._procs.get(key)
            if entry is None:
                open_prior = [
                    (k, e) for k, e in self._procs.items()
                    if e["node_id"] == int(node_id)
                    and (e.get("job") or "default") == job
                    and not e.get("final_seen")
                ]
                if open_prior:
                    # a fresh incarnation of a node whose predecessor
                    # never said goodbye: that predecessor died — a
                    # fault window from its last ledgered second to
                    # the successor's birth
                    died = max(e["start_ts"] + e["elapsed_s"]
                               for _, e in open_prior)
                    self._note_fault_locked(
                        cause="worker_restart", node_id=int(node_id),
                        ts=died,
                        recovered_ts=max(died, float(start_ts)),
                    )
                    for k, e in open_prior:
                        # copy-on-write: entries are never mutated in
                        # place, so to_state() can hand out a shallow
                        # snapshot instead of copying every proc
                        self._procs[k] = {**e, "final_seen": True}
            self._procs[key] = {
                "node_id": int(node_id),
                "pid": int(pid),
                "job": job,
                "host": host or "",
                "start_ts": float(start_ts),
                "elapsed_s": float(elapsed_s),
                "phases": {
                    p: float(phases.get(p, 0.0)) for p in PHASES
                },
                "phase": phase or "",
                "last_report_ts": ts,
                "final_seen": bool(final),
            }
        self._maybe_persist(ts)

    def note_fault(self, cause: str, node_id: Optional[int] = None,
                   ts: Optional[float] = None,
                   recovered_ts: Optional[float] = None) -> None:
        with self._lock:
            self._note_fault_locked(cause, node_id,
                                    time.time() if ts is None else ts,
                                    recovered_ts)
        self._maybe_persist(time.time())

    def _note_fault_locked(self, cause, node_id, ts, recovered_ts=None):
        self._faults.append({
            "cause": cause,
            "node_id": node_id,
            "ts": float(ts),
            "recovered_ts": recovered_ts,
        })

    def mark_recovered(self, cause: str,
                       ts: Optional[float] = None) -> None:
        """Close the oldest open fault window of ``cause``."""
        ts = time.time() if ts is None else float(ts)
        with self._lock:
            for i, f in enumerate(self._faults):
                if f["cause"] == cause and f["recovered_ts"] is None:
                    # copy-on-write, same contract as _procs entries
                    self._faults[i] = {**f, "recovered_ts": ts}
                    break

    # ------------------------------------------------------------ summary

    def jobs(self) -> List[str]:
        """Job namespaces with at least one observed process."""
        with self._lock:
            return sorted({
                e.get("job") or "default"
                for e in self._procs.values()
            })

    def summary(self, job: Optional[str] = None) -> Dict[str, Any]:
        """The whole account, or one job's slice of it. Job-filtered
        summaries keep un-attributed fault windows (a master restart
        is every job's downtime) alongside the job's own."""
        with self._lock:
            procs = {
                k: dict(v) for k, v in self._procs.items()
                if job is None or (v.get("job") or "default") == job
            }
            faults = [
                dict(f) for f in self._faults
                if job is None or f.get("job") in (None, job)
            ]
        return summarize(procs, faults)

    # -------------------------------------------------------- persistence

    def _maybe_persist(self, now: float) -> None:
        fn = self._persist_fn
        if fn is None or now - self._last_persist < self._persist_interval:
            return
        self._last_persist = now
        try:
            fn(self.to_state())
        except Exception as e:
            logger.warning("goodput persist failed: %s", e)

    def to_state(self) -> Dict[str, Any]:
        with self._lock:
            # shallow snapshot only: proc/fault entries are
            # copy-on-write (never mutated in place), so copying the
            # containers is enough. Deep-copying 1k+ proc dicts here
            # was the dominant cost of per-report persistence when the
            # journal lane runs with persist_interval=0.
            return {
                "saved_at": time.time(),
                "job_start": self._job_start,
                "procs": dict(self._procs),
                "faults": list(self._faults),
            }

    def restore_state(self, state: Dict[str, Any],
                      now: Optional[float] = None) -> None:
        """Resume a prior master incarnation's account. The window
        between its last persist and now is the master's own downtime:
        one more (already recovered) fault toward MTTR/MTBF."""
        if not state:
            return
        now = time.time() if now is None else float(now)
        with self._lock:
            self._job_start = state.get("job_start") or self._job_start
            self._procs.update(state.get("procs") or {})
            self._faults = list(state.get("faults") or []) + self._faults
            saved_at = float(state.get("saved_at") or 0.0)
            if saved_at:
                self._note_fault_locked(
                    cause="master_restart", node_id=None, ts=saved_at,
                    recovered_ts=now,
                )


def summarize(procs: Dict[str, Dict[str, Any]],
              faults: List[Dict[str, Any]],
              now: Optional[float] = None) -> Dict[str, Any]:
    """Job-level account from per-process snapshots + fault windows.

    Shared by the live aggregator and the offline reconstruction, so
    ``dump --goodput`` and ``/goodput`` compute the same numbers from
    the same shape. Coverage is measured report-to-report (not to
    ``now``): a live process's attribution is exact as of its last
    snapshot and never diluted by reporting latency."""
    nodes: Dict[Any, Dict[str, Any]] = {}
    for p in procs.values():
        end = p["start_ts"] + p["elapsed_s"]
        # two jobs may reuse the same node_id space; namespace the
        # node key for non-default jobs so their accounts never merge
        job = p.get("job") or "default"
        node_key = (
            p["node_id"] if job == "default"
            else f"{job}/{p['node_id']}"
        )
        node = nodes.setdefault(node_key, {
            "first_start": p["start_ts"], "last_end": end,
            "covered_s": 0.0,
            "phases": {ph: 0.0 for ph in PHASES},
            "procs": 0,
        })
        node["first_start"] = min(node["first_start"], p["start_ts"])
        node["last_end"] = max(node["last_end"], end)
        node["covered_s"] += p["elapsed_s"]
        node["procs"] += 1
        for ph in PHASES:
            node["phases"][ph] += p["phases"].get(ph, 0.0)

    # nodes with an announced preemption (or an ordered rollback):
    # their un-ledgered relaunch gap carries that cause, not a generic
    # restart. Preempt wins over rollback when a node saw both — the
    # reclaim is what actually took the machine away.
    preempted_nodes = {
        f.get("node_id") for f in faults
        if f.get("cause") == Phase.PREEMPT and f.get("node_id") is not None
    }
    rollback_nodes = {
        f.get("node_id") for f in faults
        if f.get("cause") == Phase.ROLLBACK
        and f.get("node_id") is not None
    }

    phases = {ph: 0.0 for ph in PHASES}
    wall = 0.0
    for node_id, node in nodes.items():
        node_wall = max(0.0, node["last_end"] - node["first_start"])
        # the un-ledgered window between incarnations: nobody was alive
        # to attribute it, and the only way to be dead mid-job is a
        # restart (or announced preemption) in flight
        gap = max(0.0, node_wall - node["covered_s"])
        if node_id in preempted_nodes:
            gap_cause = Phase.PREEMPT
        elif node_id in rollback_nodes:
            gap_cause = Phase.ROLLBACK
        else:
            gap_cause = Phase.RESTART
        node["phases"][gap_cause] += gap
        node["wall_s"] = round(node_wall, 6)
        node["restart_gap_s"] = round(gap, 6)
        node["goodput_percent"] = _pct(
            node["phases"][Phase.TRAINING], node_wall
        )
        wall += node_wall
        for ph in PHASES:
            node["phases"][ph] = round(node["phases"][ph], 6)
            phases[ph] += node["phases"][ph]

    attributed = sum(phases.values()) - phases[Phase.IDLE]
    mttr_samples = [
        f["recovered_ts"] - f["ts"] for f in faults
        if f.get("recovered_ts") and f["recovered_ts"] >= f["ts"]
    ]
    job_span = 0.0
    if nodes:
        job_span = (max(n["last_end"] for n in nodes.values())
                    - min(n["first_start"] for n in nodes.values()))
    return {
        "job": {
            "wall_s": round(wall, 6),
            "span_s": round(job_span, 6),
            "nodes": len(nodes),
            "procs": len(procs),
            "training_s": round(phases[Phase.TRAINING], 6),
            # the serving tier's useful-work total: neither goodput
            # (training) nor badput — an inference replica's whole point
            "serving_s": round(phases[Phase.SERVING], 6),
            "goodput_percent": _pct(phases[Phase.TRAINING], wall),
            "attributed_percent": _pct(attributed, wall),
            "badput_s": {
                c: round(phases[c], 6) for c in BADPUT_CAUSES
            },
            "idle_s": round(phases[Phase.IDLE], 6),
            "faults": len(faults),
            "mttr_s": round(
                sum(mttr_samples) / len(mttr_samples), 6
            ) if mttr_samples else None,
            "mtbf_s": round(job_span / len(faults), 6)
            if faults and job_span > 0 else None,
        },
        "phases": {ph: round(v, 6) for ph, v in phases.items()},
        "nodes": {str(k): v for k, v in nodes.items()},
        "faults": faults,
    }


# ------------------------------------------------------------ HTTP surface


def set_job_provider(fn: Optional[Callable[..., Dict]]) -> None:
    """The master installs its aggregator's ``summary`` here so
    ``/goodput`` serves the job view; None clears (tests, stop). A
    provider accepting a ``job`` keyword serves ``/goodput?job=``."""
    global _job_provider
    with _state_lock:
        _job_provider = fn


def http_payload(job: Optional[str] = None) -> Dict[str, Any]:
    """What ``GET /goodput`` returns: the job account where a provider
    is installed (the master), always the local process ledger.
    ``job`` scopes the provider's account to one job namespace."""
    out: Dict[str, Any] = {"local": local_snapshot()}
    fn = _job_provider
    if fn is not None:
        try:
            out.update(fn(job=job) if job else fn())
        except TypeError:
            # pre-job provider: serve its fleet-wide account rather
            # than erroring a scoped query
            try:
                out.update(fn())
            except Exception as e:
                out["error"] = str(e)
        except Exception as e:
            out["error"] = str(e)
    if job:
        out["job_id"] = job
    return out


# -------------------------------------------------------- offline replay


#: the per-process ledger breadcrumbs the exact replay consumes
_LEDGER_KINDS = ("goodput.phase", "goodput.credit", "goodput.snapshot")


def _proc_key(event: Dict[str, Any]) -> Tuple[str, int]:
    return (str(event.get("host", "?")), int(event.get("pid", 0) or 0))


def _node_of(events: List[Dict[str, Any]]) -> int:
    """Node identity for offline grouping: the journal envelope's
    ``proc`` (the JAX process index / agent node id) when any event
    carries it, else the pid (every process its own node)."""
    for e in events:
        if e.get("proc") is not None:
            return int(e["proc"])
    return int(events[0].get("pid", 0) or 0) if events else 0


def reconstruct(events: List[Dict[str, Any]],
                job: Optional[str] = None) -> Dict[str, Any]:
    """Rebuild the goodput account from a journal's event list.

    Processes that journaled ``goodput.*`` breadcrumbs replay exactly
    (same transitions the live ledger made); processes from pre-ledger
    journals fall back to deriving phases from the generic events via
    :data:`EVENT_RULES`. Fault windows come from the events themselves
    (``fault.injected``/``fault.reported`` opened, next step /
    ``master.restored`` closure heuristics), so MTTR/MTBF exist even
    for runs that never ran the live aggregator. ``job`` filters to
    one job's envelope namespace (an envelope without a ``job`` field
    is the default job), so a shared journal splits back into per-job
    accounts."""
    if job is not None:
        events = [
            e for e in events
            if (e.get("job") or "default") == job
        ]
    by_proc: Dict[Tuple[str, int], List[Dict]] = {}
    for e in events:
        by_proc.setdefault(_proc_key(e), []).append(e)

    procs: Dict[str, Dict[str, Any]] = {}
    for (host, pid), evts in sorted(by_proc.items()):
        # only the per-process breadcrumbs count as "exact" — the
        # master's goodput.job_summary is an aggregate, not a ledger
        exact = [e for e in evts if e.get("kind") in _LEDGER_KINDS]
        led, start = _replay_exact(exact) if exact else (
            _replay_heuristic(evts)
        )
        if led is None:
            continue  # nothing phase-relevant from this process
        end_ts = max(float(e.get("ts", 0.0)) for e in evts)
        snap = led.snapshot(now=end_ts)
        procs[f"{host}:{pid}"] = {
            "node_id": _node_of(evts),
            "pid": pid,
            "job": next(
                (e["job"] for e in evts if e.get("job")), "default"
            ),
            "host": host,
            "start_ts": snap["start_ts"],
            "elapsed_s": snap["elapsed_s"],
            "phases": snap["phases"],
            "phase": snap["phase"],
            "last_report_ts": end_ts,
            "final_seen": any(
                e.get("kind") == "goodput.snapshot" for e in exact
            ),
            "exact": bool(exact),
        }

    out = summarize(procs, _fault_windows(events))
    out["procs"] = procs
    return out


def _replay_exact(goodput_events: List[Dict]):
    """Replay a process's own goodput.* breadcrumbs — bit-exact with
    what its live ledger did."""
    first = goodput_events[0]
    start = None
    for e in goodput_events:
        if e.get("kind") == "goodput.snapshot":
            start = float((e.get("data") or {}).get("start_ts", 0.0))
            break
    if start is None:
        # the birth breadcrumb (install()) carries the exact ledger
        # start; failing that, the first breadcrumb bounds it
        start = float(
            (first.get("data") or {}).get("at")
            or first.get("ts", 0.0)
        )
    led = PhaseLedger(start_ts=start, journal_events=False)
    for e in goodput_events:
        data = e.get("data") or {}
        ts = float(data.get("at") or e.get("ts") or 0.0)
        kind = e.get("kind")
        try:
            if kind == "goodput.phase":
                led.transition(data.get("phase", Phase.IDLE), ts=ts)
            elif kind == "goodput.credit":
                led.credit(data.get("phase", Phase.IDLE),
                           float(data.get("credit_s", 0.0)), ts=ts)
            elif kind == "goodput.snapshot":
                # authoritative final totals from the process itself
                led = _ledger_from_snapshot(data, fallback=led)
        except ValueError:
            continue  # an unknown phase label from a future version
    return led, start


def _ledger_from_snapshot(data: Dict, fallback: PhaseLedger):
    phases = data.get("phases") or {}
    if not phases:
        return fallback
    start = float(data.get("start_ts") or fallback.start_ts)
    led = PhaseLedger(start_ts=start, journal_events=False)
    led._totals = {p: float(phases.get(p, 0.0)) for p in PHASES}
    led._phase = data.get("phase") or Phase.IDLE
    if led._phase not in PHASES:
        led._phase = Phase.IDLE
    led._mark = start + float(data.get("elapsed_s", 0.0))
    led._closed = True
    return led


#: generic kinds that prove a process was doing phase-attributable
#: work (pre-ledger journals): drives the heuristic fallback. NOTE
#: ``fault.injected`` and ``reshard.aborted`` are deliberately absent
#: — the master records them too, and a master process must not be
#: mistaken for a training node.
_HEURISTIC_KINDS = (
    set(EVENT_RULES) - {"fault.injected", "reshard.aborted"}
) | {
    "distributed.init", "checkpoint.save", "checkpoint.restore",
}


def _replay_heuristic(evts: List[Dict]):
    """Pre-ledger journals: derive phases from the generic events via
    the same rules the live tap applies, plus two offline-only reads —
    a step-carrying checkpoint event proves training, and its
    ``duration_s``/``stall_ms`` re-labels the trailing stall."""
    relevant = [e for e in evts if e.get("kind") in _HEURISTIC_KINDS]
    if not relevant:
        return None, None
    start = float(evts[0].get("ts", 0.0))
    led = PhaseLedger(start_ts=start, journal_events=False)
    for e in evts:
        kind = str(e.get("kind", ""))
        ts = float(e.get("ts", 0.0))
        data = e.get("data") or {}
        rule = EVENT_RULES.get(kind)
        try:
            if rule is not None:
                rule(led, ts, data)
            elif kind == "checkpoint.save":
                # a save at step N proves the loop was training; its
                # measured stall re-labels the tail of that interval.
                # Credit BEFORE transitioning (transition moves the
                # mark to ts, which would leave nothing to re-label),
                # and at the event's ts — on_step() stamps wall-clock
                # "now", nonsense when replaying a historical journal
                stall_s = float(
                    data.get("stall_ms", 0.0) or 0.0
                ) / 1000.0
                if stall_s > 0:
                    led.credit(Phase.CKPT_STALL, stall_s, ts=ts)
                if led.phase != Phase.TRAINING:
                    led.transition(Phase.TRAINING, ts=ts)
        except ValueError:
            continue
    return led, start


def _fault_windows(events: List[Dict]) -> List[Dict[str, Any]]:
    """Fault windows from the raw timeline: injected/reported faults
    open one; the matching recovery event closes it."""
    faults: List[Dict[str, Any]] = []
    lost_at: Dict[Tuple[str, int], float] = {}
    for e in events:
        kind = e.get("kind")
        ts = float(e.get("ts", 0.0))
        data = e.get("data") or {}
        if kind == "fault.injected":
            faults.append({
                "cause": str(data.get("fault", "injected")),
                "node_id": e.get("proc"),
                "ts": ts, "recovered_ts": None,
            })
        elif kind == "agent.master_lost":
            lost_at.setdefault(_proc_key(e), ts)
        elif kind == "agent.master_reconnected":
            started = lost_at.pop(_proc_key(e), None)
            if started is not None:
                faults.append({
                    "cause": "master_restart",
                    "node_id": e.get("proc"),
                    "ts": started, "recovered_ts": ts,
                })
        elif kind == "hang.detected":
            faults.append({
                "cause": "hang", "node_id": e.get("proc"),
                "ts": ts, "recovered_ts": None,
            })
        elif kind == "anomaly.detected":
            faults.append({
                "cause": Phase.ROLLBACK, "node_id": e.get("proc"),
                "ts": ts, "recovered_ts": None,
            })
        elif kind in ("rollback.restored", "rollback.recovered"):
            # closes every rollback window still open at this point:
            # one incident's order covers all ranks that adopted it
            for f in faults:
                if (f["cause"] == Phase.ROLLBACK
                        and f["recovered_ts"] is None):
                    f["recovered_ts"] = ts
        elif kind == "reshard.ordered":
            # the MASTER journals the order; the casualty is the first
            # lost rank (a grow order has none — fall back to proc)
            lost = data.get("lost") or []
            faults.append({
                "cause": Phase.RESHARD,
                "node_id": lost[0] if lost else e.get("proc"),
                "ts": ts, "recovered_ts": None,
            })
        elif kind in ("reshard.completed", "reshard.aborted"):
            # one transition covers every rank that adopted the order;
            # an abort hands the incident to the restart-the-world
            # machinery, which opens its own windows
            for f in faults:
                if (f["cause"] == Phase.RESHARD
                        and f["recovered_ts"] is None):
                    f["recovered_ts"] = ts
    # an injected master crash recovers at master.restored; an injected
    # worker crash recovers when ANY later event from its node appears
    restored = [float(e.get("ts", 0.0)) for e in events
                if e.get("kind") == "master.restored"]
    for f in faults:
        if f["recovered_ts"] is not None:
            continue
        if "master" in f["cause"]:
            nxt = [t for t in restored if t >= f["ts"]]
            f["recovered_ts"] = min(nxt) if nxt else None
        else:
            nxt = [
                float(e.get("ts", 0.0)) for e in events
                if e.get("proc") == f["node_id"]
                and float(e.get("ts", 0.0)) > f["ts"]
                and not str(e.get("kind", "")).startswith("fault.")
            ]
            f["recovered_ts"] = min(nxt) if nxt else None
    return faults


# ------------------------------------------------------------- rendering


def render_report(report: Dict[str, Any]) -> str:
    """Human-readable ``dump --goodput`` output."""
    job = report.get("job") or {}
    lines = [
        "== goodput ==",
        (
            f"wall {job.get('wall_s', 0.0):.1f}s over "
            f"{job.get('nodes', 0)} node(s), "
            f"{job.get('procs', 0)} process(es)"
        ),
        (
            f"goodput {job.get('goodput_percent', 0.0):.1f}%  "
            f"(training {job.get('training_s', 0.0):.1f}s)  "
            f"attributed {job.get('attributed_percent', 0.0):.1f}%"
        ),
    ]
    badput = job.get("badput_s") or {}
    parts = [f"{c}={badput.get(c, 0.0):.1f}s" for c in BADPUT_CAUSES
             if badput.get(c, 0.0) > 0]
    lines.append("badput  " + (" ".join(parts) if parts else "none"))
    mttr, mtbf = job.get("mttr_s"), job.get("mtbf_s")
    lines.append(
        f"faults {job.get('faults', 0)}"
        + (f"  MTTR {mttr:.1f}s" if mttr is not None else "")
        + (f"  MTBF {mtbf:.1f}s" if mtbf is not None else "")
    )
    for f in report.get("faults") or []:
        rec = f.get("recovered_ts")
        dur = f"recovered +{rec - f['ts']:.1f}s" if rec else "open"
        node = f.get("node_id")
        lines.append(
            f"  fault {f.get('cause')}"
            + (f" node={node}" if node is not None else "")
            + f" at {f['ts']:.1f} ({dur})"
        )
    for key, p in sorted((report.get("procs") or {}).items()):
        ph = " ".join(
            f"{k}={v:.1f}" for k, v in p["phases"].items() if v > 0.005
        )
        lines.append(
            f"  proc {key} node={p['node_id']} "
            f"elapsed={p['elapsed_s']:.1f}s "
            f"[{'exact' if p.get('exact') else 'heuristic'}] {ph}"
        )
    return "\n".join(lines)


def dump_goodput(events: List[Dict[str, Any]],
                 as_json: bool = False,
                 job: Optional[str] = None) -> str:
    report = reconstruct(events, job=job)
    if as_json:
        return json.dumps(report, default=str, sort_keys=True)
    return render_report(report)


# registry hookup: the master refreshes these on every summary() so
# /metrics carries the headline numbers a dashboard wants
def export_metrics(summary: Dict[str, Any]) -> None:
    job = summary.get("job") or {}
    try:
        registry_mod.gauge(
            "dlrover_goodput_percent",
            "Fraction of job wall-clock spent training",
        ).set(float(job.get("goodput_percent") or 0.0))
        registry_mod.gauge(
            "dlrover_goodput_attributed_percent",
            "Fraction of job wall-clock attributed to any phase",
        ).set(float(job.get("attributed_percent") or 0.0))
        for cause, secs in (job.get("badput_s") or {}).items():
            registry_mod.gauge(
                "dlrover_badput_seconds",
                "Non-training wall-clock by cause", ["cause"],
            ).labels(cause=cause).set(float(secs))
        if job.get("mttr_s") is not None:
            registry_mod.gauge(
                "dlrover_job_mttr_seconds",
                "Mean time to recovery over observed faults",
            ).set(float(job["mttr_s"]))
        if job.get("mtbf_s") is not None:
            registry_mod.gauge(
                "dlrover_job_mtbf_seconds",
                "Mean time between observed faults",
            ).set(float(job["mtbf_s"]))
    except Exception as e:
        logger.warning("goodput metric export failed: %s", e)
