"""Global-step throughput monitor + per-host straggler diagnosis.

Parity reference: dlrover/python/master/monitor/speed_monitor.py:43
(GlobalStepRecord, collect_global_step:81, running_speed:113).

Straggler scoring: every ``report_global_step`` RPC carries
the reporting host's node_id, so the monitor keeps a per-host window of
step durations (the host's own report cadence — seconds per step seen
from that host). A host whose rolling median runs more than
``straggler_ratio`` × the fleet's rolling median for
``straggler_window`` consecutive evaluations is journaled as
``straggler.detected`` and surfaces in :meth:`straggler_ranks`, the
hint the auto-scaler (``master/node/job_auto_scaler.py``, not ported
yet) unions with the network-check verdicts.
Training is collective, so one slow host drags EVERY host's cadence —
but the straggler's reports arrive late relative to its own previous
reports only when the slowness is local (data stall, host-side GC,
thermal throttle), which is exactly the case the network-check probe
cannot see once training started.
"""

import os
import time
from collections import deque
from dataclasses import dataclass
from statistics import median
from typing import Deque, Dict, List, Optional, Set, Tuple

from dlrover_tpu_torch.common.global_context import Context
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import counter, gauge, histogram, record

_context = Context.singleton_instance()

#: per-host step durations: millisecond steps up to multi-minute ones
_STEP_BUCKETS = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    60.0, 300.0,
)


@dataclass
class GlobalStepRecord:
    global_step: int
    timestamp: float
    worker_num: int


class SpeedMonitor:
    """Sliding window of global-step records -> running speed (steps/s)."""

    def __init__(self, straggler_ratio: Optional[float] = None,
                 straggler_window: Optional[int] = None):
        self._global_step_records: List[GlobalStepRecord] = []
        self._workers: Set[Tuple[str, int]] = set()
        self._max_record_count = _context.train_speed_record_num
        self._global_step = 0
        self._target_worker_num = 0
        self._init_time = time.time()
        self._start_training_time: Optional[float] = None
        self._sample_count = 0
        self._task_completed_times: Dict[int, float] = {}
        self._has_step_reports = False
        self._batches_done = 0
        # ---- per-host straggler scoring state ----
        # a host is flagged when its rolling-median step duration runs
        # > straggler_ratio x the fleet median for straggler_window
        # consecutive evaluations (persistence beats one slow sample)
        if straggler_ratio is None:
            straggler_ratio = float(
                os.getenv("DLROVER_TPU_STRAGGLER_RATIO", "1.5")
            )
        if straggler_window is None:
            straggler_window = int(
                os.getenv("DLROVER_TPU_STRAGGLER_WINDOW", "3")
            )
        self._straggler_ratio = max(1.01, straggler_ratio)
        self._straggler_window = max(1, straggler_window)
        self._host_last: Dict[int, Tuple[int, float]] = {}
        self._host_durations: Dict[int, Deque[float]] = {}
        self._straggler_strikes: Dict[int, int] = {}
        self._stragglers: Set[int] = set()
        # ---- swarm-scale bounds ----
        # per-host state and per-node metric labels are the master's
        # only per-node-UNBOUNDED memory: at 10k nodes the duration
        # deques alone are tens of MB and every report pays an
        # O(hosts) scoring pass. Cap the tracked set (evict the
        # stalest reporter), cap the metric label space (first-come),
        # and rate-limit scoring once the fleet outgrows small sizes.
        self._host_cap = max(2, int(
            os.getenv("DLROVER_TPU_SPEED_HOST_CAP", "256")
        ))
        self._labeled_nodes: Set[int] = set()
        self._score_interval = float(
            os.getenv("DLROVER_TPU_STRAGGLER_SCORE_INTERVAL", "0.5")
        )
        self._last_score = 0.0
        self._host_stale_s = float(
            os.getenv("DLROVER_TPU_SPEED_HOST_STALE_S", "60")
        )
        self._last_evict_scan = 0.0
        # master state journal hook: listener(step, batch_feed) fires
        # when the max step advances, throttled to one write per
        # ``step_persist_interval`` seconds (0 = every advance — used
        # when the journal's group-commit lane does the coalescing)
        self._step_listener = None
        self._step_persist_interval = 1.0
        self._last_step_persist = 0.0

    def set_step_listener(self, listener, persist_interval: float = 1.0):
        self._step_listener = listener
        self._step_persist_interval = max(0.0, persist_interval)

    def restore_global_step(self, global_step: int,
                            batch_feed: bool = False):
        """Master-restart restore. ``batch_feed`` records which unit the
        old master was counting in — restoring a batch-fed count as a
        real step would silence the batch feed forever."""
        self._global_step = max(self._global_step, int(global_step))
        if batch_feed:
            self._batches_done = max(self._batches_done, int(global_step))
        else:
            self._has_step_reports = self._has_step_reports or (
                global_step > 0
            )

    def set_target_worker_num(self, worker_num: int):
        self._target_worker_num = worker_num

    def reduce_target_worker_num(self, workers):
        num = len([w for w in workers if w in self._workers])
        self._target_worker_num -= num

    def add_running_worker(self, node_type: str, node_id: int):
        self._workers.add((node_type, node_id))
        gauge(
            "dlrover_training_workers",
            "Workers the speed monitor counts as running",
        ).set(len(self._workers))

    def remove_running_worker(self, node_type: str, node_id: int):
        self._workers.discard((node_type, node_id))
        gauge(
            "dlrover_training_workers",
            "Workers the speed monitor counts as running",
        ).set(len(self._workers))
        # a removed host's history must not keep skewing the fleet
        # median (nor keep it on the straggler list after eviction)
        self._evict_host(node_id)

    @property
    def running_workers(self):
        return self._workers

    def set_start_timestamp(self):
        if self._global_step == 0 and not self._start_training_time:
            self._start_training_time = time.time()

    @property
    def start_training_time(self):
        return self._start_training_time or 0

    @property
    def completed_global_step(self):
        return self._global_step

    def collect_global_step(self, global_step: int, timestamp: float,
                            _source: str = "step",
                            node_id: Optional[int] = None):
        if _source == "step" and node_id is not None and node_id >= 0:
            self._observe_host_step(node_id, global_step, timestamp)
        if _source == "step" and not self._has_step_reports:
            self._has_step_reports = True
            if self._batches_done:
                # step source takes over from the batch feed: drop the
                # batch-unit records — one mixed delta would put a
                # wildly inflated speed sample into the scaler's window
                self._global_step_records.clear()
                self._global_step = 0
        advanced = global_step > self._global_step
        self._global_step = max(self._global_step, global_step)
        if (
            self._step_listener is not None
            and advanced
            and timestamp - self._last_step_persist
            >= self._step_persist_interval
        ):
            self._last_step_persist = timestamp
            try:
                self._step_listener(
                    self._global_step, _source == "batch"
                )
            except Exception:
                pass  # journal IO must never fail a step report
        if not self._start_training_time:
            self._start_training_time = time.time()
        self._global_step_records.append(
            GlobalStepRecord(global_step, timestamp, len(self._workers))
        )
        self._sample_count += 1
        if len(self._global_step_records) > self._max_record_count:
            self._global_step_records.pop(0)
        # scrape-able training telemetry: the same numbers the scaler
        # and hang watchdog act on, visible at GET /metrics
        gauge(
            "dlrover_training_steps_per_second",
            "Windowed global-step throughput (speed monitor)",
        ).set(self.running_speed())
        gauge(
            "dlrover_training_global_step",
            "Max global step reported to the master",
        ).set(self._global_step)

    def collect_batch_done(self, batches: int, timestamp: float):
        """Shard-fed jobs with INDEPENDENT workers (the reference's
        PS/DeepRec shape — docs/blogs/deeprec_autoscale_cn.md) have no
        collective global step; the job-wide completed-task count
        drives the same speed window so throughput-driven autoscaling
        works identically. A job that reports real global steps keeps
        step semantics: the batch feed defers to it (mixing the two
        units would corrupt the window's deltas)."""
        if self._has_step_reports:
            return
        self._batches_done += batches
        self.collect_global_step(
            self._batches_done, timestamp, _source="batch"
        )

    # ------------------------------------------------ straggler diagnosis

    def _observe_host_step(self, node_id: int, global_step: int,
                           timestamp: float) -> None:
        """Fold one host's step report into its duration window, then
        re-score. Durations are per-host deltas between the host's OWN
        consecutive reports — cross-host clock skew cancels out."""
        last = self._host_last.get(node_id)
        if last is None and len(self._host_last) >= self._host_cap:
            # tracked set full: admit the newcomer only by evicting a
            # STALE incumbent (stopped reporting), found by a scan
            # rate-limited to 1/s — at 10k nodes an O(cap) scan per
            # untracked report would itself be the fan-in tax. Live
            # incumbents keep their window; the newcomer's report is
            # counted as untracked and dropped from straggler scoring
            # (the fleet median needs A bounded sample, not every
            # host).
            now_mono = time.monotonic()
            evicted = False
            if now_mono - self._last_evict_scan >= 1.0:
                self._last_evict_scan = now_mono
                stalest = min(
                    self._host_last, key=lambda n: self._host_last[n][1]
                )
                if timestamp - self._host_last[stalest][1] \
                        > self._host_stale_s:
                    self._evict_host(stalest)
                    counter(
                        "dlrover_speed_monitor_hosts_evicted_total",
                        "Stale hosts evicted from straggler tracking "
                        "at the cap",
                    ).inc()
                    evicted = True
            if not evicted:
                counter(
                    "dlrover_speed_monitor_untracked_reports_total",
                    "Step reports from hosts beyond the tracking cap",
                ).inc()
                return
        self._host_last[node_id] = (global_step, timestamp)
        if last is None:
            return
        s0, t0 = last
        if global_step <= s0 or timestamp <= t0:
            return  # restart/replay or duplicate report: no signal
        duration = (timestamp - t0) / (global_step - s0)
        # per-node labels are first-come bounded at the cap: label
        # churn across evictions would otherwise grow the registry's
        # series count with every node the job ever saw
        if (node_id in self._labeled_nodes
                or len(self._labeled_nodes) < self._host_cap):
            self._labeled_nodes.add(node_id)
            histogram(
                "dlrover_host_step_duration_seconds",
                "Per-host step duration seen from that host's reports",
                ["node"], buckets=_STEP_BUCKETS,
            ).labels(node=str(node_id)).observe(duration)
        durs = self._host_durations.setdefault(
            node_id, deque(maxlen=self._max_record_count)
        )
        durs.append(duration)
        # per-report scoring is O(hosts): free at lab size, a fleet
        # tax at 10k — rate-limit once the fleet outgrows small sizes
        if len(self._host_durations) > 32:
            now = time.monotonic()
            if now - self._last_score < self._score_interval:
                return
            self._last_score = now
        self._score_stragglers()

    def _evict_host(self, node_id: int) -> None:
        self._host_last.pop(node_id, None)
        self._host_durations.pop(node_id, None)
        self._straggler_strikes.pop(node_id, None)
        if node_id in self._stragglers:
            self._stragglers.discard(node_id)
            self._set_straggler_gauge()

    def _set_straggler_gauge(self) -> None:
        gauge(
            "dlrover_straggler_hosts",
            "Hosts currently flagged by the step-cadence scorer",
        ).set(len(self._stragglers))

    def _score_stragglers(self) -> None:
        """One scoring pass over the per-host rolling medians. Needs
        at least two samples per host and two reporting hosts — a
        fleet of one has no peer to be slower than."""
        per_host = {
            n: median(d)
            for n, d in self._host_durations.items() if len(d) >= 2
        }
        if len(per_host) < 2:
            return
        fleet = median(per_host.values())
        if fleet <= 0:
            return
        for node_id, dur in per_host.items():
            ratio = dur / fleet
            if node_id in self._labeled_nodes:
                gauge(
                    "dlrover_host_step_duration_ratio",
                    "Host rolling-median step duration over fleet median",
                    ["node"],
                ).labels(node=str(node_id)).set(round(ratio, 3))
            if dur > self._straggler_ratio * fleet:
                strikes = self._straggler_strikes.get(node_id, 0) + 1
                self._straggler_strikes[node_id] = strikes
                if (
                    strikes >= self._straggler_window
                    and node_id not in self._stragglers
                ):
                    self._stragglers.add(node_id)
                    self._set_straggler_gauge()
                    counter(
                        "dlrover_stragglers_detected_total",
                        "Hosts flagged by the step-cadence scorer",
                    ).inc()
                    record(
                        "straggler.detected", node=node_id,
                        step_duration_s=round(dur, 4),
                        fleet_median_s=round(fleet, 4),
                        ratio=round(ratio, 3),
                        window=self._straggler_window,
                        step=self._global_step,
                    )
                    logger.warning(
                        "Straggler: node %d runs %.2fx the fleet "
                        "median step time (%.3fs vs %.3fs)",
                        node_id, ratio, dur, fleet,
                    )
            else:
                self._straggler_strikes.pop(node_id, None)
                if node_id in self._stragglers:
                    self._stragglers.discard(node_id)
                    self._set_straggler_gauge()
                    record(
                        "straggler.recovered", node=node_id,
                        step_duration_s=round(dur, 4),
                        fleet_median_s=round(fleet, 4),
                        step=self._global_step,
                    )

    def straggler_ranks(self) -> List[int]:
        """Hosts currently over the straggler threshold — the speed
        hint the auto-scaler unions with network-check verdicts."""
        return sorted(self._stragglers)

    def host_step_durations(self) -> Dict[int, float]:
        """Per-host rolling-median step duration (diagnostics/tests)."""
        return {
            n: median(d)
            for n, d in self._host_durations.items() if d
        }

    def running_speed(self) -> float:
        """Steps/sec over the windowed records of the CURRENT world
        size (0 if insufficient data). Windowed, not last-two: with
        event-driven feeds (per-task batch completions) two records
        can land microseconds apart, and a 1/dt estimator over
        near-simultaneous events produces divergent spike samples that
        would dominate the scaler's per-worker means. Restricting to
        the last record's worker_num keeps a membership change from
        blending two incarnations' rates."""
        records = self._global_step_records
        if len(records) < 2:
            return 0.0
        wn = records[-1].worker_num
        # contiguous TRAILING run only: an earlier incarnation at the
        # same size (grow -> shrink -> regrow) would otherwise blend
        # the slow middle span into the current rate
        same = []
        for r in reversed(records):
            if r.worker_num != wn:
                break
            same.append(r)
        if len(same) < 2:
            return 0.0
        last, first = same[0], same[-1]
        dt = last.timestamp - first.timestamp
        if dt <= 0:
            return 0.0
        return (last.global_step - first.global_step) / dt

    def worker_adjustment_finished(self) -> bool:
        """All target workers present and speed samples collected since."""
        if not self._global_step_records:
            return False
        worker_num = self._global_step_records[-1].worker_num
        if worker_num != self._target_worker_num:
            return False
        sample_count = _context.train_speed_record_num
        records = self._global_step_records
        if len(records) < sample_count:
            return False
        return all(
            r.worker_num == worker_num for r in records[-sample_count:]
        )

    def add_task_completed(self, node_id: int, elapsed: float):
        self._task_completed_times[node_id] = elapsed

    def worker_hanged(self, hang_seconds: float) -> bool:
        """True when training has started but no global-step sample
        arrived within ``hang_seconds`` (parity: resource-stagnation hang
        signal, dist_job_manager.py:662 / training_node.py:297)."""
        if not self._global_step_records:
            return bool(
                self._start_training_time
                and time.time() - self._start_training_time
                > hang_seconds
            )
        last = self._global_step_records[-1]
        return time.time() - last.timestamp > hang_seconds

    def all_worker_joined(self) -> bool:
        return (
            self._target_worker_num > 0
            and len(self._workers) >= self._target_worker_num
        )
