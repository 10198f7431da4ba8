"""Coalesced delta status reporting — the agent side of the report lane.

Counterpart of ``dlrover_tpu/agent/status_reporter.py``. At fleet
scale the master's binding constraint is control-plane fan-in: N
agents x (heartbeat + global-step + goodput + resource) unary RPCs on
independent cadences. This module folds them into ONE
``report_node_status`` rpc per agent per interval with delta semantics:

* the heartbeat timestamp is always present (it IS the liveness signal);
* step / goodput / resource sections ride along only when they changed
  since the last *acked* report (``has_*`` gates on the wire message);
* the first report of an incarnation — and any report after the master
  replies ``resync=True`` (it restarted and lost the delta baseline) —
  is ``full=True`` and resends everything.

The master's pending action (restart, stop) rides back on the ack.
The report interval is jittered ±20% so a master restart doesn't get
the whole fleet's re-hellos back in phase. Left out of the JAX
reporter: the serving and fleet-digest sections, which wait for those
modules (ROADMAP.md, queue A), and its load-shed retry and its fallback
to the per-rpc heartbeat, since the port's master never sheds a report
and always serves the rpc.
"""

import os
import random
import socket
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import goodput as goodput_mod
from dlrover_tpu_torch.telemetry.journal import current_job_id, record

#: fractional interval jitter (0.2 = ±20%)
JITTER = 0.2
#: resend goodput/resource at least every N intervals even if
#: "unchanged" — bounds how stale a delta'd section can get when the
#: change detector's thresholds hide slow drift
DEFAULT_MAX_SKIP = 8
#: a phase total must advance this much to count as changed
GOODPUT_MIN_DELTA_S = 1.0
CPU_MIN_DELTA_PCT = 5.0
MEM_MIN_DELTA_MB = 64


class DeltaTracker:
    """Composes ``NodeStatusReport`` payloads against the last-acked
    baseline. Pure bookkeeping (no I/O)."""

    def __init__(self, incarnation: int = 0,
                 max_skip: int = DEFAULT_MAX_SKIP,
                 goodput_min_delta_s: float = GOODPUT_MIN_DELTA_S,
                 job_id: str = ""):
        self._incarnation = incarnation
        #: job namespace stamped into every composed report;
        #: the sparse wire omits the default, so single-job fleets are
        #: byte-identical to the pre-job format
        self.job_id = job_id or "default"
        self._seq = 0
        self._full_next = True
        self._max_skip = max(1, max_skip)
        self._goodput_min_delta = goodput_min_delta_s
        # last-ACKED baselines — only advanced by commit(), so a shed
        # or failed report never silently drops a delta
        self._acked_step = -1
        self._acked_cpu: Optional[float] = None
        self._acked_mem: Optional[int] = None
        self._acked_phases: Dict[str, float] = {}
        self._acked_phase = ""
        self._skipped_goodput = 0
        self._skipped_resource = 0

    def request_full(self):
        self._full_next = True

    def _goodput_changed(self, fields: Dict) -> bool:
        if fields.get("goodput_phase", "") != self._acked_phase:
            return True
        phases = fields.get("goodput_phases") or {}
        for name, total in phases.items():
            if abs(total - self._acked_phases.get(name, 0.0)) \
                    >= self._goodput_min_delta:
                return True
        return False

    def compose(self, timestamp: float,
                step: Optional[int] = None,
                step_ts: float = 0.0,
                pid: int = 0,
                goodput_fields: Optional[Dict] = None,
                resource: Optional[Tuple[float, int]] = None,
                host: str = "",
                final: bool = False,
                ) -> comm.NodeStatusReport:
        """Build the next report; bumps ``seq``. Retries of a shed
        report reuse the returned object — only an acked seq advances
        the baseline (see :meth:`commit`)."""
        self._seq += 1
        full = self._full_next
        report = comm.NodeStatusReport(
            timestamp=timestamp,
            incarnation=self._incarnation,
            seq=self._seq,
            full=full,
            final=final,
            job_id=self.job_id,
        )
        if full or final:
            # host only travels when someone reads it: the master
            # consumes it solely in the goodput ledger (and below when
            # a goodput section is attached) — steady-state deltas
            # stay host-free
            report.host = host or socket.gethostname()
        if step is not None and (full or step > self._acked_step):
            report.has_step = True
            report.step = step
            report.step_ts = step_ts or timestamp
            report.pid = pid
        if goodput_fields:
            self._skipped_goodput += 1
            if (full or final
                    or self._skipped_goodput >= self._max_skip
                    or self._goodput_changed(goodput_fields)):
                report.has_goodput = True
                report.pid = pid
                report.host = host or socket.gethostname()
                report.goodput_phases = dict(
                    goodput_fields.get("goodput_phases") or {}
                )
                report.goodput_elapsed_s = goodput_fields.get(
                    "goodput_elapsed_s", 0.0
                )
                report.goodput_start_ts = goodput_fields.get(
                    "goodput_start_ts", 0.0
                )
                report.goodput_phase = goodput_fields.get(
                    "goodput_phase", ""
                )
        if resource is not None:
            cpu, mem = resource
            self._skipped_resource += 1
            changed = (
                self._acked_cpu is None
                or abs(cpu - self._acked_cpu) >= CPU_MIN_DELTA_PCT
                or abs(mem - (self._acked_mem or 0)) >= MEM_MIN_DELTA_MB
            )
            if full or changed or self._skipped_resource >= self._max_skip:
                report.has_resource = True
                report.cpu_percent = cpu
                report.memory_mb = mem
        return report

    def commit(self, report: comm.NodeStatusReport):
        """Advance the acked baseline to what ``report`` carried."""
        self._full_next = False
        if report.has_step:
            self._acked_step = report.step
        if report.has_goodput:
            self._acked_phases = dict(report.goodput_phases)
            self._acked_phase = report.goodput_phase
            self._skipped_goodput = 0
        if report.has_resource:
            self._acked_cpu = report.cpu_percent
            self._acked_mem = report.memory_mb
            self._skipped_resource = 0


class StatusReporter:
    """The agent's reporting loop: one thread, one rpc per interval.

    ``on_action`` receives any pending NodeAction the master piggybacks
    on the ack — the same contract as the heartbeat response, so
    restart/stop directives arrive with zero extra RPCs."""

    def __init__(self, client, interval: float,
                 incarnation: int = 0,
                 on_action: Optional[Callable[[str], None]] = None):
        self._client = client
        self._interval = max(0.1, float(interval))
        self._on_action = on_action
        self._pid = os.getpid()
        self._tracker = DeltaTracker(
            incarnation=incarnation, job_id=current_job_id()
        )
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.sent = 0
        self.acked = 0
        self.resyncs = 0

    # ------------------------------------------------------------ lifecycle

    def start(self):
        record(
            "agent.report_interval",
            interval_s=self._interval,
            jitter_pct=int(JITTER * 100),
        )
        self._thread = threading.Thread(
            target=self._run, name="status-reporter", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _sleep_interval(self):
        self._stopped.wait(
            self._interval * random.uniform(1.0 - JITTER, 1.0 + JITTER)
        )

    def _run(self):
        while not self._stopped.is_set():
            try:
                self.tick_once()
            except Exception as e:
                # connection supervision already retried inside the
                # client; whatever still escapes must not kill the
                # liveness loop
                logger.warning("status report failed: %s", e)
                self._tracker.request_full()
            self._sleep_interval()

    # ----------------------------------------------------------- one report

    def tick_once(self):
        report = self._tracker.compose(
            time.time(), pid=self._pid,
            goodput_fields=goodput_mod.report_fields(),
        )
        self.sent += 1
        ack = self._client.report_node_status(report)
        self.acked += 1
        self._tracker.commit(report)
        if ack.resync:
            self.resyncs += 1
            record("report.resync", seq=report.seq)
            self._tracker.request_full()
        if ack.action and self._on_action:
            self._on_action(ack.action)
