"""Unified telemetry, copied from ``dlrover_tpu/telemetry``: metrics
registry, event journal, exposition.

  * :mod:`~dlrover_tpu_torch.telemetry.registry` -- thread-safe counters,
    gauges, and label-aware histograms with Prometheus text + JSON
    exposition;
  * :mod:`~dlrover_tpu_torch.telemetry.journal` -- append-only structured
    JSONL event journal (monotonic seq, wall time, host/process
    attribution) all control-plane events write through;
  * :mod:`~dlrover_tpu_torch.telemetry.http` -- the stdlib ``/metrics``,
    ``/goodput``, ``/healthz`` and ``/journal`` (+ ``/debug/stacks``,
    ``/debug/trace``) endpoint the master and agents serve;
  * :mod:`~dlrover_tpu_torch.telemetry.tracing` -- low-overhead span
    timing with per-process write-through files and Chrome trace export;
  * :mod:`~dlrover_tpu_torch.telemetry.flight_recorder` -- crash-dump
    capture (all-thread stacks, span tail, journal tail, metrics
    snapshot) on hangs and SIGTERM;
  * :mod:`~dlrover_tpu_torch.telemetry.goodput` -- the goodput ledger:
    per-process phase state machine, job-level goodput %/badput by
    cause/MTTR/MTBF aggregation, ``/goodput`` + ``dump --goodput``;
  * :mod:`~dlrover_tpu_torch.telemetry.lockwatch` -- the runtime
    lock-order watchdog (``DLROVER_TPU_LOCKWATCH=1``);
  * ``python -m dlrover_tpu_torch.telemetry.dump`` renders a journal
    into a human-readable timeline (``--goodput`` replays it into the
    goodput report, ``--trace`` merges per-process span files into one
    Chrome trace).

None of them imports torch: the agent and the master load them. The
fleet roll-up (``fleet.py``) is not ported yet (ROADMAP.md, queue A).
"""

from dlrover_tpu_torch.telemetry.journal import (
    EventJournal,
    configure,
    default_journal,
    read_journal,
    record,
    set_default_journal,
)
from dlrover_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter,
    default_registry,
    gauge,
    histogram,
    set_default_registry,
)
from dlrover_tpu_torch.telemetry import tracing

__all__ = [
    "tracing",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "EventJournal",
    "counter",
    "gauge",
    "histogram",
    "record",
    "configure",
    "default_registry",
    "default_journal",
    "set_default_registry",
    "set_default_journal",
    "read_journal",
]
