"""Unified telemetry, copied from ``dlrover_tpu/telemetry``: the metrics
registry, the event journal and span tracing.

  * :mod:`~dlrover_tpu_torch.telemetry.registry` -- thread-safe counters,
    gauges, and label-aware histograms with Prometheus text + JSON
    exposition;
  * :mod:`~dlrover_tpu_torch.telemetry.journal` -- append-only structured
    JSONL event journal (monotonic seq, wall time, host/process
    attribution) all control-plane events write through;
  * :mod:`~dlrover_tpu_torch.telemetry.tracing` -- low-overhead span
    timing with per-process write-through files and Chrome trace export.

The ``/metrics`` endpoint (``http.py``), the flight recorder, the
goodput ledger and the fleet roll-up (``fleet.py``) are not ported yet
(ROADMAP.md, queue A), nor are their call sites.
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
