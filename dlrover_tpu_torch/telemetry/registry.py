"""Thread-safe metrics registry with Prometheus text exposition.

The observability substrate the master's decisions are only as good as
(cf. the failure-attribution telemetry underneath HSDP-scale
fault tolerance, arXiv:2602.00277): one process-wide registry that
counters, gauges, and histograms from every layer (servicer RPCs, speed
monitor, rendezvous, checkpoint, kernel tuning) register into, rendered
two ways:

  * ``to_prometheus_text()`` — the Prometheus text exposition format
    (v0.0.4), served by :mod:`dlrover_tpu_torch.telemetry.http` so a scraper
    pointed at the master/agent ``/metrics`` endpoint just works;
  * ``to_dict()`` — plain JSON for tests, ``bench.py`` detail fields,
    and offline dumps.

No prometheus_client dependency: the container must not grow deps, and
the subset needed here (three instrument kinds, labels, exposition) is
small and fully specified. Metric handles are get-or-create — the same
``counter(name)`` call at two sites shares one time series family, and
a re-declared name with a different kind is a hard error (silent type
drift is how dashboards rot).
"""

import json
import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "set_default_registry",
    "counter",
    "gauge",
    "histogram",
]

#: default histogram buckets — latency-shaped (seconds), 1ms..60s.
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(value: str) -> str:
    return (
        value.replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(float(v))


def _labels_key(
    labelnames: Sequence[str], labels: Dict[str, str]
) -> Tuple[str, ...]:
    # fast path: direct lookups; the set comparison only runs to build
    # the error, this is per-sample on every metric touch
    try:
        if len(labels) == len(labelnames):
            return tuple(str(labels[name]) for name in labelnames)
    except KeyError:
        pass
    raise ValueError(
        f"labels {sorted(labels)} != declared {sorted(labelnames)}"
    )


def _render_labels(
    labelnames: Sequence[str],
    key: Tuple[str, ...],
    extra: Optional[Tuple[str, str]] = None,
) -> str:
    pairs = [
        f'{n}="{_escape_label(v)}"' for n, v in zip(labelnames, key)
    ]
    if extra is not None:
        pairs.append(f'{extra[0]}="{_escape_label(extra[1])}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Metric:
    """Base: one metric family (name + kind + labelnames -> children)."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def labels(self, **labels):
        key = _labels_key(self.labelnames, labels)
        # lock-free read: dict get is atomic under the GIL and children
        # are only ever added, never replaced — the lock guards only
        # the create race
        child = self._children.get(key)
        if child is not None:
            return child
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
            return child

    def _default_child(self):
        """The no-labels child (metrics declared without labelnames)."""
        if self.labelnames:
            raise ValueError(
                f"{self.name} declares labels {self.labelnames}; "
                "use .labels(...)"
            )
        return self.labels()

    def _make_child(self):
        raise NotImplementedError

    def _snapshot(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return list(self._children.items())


class _CounterChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Counter(_Metric):
    kind = "counter"

    def _make_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0):
        self._default_child().inc(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class _GaugeChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float):
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Metric):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, value: float):
        self._default_child().set(value)

    def inc(self, amount: float = 1.0):
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0):
        self._default_child().dec(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class _HistogramChild:
    __slots__ = ("_lock", "_buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets: Tuple[float, ...]):
        self._lock = threading.Lock()
        self._buckets = buckets
        self._counts = [0] * len(buckets)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float):
        with self._lock:
            self._sum += value
            self._count += 1
            # per-bucket counts; snapshot() renders them cumulative
            for i, bound in enumerate(self._buckets):
                if value <= bound:
                    self._counts[i] += 1
                    break

    def snapshot(self) -> Dict:
        with self._lock:
            # cumulative per the exposition format; +Inf == _count
            cum, out = 0, []
            for bound, n in zip(self._buckets, self._counts):
                cum += n
                out.append((bound, cum))
            return {
                "buckets": out,
                "sum": self._sum,
                "count": self._count,
            }

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = bounds

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float):
        self._default_child().observe(value)

    def time(self):
        """Context manager observing the block's wall duration."""
        return _Timer(self)


class _Timer:
    def __init__(self, target):
        self._target = target

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._target.observe(time.perf_counter() - self._t0)
        return False


class MetricsRegistry:
    """Name -> metric family map; families are get-or-create."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kwargs) -> _Metric:
        # lock-free read first: families are only ever added, and the
        # declaration checks don't need the lock — this runs on every
        # counter()/gauge()/histogram() call on the RPC hot path
        existing = self._metrics.get(name)
        if existing is None:
            with self._lock:
                existing = self._metrics.get(name)
                if existing is None:
                    metric = cls(name, help, labelnames, **kwargs)
                    self._metrics[name] = metric
                    return metric
        if not isinstance(existing, cls):
            raise ValueError(
                f"metric {name} already registered as "
                f"{existing.kind}, not {cls.kind}"
            )
        if existing.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name} label mismatch: "
                f"{existing.labelnames} vs {tuple(labelnames)}"
            )
        return existing

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Iterable[float] = DEFAULT_BUCKETS,
                  ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    # ------------------------------------------------------------ exposition

    def to_prometheus_text(self) -> str:
        """The text exposition format (v0.0.4) a Prometheus scraper
        consumes from ``GET /metrics``."""
        with self._lock:
            families = sorted(self._metrics.items())
        lines: List[str] = []
        for name, metric in families:
            lines.append(f"# HELP {name} {_escape_help(metric.help)}")
            lines.append(f"# TYPE {name} {metric.kind}")
            for key, child in metric._snapshot():
                if isinstance(child, _HistogramChild):
                    snap = child.snapshot()
                    for bound, cum in snap["buckets"]:
                        lab = _render_labels(
                            metric.labelnames, key,
                            ("le", _format_value(float(bound))),
                        )
                        lines.append(f"{name}_bucket{lab} {cum}")
                    inf_lab = _render_labels(
                        metric.labelnames, key, ("le", "+Inf")
                    )
                    lines.append(
                        f"{name}_bucket{inf_lab} {snap['count']}"
                    )
                    lab = _render_labels(metric.labelnames, key)
                    lines.append(
                        f"{name}_sum{lab} "
                        f"{_format_value(snap['sum'])}"
                    )
                    lines.append(f"{name}_count{lab} {snap['count']}")
                else:
                    lab = _render_labels(metric.labelnames, key)
                    lines.append(
                        f"{name}{lab} {_format_value(child.value)}"
                    )
        return "\n".join(lines) + "\n"

    def to_dict(self) -> Dict:
        """JSON-friendly snapshot (tests/bench)."""
        out: Dict = {}
        with self._lock:
            families = sorted(self._metrics.items())
        for name, metric in families:
            series = {}
            for key, child in metric._snapshot():
                skey = ",".join(
                    f"{n}={v}"
                    for n, v in zip(metric.labelnames, key)
                )
                if isinstance(child, _HistogramChild):
                    snap = child.snapshot()
                    series[skey] = {
                        "sum": snap["sum"],
                        "count": snap["count"],
                        "buckets": {
                            _format_value(float(b)): c
                            for b, c in snap["buckets"]
                        },
                    }
                else:
                    series[skey] = child.value
            out[name] = {"kind": metric.kind, "series": series}
        return out

    def to_json(self, **kwargs) -> str:
        return json.dumps(self.to_dict(), **kwargs)


_default_lock = threading.Lock()
_default: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """The process-wide registry every instrumented module writes to."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default


def set_default_registry(
    registry: Optional[MetricsRegistry],
) -> MetricsRegistry:
    """Swap the process default (tests); None installs a fresh one."""
    global _default
    with _default_lock:
        _default = registry or MetricsRegistry()
        return _default


def counter(name: str, help: str = "",
            labelnames: Sequence[str] = ()) -> Counter:
    """Get-or-create on the default registry (the instrumentation
    entry point: call at the observation site, cheap dict lookup)."""
    return default_registry().counter(name, help, labelnames)


def gauge(name: str, help: str = "",
          labelnames: Sequence[str] = ()) -> Gauge:
    return default_registry().gauge(name, help, labelnames)


def histogram(name: str, help: str = "",
              labelnames: Sequence[str] = (),
              buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
    return default_registry().histogram(
        name, help, labelnames, buckets=buckets
    )
