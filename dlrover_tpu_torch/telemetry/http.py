"""Tiny stdlib HTTP endpoint serving the telemetry surface.

A copy of ``dlrover_tpu/telemetry/http.py``. Runs on the master, on
each agent and, for the peer checkpoint tier, in each training process
(a scraper federates the fleet by
hitting every host). Routes:

  * ``GET /metrics``  — Prometheus text exposition of the registry;
  * ``GET /metrics.json`` — the same snapshot as JSON (tests/bench);
  * ``GET /journal``  — a bounded tail of the event journal. Default
    view is the in-memory ring (``?n=50`` bounds it, clamped to the
    ring capacity; ``?kind=checkpoint`` filters by kind prefix);
    ``?source=file`` tails the backing JSONL file instead — last ``n``
    lines, reading at most 256 KiB from the end — so long runs never
    stream an unbounded journal through the endpoint;
  * ``GET /goodput`` — the goodput ledger (telemetry/goodput.py): the
    local process's phase snapshot, plus the job-level aggregation
    (goodput %, badput by cause, MTTR/MTBF) when this process is the
    master;
  * ``GET /fleet`` / ``GET /fleet.json`` — the master's fleet
    observability plane (telemetry/fleet.py): per-series quantiles
    rolled up from relay-carried digests, per-host breakdown, top-k
    stragglers, counters and SLO state — text summary or the raw
    snapshot document. 404 until a provider is attached
    (:func:`set_fleet_provider`); the port has no fleet plane yet, so
    it answers 404 everywhere;
  * ``GET /healthz``  — liveness probe. With a hang detector attached
    (:func:`attach_hang_detector`) a stalled training loop turns the
    probe into 503 + ``{"status": "degraded", "stalled_for": ...}`` so
    a K8s liveness/readiness probe can act on hangs, not just deaths;
  * ``GET /debug/stacks`` — live all-thread Python stacks (the flight
    recorder's view, on demand);
  * ``GET /debug/trace`` — the span ring as Chrome trace-event JSON
    (``?n=500`` bounds it); load it in Perfetto / chrome://tracing;
  * ``GET /ckpt/shard`` — the peer checkpoint tier (format v2,
    ``checkpoint/peer.py``): serves this process's RAM-tier archives to
    restoring peers (``?step=N&what=manifest`` for the archive
    manifest, ``?step=N&path=...&idx=...`` for one raw member). 404
    until a provider is attached (:func:`set_shard_provider` or the
    ``shard_provider`` constructor arg).

stdlib ``ThreadingHTTPServer`` on a daemon thread: no dependency, no
lifecycle coupling — the process exiting takes the server with it, and
``stop()`` exists for tests. Port 0 binds an ephemeral port (read
``.port`` after ``start()``); ``DLROVER_TPU_METRICS_PORT=off`` disables
the servers the master/agent start by default.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import journal as journal_mod
from dlrover_tpu_torch.telemetry import registry as registry_mod

ENV_METRICS_PORT = "DLROVER_TPU_METRICS_PORT"

_DISABLED = ("off", "none", "-1")

__all__ = [
    "ENV_METRICS_PORT",
    "MetricsServer",
    "start_metrics_server",
    "attach_hang_detector",
    "set_health_check",
    "set_shard_provider",
    "set_fleet_provider",
]

# -------------------------------------------------------------- health state
#
# Module-level, not per-server: the HangingDetector lives wherever the
# training loop runs, the server wherever the process started one — a
# process-global attach point means whichever server this process runs
# reports the degradation without threading a reference through every
# constructor.

_health_lock = threading.Lock()
_health_check = None  # () -> Optional[dict]; truthy dict == degraded


def set_health_check(fn) -> None:
    """Install the process-wide degraded-state probe: a zero-arg
    callable returning None when healthy, or a JSON-able payload dict
    when degraded (served as 503). None clears it."""
    global _health_check
    with _health_lock:
        _health_check = fn


def attach_hang_detector(detector) -> None:
    """Point ``/healthz`` at a
    :class:`~dlrover_tpu_torch.fault_tolerance.hanging_detector.
    HangingDetector`: while it observes a stall the probe answers 503
    with the stall age, so an orchestrator can restart a hung (but
    alive) process."""

    def check():
        if not detector.is_hanged():
            return None
        return {
            "stalled_for": round(detector.stalled_for(), 1),
            "threshold": round(detector.timeout(), 1),
            "last_step": detector.last_step,
        }

    set_health_check(check)


# The checkpoint peer tier uses the same attach pattern: the
# FlashCheckpointer lives in the trainer, the server wherever the
# process started one. Per-server overrides (MetricsServer's
# ``shard_provider`` arg) exist for tests that run several virtual
# hosts in one process.

_shard_lock = threading.Lock()
_shard_provider = None  # (step: int) -> Optional[path to RAM archive]


def set_shard_provider(fn) -> None:
    """Install the process-wide checkpoint shard provider backing
    ``/ckpt/shard``: a callable mapping a step to this host's RAM-tier
    archive path (None when not held). None clears it."""
    global _shard_provider
    with _shard_lock:
        _shard_provider = fn


def _current_shard_provider(server):
    override = getattr(server, "shard_provider", None)
    if override is not None:
        return override
    with _shard_lock:
        return _shard_provider


# The fleet plane attaches the same way: the FleetAggregator lives on
# the master object, the server wherever the process started one.

_fleet_lock = threading.Lock()
_fleet_provider = None  # () -> dict (FleetAggregator.snapshot document)


def set_fleet_provider(fn) -> None:
    """Install the process-wide fleet snapshot provider backing
    ``/fleet``: a callable returning the snapshot document
    (``FleetAggregator.snapshot`` of the JAX package's
    ``telemetry/fleet.py``, not ported yet). A provider accepting a
    ``job`` keyword serves ``/fleet?job=`` per-job views; a zero-arg
    provider keeps working and answers every query fleet-wide. None
    clears it."""
    global _fleet_provider
    with _fleet_lock:
        _fleet_provider = fn


def _current_fleet_provider():
    with _fleet_lock:
        return _fleet_provider


def _format_fleet_text(doc) -> str:
    """Human-first rendering of the fleet snapshot: the view an
    operator curls during an incident."""
    lines = ["# fleet observability plane"]
    lines.append(
        "sources=%d digests=%d store_bytes=%d" % (
            doc.get("sources", 0), doc.get("digests", 0),
            doc.get("store_bytes", 0),
        )
    )
    series = doc.get("series") or {}
    if series:
        lines.append("")
        lines.append("## series (current window)")
        for name in sorted(series):
            s = series[name]
            lines.append(
                "%-12s n=%-8d p50=%.1fms p90=%.1fms p99=%.1fms "
                "max=%.1fms" % (
                    name, s.get("count", 0), s.get("p50_ms", 0.0),
                    s.get("p90_ms", 0.0), s.get("p99_ms", 0.0),
                    s.get("max_ms", 0.0),
                )
            )
    counters = doc.get("counters") or {}
    if counters:
        lines.append("")
        lines.append("## counters")
        for name in sorted(counters):
            lines.append("%-32s %d" % (name, counters[name]))
    stragglers = doc.get("stragglers") or []
    if stragglers:
        lines.append("")
        lines.append("## stragglers (top-%d behind)" % len(stragglers))
        for h in stragglers:
            lines.append(
                "%-24s step=%-10d behind=%d" % (
                    h.get("host", "?"), h.get("step", -1),
                    h.get("behind", 0),
                )
            )
    slo = doc.get("slo")
    if slo:
        lines.append("")
        lines.append("## slo")
        for name in sorted(slo):
            obj = slo[name]
            lines.append(
                "%-20s %s %s value=%s %s" % (
                    name, obj.get("op"), obj.get("target"),
                    obj.get("value"),
                    "VIOLATED" if obj.get("violated") else "ok",
                )
            )
    return "\n".join(lines) + "\n"


def _current_health():
    with _health_lock:
        check = _health_check
    if check is None:
        return None
    try:
        return check()
    except Exception as e:  # a broken probe must read as healthy-ish,
        # not take the endpoint down
        logger.warning("health check failed: %s", e)
        return None


# /journal response bounds: never more than this many events, and the
# file-tail mode reads at most this many bytes from the end of the
# JSONL file (a long run's journal grows without limit; the endpoint
# must not)
_JOURNAL_TAIL_MAX = 4096
_FILE_TAIL_BYTES = 256 * 1024


def _tail_one_file(path):
    """Parsed events from the last ``_FILE_TAIL_BYTES`` of one JSONL
    file. Never raises."""
    try:
        with open(path, "rb") as f:
            f.seek(0, 2)
            size = f.tell()
            f.seek(max(0, size - _FILE_TAIL_BYTES))
            chunk = f.read(_FILE_TAIL_BYTES)
    except OSError:
        return []
    lines = chunk.split(b"\n")
    if size > _FILE_TAIL_BYTES and lines:
        lines = lines[1:]  # first line is almost surely torn mid-record
    events = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            events.append(json.loads(line))
        except (json.JSONDecodeError, UnicodeDecodeError):
            continue
    return events


def _tail_journal_file(path, n, kind=None):
    """Last ``n`` parsed events from the end of a JSONL journal file,
    reading at most ``_FILE_TAIL_BYTES`` per file. When the current
    file is short of ``n`` (e.g. rotation just happened), the rotated
    predecessor ``<path>.1`` fills the head — the tail reads across the
    rotation boundary (ENV_JOURNAL_MAX_MB). Never raises."""
    events = _tail_one_file(path)
    if len(events) < n:
        events = _tail_one_file(path + ".1")[
            - max(0, n - len(events)):
        ] + events
    if kind:
        events = [
            e for e in events
            if e.get("kind") == kind
            or str(e.get("kind", "")).startswith(kind + ".")
        ]
    return events[-n:]


class _Handler(BaseHTTPRequestHandler):
    server_version = "dlrover-tpu-telemetry/1"

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (stdlib API name)
        url = urlparse(self.path)
        reg = self.server.registry  # type: ignore[attr-defined]
        jr = self.server.journal  # type: ignore[attr-defined]
        if url.path == "/metrics":
            body = reg.to_prometheus_text().encode()
            # the content type Prometheus scrapers negotiate for the
            # text format
            self._send(
                200, body,
                "text/plain; version=0.0.4; charset=utf-8",
            )
        elif url.path == "/metrics.json":
            self._send(
                200, reg.to_json().encode(), "application/json"
            )
        elif url.path == "/journal":
            q = parse_qs(url.query)
            kind = (q.get("kind") or [None])[0]
            try:
                n = int((q.get("n") or ["100"])[0])
            except ValueError:
                n = 100
            # hard tail bound: the response can never exceed the ring
            # capacity (or _FILE_TAIL_BYTES in file mode), however
            # large ?n= is or however long the run has journaled
            n = max(0, min(n, _JOURNAL_TAIL_MAX))
            source = (q.get("source") or ["ring"])[0]
            if source == "file" and jr is not None and jr.path:
                events = _tail_journal_file(jr.path, n, kind)
            else:
                events = jr.events(kind)[-n:] if jr else []
            self._send(
                200, json.dumps(events, default=str).encode(),
                "application/json",
            )
        elif url.path == "/goodput":
            from dlrover_tpu_torch.telemetry import goodput

            job = (parse_qs(url.query).get("job") or [None])[0]
            self._send(
                200,
                json.dumps(
                    goodput.http_payload(job=job), default=str
                ).encode(),
                "application/json",
            )
        elif url.path in ("/fleet", "/fleet.json"):
            provider = _current_fleet_provider()
            if provider is None:
                self._send(
                    404, b'{"error": "no fleet aggregator"}\n',
                    "application/json",
                )
            else:
                job = (parse_qs(url.query).get("job") or [None])[0]
                try:
                    if job:
                        try:
                            doc = provider(job=job) or {}
                        except TypeError:
                            # pre-job provider: fleet-wide answer
                            # beats a 500 on a scoped query
                            doc = provider() or {}
                    else:
                        doc = provider() or {}
                except Exception as e:
                    logger.warning("fleet snapshot failed: %s", e)
                    doc = {"error": str(e)}
                if url.path == "/fleet.json":
                    self._send(
                        200, json.dumps(doc, default=str).encode(),
                        "application/json",
                    )
                else:
                    self._send(
                        200, _format_fleet_text(doc).encode(),
                        "text/plain; charset=utf-8",
                    )
        elif url.path == "/healthz":
            degraded = _current_health()
            if degraded:
                body = json.dumps(
                    {"status": "degraded", **degraded}, default=str
                ).encode()
                self._send(503, body, "application/json")
            else:
                self._send(200, b"ok\n", "text/plain")
        elif url.path == "/debug/stacks":
            from dlrover_tpu_torch.telemetry import flight_recorder

            self._send(
                200, flight_recorder.format_stacks().encode(),
                "text/plain; charset=utf-8",
            )
        elif url.path == "/debug/trace":
            from dlrover_tpu_torch.telemetry import tracing

            q = parse_qs(url.query)
            try:
                n = int((q.get("n") or ["500"])[0])
            except ValueError:
                n = 500
            body = json.dumps(
                tracing.chrome_trace(tracing.tail(n)), default=str
            ).encode()
            self._send(200, body, "application/json")
        elif url.path == "/ckpt/shard":
            provider = _current_shard_provider(self.server)
            if provider is None:
                self._send(
                    404, b'{"error": "no shard provider"}\n',
                    "application/json",
                )
            else:
                from dlrover_tpu_torch.checkpoint import peer as peer_mod

                code, body, ctype = peer_mod.handle_shard_request(
                    url.query, provider
                )
                self._send(code, body, ctype)
        else:
            self._send(404, b"not found\n", "text/plain")

    def log_message(self, format, *args):
        # scrapes every few seconds must not spam the job log
        pass


class MetricsServer:
    """Threaded exposition server over a registry (+ journal tail)."""

    def __init__(
        self,
        registry: Optional[registry_mod.MetricsRegistry] = None,
        journal: Optional[journal_mod.EventJournal] = None,
        host: str = "0.0.0.0",
        port: int = 0,
        shard_provider=None,
    ):
        self._registry = registry or registry_mod.default_registry()
        self._journal = journal or journal_mod.default_journal()
        self._host = host
        self._requested_port = port
        self._shard_provider = shard_provider
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return (
            self._httpd.server_address[1]
            if self._httpd else self._requested_port
        )

    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            return self
        self._httpd = ThreadingHTTPServer(
            (self._host, self._requested_port), _Handler
        )
        self._httpd.daemon_threads = True
        self._httpd.registry = self._registry  # type: ignore[attr-defined]
        self._httpd.journal = self._journal  # type: ignore[attr-defined]
        if self._shard_provider is not None:
            self._httpd.shard_provider = (  # type: ignore[attr-defined]
                self._shard_provider
            )
        # stop() waits up to one poll interval (the standard library's
        # default is 0.5 s, paid at every master's and worker's exit)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            daemon=True,
            name="telemetry-http",
        )
        self._thread.start()
        logger.info("telemetry endpoint on port %d (/metrics)", self.port)
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def start_metrics_server(
    default_port: int = 0,
    registry: Optional[registry_mod.MetricsRegistry] = None,
    journal: Optional[journal_mod.EventJournal] = None,
) -> Optional[MetricsServer]:
    """Start the exposition endpoint honoring the env contract:
    ``DLROVER_TPU_METRICS_PORT`` overrides the port, ``off`` disables.
    Returns None when disabled or the bind fails — telemetry must never
    take the master/agent down."""
    import os

    raw = os.getenv(ENV_METRICS_PORT, "").strip().lower()
    if raw in _DISABLED:
        return None
    port = default_port
    if raw:
        try:
            port = int(raw)
        except ValueError:
            logger.warning(
                "%s=%r not a port; using %d", ENV_METRICS_PORT, raw,
                default_port,
            )
    try:
        return MetricsServer(
            registry=registry, journal=journal, port=port
        ).start()
    except OSError as e:
        logger.warning("telemetry endpoint failed to bind: %s", e)
        return None
