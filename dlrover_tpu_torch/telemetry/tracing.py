"""Low-overhead span tracing with Chrome/Perfetto trace export.

The layer the metrics and the journal cannot provide: *where time went*
inside one process. A counter says the step took 4 s; a span timeline
says 3.2 s of it was the data wait on host 2. Systems operating elastic
jobs at scale (ElasWave, arxiv 2510.00606; the 100k-GPU HSDP report,
arxiv 2602.00277) treat per-rank timelines as load-bearing for hang and
straggler attribution — this module is that substrate, sized so it can
stay wired into the hot paths permanently:

  * **disabled cost < 1 µs and allocation-free**: ``span(name)`` checks
    one module global and returns a shared no-op context manager — no
    object is created, so a train loop crossing dozens of span sites
    per step pays nanoseconds when tracing is off
    (``benchmarks/trace_overhead.py`` measures it);
  * **lock-free ring**: finished spans append to a bounded
    ``collections.deque`` — a single CPython bytecode op (GIL-atomic),
    no lock on the record path; the tail is always available to the
    flight recorder and ``GET /debug/trace`` even when nothing was
    configured;
  * **journal envelope**: every record carries host, pid, process
    index, and the current training step (:func:`set_step`), so spans
    and journal events join into one attributable timeline;
  * **cross-process merge**: with ``DLROVER_TPU_TRACE_DIR`` set each
    process appends records to its own ``spans-<host>-<pid>.jsonl``
    (same atomic ``O_APPEND`` discipline as the journal), and
    ``python -m dlrover_tpu_torch.telemetry.dump <dir> --trace`` merges every
    process's file into ONE Chrome trace-event JSON loadable in
    ``chrome://tracing`` / Perfetto;
  * **cross-process causality**: a W3C-style trace context
    (trace id + parent span id) rides a ``contextvars.ContextVar``.
    Every enabled span allocates a span id, parents itself under the
    current context and installs itself as the context for its body —
    so nested spans chain naturally, and an RPC issued inside a span
    carries ``traceparent()`` as gRPC metadata
    (common/grpc_utils.py injects/extracts it). The merge links
    cross-process parent/child edges with Perfetto flow events. All of
    this lives strictly behind the ``_enabled`` check: the disabled
    path is still one global read + the shared no-op.

Usage::

    from dlrover_tpu_torch.telemetry import tracing

    with tracing.span("data_load"):
        batch = next(it)

    tracing.add_span("rdzv.training", started_ts, duration_s,
                     attrs={"round": 3})        # retroactive span

Enable with ``DLROVER_TPU_TRACE=1`` (in-memory ring only) or
``DLROVER_TPU_TRACE_DIR=/path`` (ring + per-process span files), or
programmatically via :func:`enable`.
"""

import contextvars
import itertools
import json
import os
import socket
import threading
import time
import zlib
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from dlrover_tpu_torch.common.log import current_process_index
from dlrover_tpu_torch.common.log import default_logger as logger

ENV_TRACE = "DLROVER_TPU_TRACE"
ENV_TRACE_DIR = "DLROVER_TPU_TRACE_DIR"
ENV_TRACE_RING = "DLROVER_TPU_TRACE_RING"

__all__ = [
    "ENV_TRACE",
    "ENV_TRACE_DIR",
    "TRACE_METADATA_KEY",
    "span",
    "add_span",
    "set_step",
    "current_step",
    "enable",
    "disable",
    "enabled",
    "tail",
    "clear",
    "summarize",
    "chrome_trace",
    "merge_trace_dir",
    "read_span_file",
    "current_context",
    "trace_context",
    "traceparent",
    "parse_traceparent",
]

#: gRPC metadata key the trace context crosses process boundaries under
#: (grpc metadata keys must be lowercase)
TRACE_METADATA_KEY = "dlrover-trace"

#: the ONE branch the hot path pays when tracing is off — a module
#: global read; everything else lives behind it.
_enabled = False

_lock = threading.Lock()
_ring: deque = deque(maxlen=4096)
_fd: Optional[int] = None
_path: Optional[str] = None
_host = socket.gethostname()
_step = -1  # current training step (int store/load is GIL-atomic)

# ----------------------------------------------------------- trace context

#: (trace_id, span_id) of the innermost live span / extracted RPC
#: parent; contextvars give per-thread AND per-asyncio-task isolation.
_context: contextvars.ContextVar[Optional[Tuple[str, str]]] = (
    contextvars.ContextVar("dlrover_trace_context", default=None)
)

#: span/trace ids: host-hash + pid prefix + monotonic counter. Unique
#: fleet-wide without an os.urandom syscall per span; ``next()`` on
#: itertools.count is GIL-atomic. Subprocesses re-import, so the
#: prefix re-derives per process.
_id_prefix = "%04x%04x" % (
    zlib.crc32(_host.encode()) & 0xFFFF, os.getpid() & 0xFFFF
)
_id_counter = itertools.count(1)


def _new_id() -> str:
    return _id_prefix + "%08x" % (next(_id_counter) & 0xFFFFFFFF)


def current_context() -> Optional[Tuple[str, str]]:
    """The live (trace_id, span_id) pair, or None outside any trace."""
    return _context.get()


class trace_context:
    """Install an extracted trace context for a block — the server side
    of propagation: ``with trace_context(trace_id, span_id): handle()``
    makes every span in the handler a child of the remote caller's
    span. ``trace_context(None, None)`` (or falsy ids) is a no-op pass-
    through, so extraction sites need no conditional."""

    __slots__ = ("_trace", "_span", "_tok")

    def __init__(self, trace_id: Optional[str], span_id: Optional[str]):
        self._trace = trace_id
        self._span = span_id
        self._tok = None

    def __enter__(self):
        if self._trace and self._span:
            self._tok = _context.set((self._trace, self._span))
        return self

    def __exit__(self, *exc):
        if self._tok is not None:
            try:
                _context.reset(self._tok)
            except ValueError:
                # reset from a different context (generator hop):
                # nothing to restore, the context died with its task
                pass
            self._tok = None
        return False


def traceparent() -> Optional[str]:
    """The outbound wire form ``<trace_id>-<span_id>`` for the current
    context, or None when tracing is off / no trace is live. The ONE
    call RPC clients make per request — a module-global check first, so
    the disabled fleet pays a few nanoseconds."""
    if not _enabled:
        return None
    ctx = _context.get()
    if ctx is None:
        return None
    return ctx[0] + "-" + ctx[1]


def parse_traceparent(value: str) -> Tuple[Optional[str], Optional[str]]:
    """Split a wire ``traceparent`` back into (trace_id, span_id);
    malformed input degrades to (None, None), never raises — a bad
    header must not take down an RPC handler."""
    if not value or not isinstance(value, str):
        return None, None
    trace_id, sep, span_id = value.partition("-")
    if not sep or not trace_id or not span_id:
        return None, None
    return trace_id, span_id


class _NoopSpan:
    """Shared disabled-path context manager: no state, no allocation.
    Class-level ids so call sites can read ``sp.span_id`` unguarded."""

    __slots__ = ()

    trace_id: Optional[str] = None
    span_id: Optional[str] = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    """A live span: wall-clock start (cross-process alignment) plus a
    perf_counter duration (monotonic, immune to clock steps). On entry
    it joins the current trace (or roots a new one), allocates its span
    id and becomes the context for its body — children and outbound
    RPCs parent under it."""

    __slots__ = ("_name", "_attrs", "_ts", "_t0",
                 "trace_id", "span_id", "_parent", "_tok")

    def __init__(self, name: str, attrs: Optional[Dict[str, Any]]):
        self._name = name
        self._attrs = attrs

    def __enter__(self):
        ctx = _context.get()
        self.span_id = _new_id()
        if ctx is not None:
            self.trace_id, self._parent = ctx
        else:
            # no live trace: this span roots one, so an RPC issued in
            # its body starts a cross-process chain
            self.trace_id = _new_id()
            self._parent = None
        self._tok = _context.set((self.trace_id, self.span_id))
        self._ts = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        try:
            _context.reset(self._tok)
        except ValueError:
            pass  # exited in a different context (generator hop)
        _finish(self._name, self._ts, dur, self._attrs,
                error=exc_type is not None,
                trace=self.trace_id, span=self.span_id,
                parent=self._parent)
        return False


def span(name: str, attrs: Optional[Dict[str, Any]] = None):
    """Context manager timing a block. When tracing is disabled this
    returns a shared no-op object — sub-microsecond and allocation-free,
    safe to leave in a train loop permanently. ``attrs`` (a plain dict,
    deliberately not ``**kwargs`` — a kwargs catch-all would allocate
    even on the disabled path) lands in the record and the Chrome
    ``args`` pane."""
    if not _enabled:
        return _NOOP
    return _Span(name, attrs)


def add_span(name: str, start_ts: float, duration_s: float,
             attrs: Optional[Dict[str, Any]] = None) -> None:
    """Record a span retroactively from timestamps already measured
    (rendezvous rounds, checkpoint staging — paths that track their own
    start time). Joins the current trace context as a leaf child when
    one is live. No-op while tracing is disabled."""
    if not _enabled:
        return
    ctx = _context.get()
    if ctx is not None:
        _finish(name, start_ts, max(0.0, duration_s), attrs,
                trace=ctx[0], span=_new_id(), parent=ctx[1])
    else:
        _finish(name, start_ts, max(0.0, duration_s), attrs)


def set_step(step: int) -> None:
    """Tag subsequent spans (and flight records) with the training
    step. Called by ``ElasticTrainer.report_step``; always live, even
    with tracing disabled, so a flight record knows the last step."""
    global _step
    _step = int(step)


def current_step() -> int:
    return _step


def _finish(name: str, ts: float, dur: float,
            attrs: Optional[Dict[str, Any]], error: bool = False,
            trace: Optional[str] = None, span: Optional[str] = None,
            parent: Optional[str] = None) -> None:
    th = threading.current_thread()
    rec = {
        "name": name,
        "ts": ts,
        "dur": dur,
        "host": _host,
        "pid": os.getpid(),
        "proc": current_process_index(),
        "tid": th.ident or 0,
        "thread": th.name,
        "step": _step,
    }
    if trace is not None:
        rec["trace"] = trace
    if span is not None:
        rec["span"] = span
    if parent is not None:
        rec["parent"] = parent
    if attrs:
        rec["attrs"] = attrs
    if error:
        rec["error"] = True
    # deque.append is a single C-level op under the GIL: lock-free
    _ring.append(rec)
    fd = _fd
    if fd is not None:
        try:
            os.write(fd, (json.dumps(rec, default=str) + "\n").encode())
        except OSError as e:
            _close_file()
            logger.warning(
                "span file write failed (%s); ring-only from here", e
            )


# ----------------------------------------------------------- configuration


def enable(trace_dir: Optional[str] = None,
           capacity: Optional[int] = None) -> None:
    """Turn the span sites on. ``trace_dir`` additionally streams every
    record to this process's ``spans-<host>-<pid>.jsonl`` inside it (the
    input to ``dump --trace``); without it spans live only in the ring.
    ``capacity`` resizes the ring (losing its current contents)."""
    global _enabled, _ring
    with _lock:
        if capacity is not None and capacity != _ring.maxlen:
            _ring = deque(_ring, maxlen=max(1, capacity))
        if trace_dir:
            _open_file(trace_dir)
        _enabled = True


def disable() -> None:
    """Stop recording; the ring keeps its tail for post-mortems."""
    global _enabled
    with _lock:
        _enabled = False
        _close_file()


def enabled() -> bool:
    return _enabled


def span_file_path() -> Optional[str]:
    """This process's write-through span file (None when ring-only)."""
    return _path


def _open_file(trace_dir: str) -> None:
    global _fd, _path
    _close_file()
    try:
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(
            trace_dir, f"spans-{_host}-{os.getpid()}.jsonl"
        )
        _fd = os.open(
            path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
        )
        _path = path
    except OSError as e:
        logger.warning(
            "trace dir %s unavailable (%s); spans stay in-memory",
            trace_dir, e,
        )
        _fd = None
        _path = None


def _close_file() -> None:
    global _fd, _path
    if _fd is not None:
        try:
            os.close(_fd)
        except OSError:
            pass
    _fd = None
    _path = None


def _configure_from_env() -> None:
    """Import-time arming, mirroring the journal's env contract: the
    launcher exports one variable and master, agent, and every worker
    inherit it."""
    ring = os.getenv(ENV_TRACE_RING, "").strip()
    capacity = None
    if ring.isdigit():
        capacity = int(ring)
    trace_dir = os.getenv(ENV_TRACE_DIR, "").strip()
    flag = os.getenv(ENV_TRACE, "").strip().lower()
    if trace_dir:
        enable(trace_dir, capacity=capacity)
    elif flag not in ("", "0", "off", "false"):
        enable(capacity=capacity)
    elif capacity is not None:
        enable(capacity=capacity)
        disable()


# ----------------------------------------------------------------- reading


def tail(n: int = 100) -> List[Dict[str, Any]]:
    """Newest ``n`` records, oldest first. Snapshot under the lock so a
    concurrent writer can't mutate mid-iteration."""
    with _lock:
        records = list(_ring)
    return records[-max(0, n):]


def clear() -> None:
    with _lock:
        _ring.clear()


def summarize(names: Optional[Iterable[str]] = None,
              records: Optional[List[Dict[str, Any]]] = None,
              ) -> Dict[str, Dict[str, float]]:
    """Aggregate span durations by name:
    ``{name: {count, mean_ms, max_ms, total_ms}}``. ``names`` filters;
    ``records`` defaults to the whole ring (bench.py's per-phase
    breakdown reads this)."""
    if records is None:
        records = tail(len(_ring) if _ring.maxlen is None else _ring.maxlen)
    wanted = set(names) if names is not None else None
    out: Dict[str, Dict[str, float]] = {}
    for rec in records:
        name = rec.get("name", "?")
        if wanted is not None and name not in wanted:
            continue
        agg = out.setdefault(
            name, {"count": 0, "mean_ms": 0.0, "max_ms": 0.0,
                   "total_ms": 0.0}
        )
        ms = float(rec.get("dur", 0.0)) * 1e3
        agg["count"] += 1
        agg["total_ms"] += ms
        if ms > agg["max_ms"]:
            agg["max_ms"] = ms
    for agg in out.values():
        if agg["count"]:
            agg["mean_ms"] = agg["total_ms"] / agg["count"]
    return out


# ------------------------------------------------------------ Chrome export


def _chrome_events(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Trace-event "X" (complete) events plus process/thread metadata.
    Parent/child span edges that cross a process boundary additionally
    get Perfetto flow events ("s" on the parent slice, "f" on the
    child) so the viewer draws the causal arrow worker → relay →
    master. Deterministic: events sorted by (ts, pid, tid, name, ph) so
    merging the same inputs always yields byte-identical output."""
    events: List[Dict[str, Any]] = []
    procs: Dict[int, Dict[str, Any]] = {}
    threads: Dict[tuple, str] = {}
    #: span id -> its record, for cross-process flow linking
    by_span: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        sid = rec.get("span")
        if sid:
            by_span.setdefault(str(sid), rec)
    for rec in records:
        pid = int(rec.get("pid", 0))
        tid = int(rec.get("tid", 0))
        args = dict(rec.get("attrs") or {})
        step = rec.get("step", -1)
        if step is not None and step >= 0:
            args["step"] = step
        if rec.get("error"):
            args["error"] = True
        for key in ("trace", "span", "parent"):
            if rec.get(key):
                args[key] = rec[key]
        events.append({
            "ph": "X",
            "name": str(rec.get("name", "?")),
            "cat": "dlrover",
            "ts": round(float(rec.get("ts", 0.0)) * 1e6, 3),
            "dur": round(float(rec.get("dur", 0.0)) * 1e6, 3),
            "pid": pid,
            "tid": tid,
            "args": args,
        })
        parent = rec.get("parent")
        if parent and str(parent) in by_span:
            prec = by_span[str(parent)]
            if int(prec.get("pid", 0)) != pid:
                # cross-process causal edge: one flow per child, id'd
                # by the child span so every edge is distinct
                flow_id = str(rec.get("span") or parent)
                events.append({
                    "ph": "s", "id": flow_id, "name": "trace",
                    "cat": "dlrover.flow",
                    "ts": round(float(prec.get("ts", 0.0)) * 1e6, 3),
                    "pid": int(prec.get("pid", 0)),
                    "tid": int(prec.get("tid", 0)),
                })
                events.append({
                    "ph": "f", "bp": "e", "id": flow_id,
                    "name": "trace", "cat": "dlrover.flow",
                    "ts": round(float(rec.get("ts", 0.0)) * 1e6, 3),
                    "pid": pid,
                    "tid": tid,
                })
        if pid not in procs:
            proc = rec.get("proc")
            host = rec.get("host", "?")
            label = f"{host} pid {pid}" + (
                f" proc {proc}" if proc is not None else ""
            )
            procs[pid] = {
                "label": label,
                "sort": proc if isinstance(proc, int) else pid,
            }
        threads.setdefault((pid, tid), str(rec.get("thread", tid)))
    events.sort(key=lambda e: (
        e["ts"], e["pid"], e["tid"], e["name"], e["ph"],
    ))
    meta: List[Dict[str, Any]] = []
    for pid in sorted(procs):
        meta.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": procs[pid]["label"]},
        })
        meta.append({
            "ph": "M", "name": "process_sort_index", "pid": pid,
            "tid": 0, "args": {"sort_index": procs[pid]["sort"]},
        })
    for (pid, tid) in sorted(threads):
        meta.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": threads[(pid, tid)]},
        })
    return meta + events


def chrome_trace(records: Optional[List[Dict[str, Any]]] = None) -> Dict:
    """The Chrome trace-event JSON object for ``records`` (default:
    this process's ring tail) — what ``GET /debug/trace`` serves."""
    if records is None:
        records = tail(
            _ring.maxlen if _ring.maxlen is not None else len(_ring)
        )
    return {
        "traceEvents": _chrome_events(records),
        "displayTimeUnit": "ms",
    }


def read_span_file(path: str) -> List[Dict[str, Any]]:
    """Parse one ``spans-*.jsonl`` file; torn lines from a crashed
    writer are skipped, not fatal (same contract as read_journal)."""
    records = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return records


def read_trace_dir(path: str) -> List[Dict[str, Any]]:
    """Every process's span records under ``path`` (or from a single
    ``.jsonl`` file), in deterministic file order — the raw-record view
    ``dump --trace`` filters before rendering."""
    records: List[Dict[str, Any]] = []
    if os.path.isdir(path):
        names = sorted(
            n for n in os.listdir(path)
            if n.startswith("spans-") and n.endswith(".jsonl")
        )
        for name in names:
            records.extend(read_span_file(os.path.join(path, name)))
    else:
        records.extend(read_span_file(path))
    return records


def merge_trace_dir(path: str) -> Dict:
    """Merge every process's span file under ``path`` (or a single
    ``.jsonl`` file) into one Chrome trace object. Deterministic for a
    fixed set of input files — diffable across re-runs of the merge."""
    return {
        "traceEvents": _chrome_events(read_trace_dir(path)),
        "displayTimeUnit": "ms",
    }


_configure_from_env()
