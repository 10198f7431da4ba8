"""``python -m dlrover_tpu_torch.telemetry.dump`` — render a journal timeline.

A copy of ``dlrover_tpu/telemetry/dump.py``.

Turns the JSONL event journal (telemetry/journal.py) into a
human-readable incident timeline: one line per event, wall-clock
ordered across processes, with the delta to the previous event so
stalls stand out. ``--kind`` filters (prefix match on dotted kinds),
``--json`` re-emits the ordered events as JSONL (for piping into jq
after the multi-process sort).

``--goodput`` switches modes: instead of the raw timeline, the journal
is replayed through the goodput reconstruction
(telemetry/goodput.py) into the job-wide time-attribution report —
goodput %, badput by cause, fault windows with MTTR/MTBF, and one
phase breakdown per process. Works on any journal file: runs that
carried the live ledger replay exactly from their ``goodput.*``
breadcrumbs; older journals fall back to deriving phases from the
generic events. ``--json`` emits the report as JSON.

``--trace`` switches modes: the path is a trace directory written by
span tracing (``DLROVER_TPU_TRACE_DIR`` — one ``spans-<host>-<pid>.
jsonl`` per process) and the output is ONE merged Chrome trace-event
JSON covering every process, loadable in Perfetto / chrome://tracing
(``-o merged.json`` writes a file; default stdout). A multi-hour
trace is unloadable whole, so ``--trace`` composes filters applied
BEFORE the merge: ``--since <ts>`` (unix seconds or
``YYYY-MM-DD[ HH:MM:SS]``) keeps spans starting at/after the stamp,
``--step N..M`` (or a single ``N``; open ends allowed, ``100..``)
keeps spans stamped with a global step in the range, ``--proc <id>``
keeps one process (matches the JAX process index or the OS pid).
Cross-process flow arrows are recomputed over the surviving spans.

``--job <id>`` (any mode) keeps one job's records when several jobs
share a journal or trace dir (job-scoped telemetry):
events/spans without a ``job`` stamp belong to job ``default``.

Example::

    $ python -m dlrover_tpu_torch.telemetry.dump /tmp/job.journal
    2026-08-04 10:00:01.202 +0.000s [host-0 p0] rendezvous.complete  round=1 nodes=[0, 1] duration_s=2.1
    2026-08-04 10:00:43.910 +42.708s [host-0 p0] checkpoint.save     tier=ram step=100 ms=18.2

    $ python -m dlrover_tpu_torch.telemetry.dump /tmp/job-trace --trace -o merged.json

    $ python -m dlrover_tpu_torch.telemetry.dump /tmp/job.journal --goodput
    == goodput ==
    wall 58.2s over 2 node(s), 3 process(es)
    goodput 87.3%  (training 50.8s)  attributed 99.6%
    badput  rendezvous=2.1s ckpt_stall=0.9s restart=4.2s
    faults 2  MTTR 2.6s  MTBF 29.1s
"""

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.telemetry.journal import read_journal

def _fmt_value(v) -> str:
    if isinstance(v, float):
        return f"{v:.3f}".rstrip("0").rstrip(".")
    return str(v)


def format_event(event: Dict, prev_ts: Optional[float] = None) -> str:
    ts = event.get("ts", 0.0)
    stamp = time.strftime(
        "%Y-%m-%d %H:%M:%S", time.localtime(ts)
    ) + f".{int((ts % 1) * 1000):03d}"
    delta = "" if prev_ts is None else f" +{ts - prev_ts:.3f}s"
    proc = event.get("proc")
    who = f"{event.get('host', '?')} p{proc if proc is not None else '?'}"
    data = event.get("data") or {}
    payload = " ".join(
        f"{k}={_fmt_value(v)}" for k, v in data.items()
    )
    kind = event.get("kind", "?")
    return f"{stamp}{delta} [{who}] {kind:<22s} {payload}".rstrip()


def render(events: List[Dict], kind: Optional[str] = None,
           as_json: bool = False) -> str:
    if kind:
        events = [
            e for e in events
            if e.get("kind") == kind
            or str(e.get("kind", "")).startswith(kind + ".")
        ]
    if as_json:
        return "\n".join(json.dumps(e, default=str) for e in events)
    lines = []
    prev: Optional[float] = None
    for e in events:
        lines.append(format_event(e, prev))
        prev = e.get("ts", prev)
    return "\n".join(lines)


def _parse_since(text: str) -> float:
    """``--since`` value -> unix seconds. Accepts a raw float or a
    local wall-clock stamp (the format the timeline mode prints)."""
    try:
        return float(text)
    except ValueError:
        pass
    for fmt in ("%Y-%m-%d %H:%M:%S", "%Y-%m-%dT%H:%M:%S", "%Y-%m-%d"):
        try:
            return time.mktime(time.strptime(text, fmt))
        except ValueError:
            continue
    raise ValueError(
        f"--since {text!r}: want unix seconds or YYYY-MM-DD[ HH:MM:SS]"
    )


def _parse_step_range(text: str):
    """``"N..M"`` -> (N, M); ``"N"`` -> (N, N); open ends (``"N.."``,
    ``"..M"``) -> None on that side."""
    if ".." in text:
        lo, _, hi = text.partition("..")
        return (int(lo) if lo else None, int(hi) if hi else None)
    v = int(text)
    return (v, v)


def filter_events_by_job(events: List[Dict], job: str) -> List[Dict]:
    """``--job`` filter for journal events: an envelope without a
    ``job`` field belongs to the default job (only non-default jobs
    stamp the key — journal.py keeps single-job envelopes unchanged)."""
    return [
        e for e in events if (e.get("job") or "default") == job
    ]


def filter_spans(records: List[Dict], since: Optional[float] = None,
                 steps=None, proc: Optional[int] = None,
                 job: Optional[str] = None) -> List[Dict]:
    """Apply the --trace filters to raw span records (seconds-valued
    ``ts``). ``--step`` drops spans with no step stamp — a range query
    asks for the training timeline, unstamped setup spans are noise."""
    out = []
    for rec in records:
        if job is not None \
                and (rec.get("job") or "default") != job:
            continue
        if since is not None and float(rec.get("ts", 0.0)) < since:
            continue
        if steps is not None:
            step = rec.get("step")
            if step is None or step < 0:
                continue
            lo, hi = steps
            if (lo is not None and step < lo) \
                    or (hi is not None and step > hi):
                continue
        if proc is not None and rec.get("proc") != proc \
                and rec.get("pid") != proc:
            continue
        out.append(rec)
    return out


def dump_trace(path: str, out: str = "",
               since: Optional[float] = None, steps=None,
               proc: Optional[int] = None,
               job: Optional[str] = None) -> int:
    """Merge a span-trace directory (or one span file) into a single
    Chrome trace JSON; deterministic for fixed inputs. Filters run on
    the raw records, so flow arrows only connect surviving spans."""
    from dlrover_tpu_torch.telemetry import tracing

    try:
        records = tracing.read_trace_dir(path)
    except OSError as e:
        print(f"cannot read {path}: {e}", file=sys.stderr)
        return 2
    total = len(records)
    if since is not None or steps is not None or proc is not None \
            or job is not None:
        records = filter_spans(
            records, since=since, steps=steps, proc=proc, job=job
        )
        print(
            f"-- filters kept {len(records)}/{total} spans",
            file=sys.stderr,
        )
    trace = tracing.chrome_trace(records)
    events = trace["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    pids = sorted({e["pid"] for e in spans})
    body = json.dumps(trace, default=str, sort_keys=True)
    if out:
        with open(out, "w") as f:
            f.write(body)
    else:
        print(body)
    print(
        f"-- {len(spans)} spans from {len(pids)} process(es)"
        f" {pids if pids else ''}"
        + (f" -> {out}" if out else ""),
        file=sys.stderr,
    )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dlrover_tpu_torch.telemetry.dump",
        description="Render an event journal as a readable timeline, "
        "or merge a span-trace directory into Chrome trace JSON",
    )
    ap.add_argument(
        "journal",
        help="path to the JSONL journal file (or, with --trace, the "
        "trace directory holding per-process spans-*.jsonl files)",
    )
    ap.add_argument("--kind", default=None,
                    help="filter by event kind (dotted-prefix match)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit ordered JSONL instead of the timeline")
    ap.add_argument(
        "--goodput", action="store_true", dest="as_goodput",
        help="replay the journal into the goodput/badput/MTTR report "
        "instead of the raw timeline (honors --json)",
    )
    ap.add_argument(
        "--trace", action="store_true", dest="as_trace",
        help="merge per-process span files into one Chrome "
        "trace-event JSON (chrome://tracing / Perfetto)",
    )
    ap.add_argument(
        "-o", "--out", default="",
        help="with --trace: write the merged trace here (default "
        "stdout)",
    )
    ap.add_argument(
        "--since", default=None,
        help="with --trace: keep spans starting at/after this time "
        "(unix seconds or YYYY-MM-DD[ HH:MM:SS], local)",
    )
    ap.add_argument(
        "--step", default=None, dest="step_range",
        help="with --trace: keep spans stamped with a global step in "
        "N..M (single N, open ends '100..' / '..200' allowed)",
    )
    ap.add_argument(
        "--proc", default=None, type=int,
        help="with --trace: keep one process (JAX process index or "
        "OS pid)",
    )
    ap.add_argument(
        "--job", default=None,
        help="keep one job's events/spans (envelope 'job' field; "
        "events without one belong to 'default')",
    )
    args = ap.parse_args(argv)
    if args.as_trace:
        try:
            since = (
                _parse_since(args.since)
                if args.since is not None else None
            )
            steps = (
                _parse_step_range(args.step_range)
                if args.step_range is not None else None
            )
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        return dump_trace(
            args.journal, args.out, since=since, steps=steps,
            proc=args.proc, job=args.job,
        )
    try:
        events = read_journal(args.journal)
    except OSError as e:
        print(f"cannot read {args.journal}: {e}", file=sys.stderr)
        return 2
    if args.job is not None:
        events = filter_events_by_job(events, args.job)
    if args.as_goodput:
        from dlrover_tpu_torch.telemetry.goodput import dump_goodput

        print(dump_goodput(events, as_json=args.as_json,
                           job=args.job))
        print(f"-- {len(events)} events replayed", file=sys.stderr)
        return 0
    out = render(events, kind=args.kind, as_json=args.as_json)
    if out:
        print(out)
    print(
        f"-- {len(events)} events"
        + (f" (filter: {args.kind})" if args.kind else "")
        + (f" (job: {args.job})" if args.job else ""),
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
