"""Flight recorder: capture process state when training wedges or dies.

A copy of ``dlrover_tpu/telemetry/flight_recorder.py``.

When ``HangingDetector`` trips, or SIGTERM arrives mid-run, the most
valuable artifact is not a metric — it is *what every thread was doing*
at that moment. This module freezes that into a crash-dump directory:

  * all-thread Python stacks (``sys._current_frames``, annotated with
    thread names and daemon flags);
  * the tail of the span ring (:mod:`~dlrover_tpu_torch.telemetry.tracing`) —
    the last operations that completed before the stall;
  * the tail of the event journal — the control-plane context (last
    rendezvous, last checkpoint, last scale action);
  * a metrics-registry snapshot.

One dump is a directory ``flight-<utc>-<host>-pid<pid>-<reason>/``
containing ``record.json`` (machine-readable, single file so a support
bundle is one ``tar``) and ``stacks.txt`` (the same stacks, human
readable — the first file an oncall opens). The same stack view is
served live at ``GET /debug/stacks`` on the telemetry endpoint.

Dumps land under ``DLROVER_TPU_CRASH_DIR`` (default: a per-uid dir in
the system temp dir). ``DLROVER_TPU_FLIGHT_RECORDER=0`` disables the
automatic triggers (the hang-detector hook and the signal hook); direct
:func:`dump_flight_record` calls always work.

Everything here is best-effort and exception-swallowing: a diagnosis
path must never take down the process it is diagnosing.
"""

import json
import os
import signal
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from dlrover_tpu_torch.common.log import current_process_index
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import journal as journal_mod
from dlrover_tpu_torch.telemetry import registry as registry_mod
from dlrover_tpu_torch.telemetry import tracing

ENV_CRASH_DIR = "DLROVER_TPU_CRASH_DIR"
ENV_FLIGHT_RECORDER = "DLROVER_TPU_FLIGHT_RECORDER"

__all__ = [
    "ENV_CRASH_DIR",
    "ENV_FLIGHT_RECORDER",
    "auto_dump_enabled",
    "crash_dir",
    "thread_stacks",
    "format_stacks",
    "dump_flight_record",
    "dump_on_hang",
    "install_signal_hook",
    "register_section",
    "unregister_section",
]


def auto_dump_enabled() -> bool:
    """Whether the automatic triggers (hang detector, signals) fire."""
    return os.getenv(ENV_FLIGHT_RECORDER, "1").strip().lower() not in (
        "0", "off", "false",
    )


def crash_dir() -> str:
    configured = os.getenv(ENV_CRASH_DIR, "").strip()
    if configured:
        return configured
    uid = os.getuid() if hasattr(os, "getuid") else 0
    return os.path.join(
        tempfile.gettempdir(), f"dlrover_tpu_flight_{uid}"
    )


# ------------------------------------------------------------ thread stacks


def thread_stacks() -> List[Dict[str, Any]]:
    """Every live thread's Python stack, outermost frame first. The
    view a hang needs: which lock/join/RPC each thread is parked on."""
    frames = sys._current_frames()
    by_ident = {t.ident: t for t in threading.enumerate()}
    stacks = []
    for ident, frame in frames.items():
        th = by_ident.get(ident)
        stacks.append({
            "tid": ident,
            "name": th.name if th else f"tid-{ident}",
            "daemon": bool(th.daemon) if th else None,
            "stack": [
                line.rstrip("\n")
                for line in traceback.format_stack(frame)
            ],
        })
    stacks.sort(key=lambda s: (s["name"] != "MainThread", s["name"]))
    return stacks


def format_stacks(stacks: Optional[List[Dict[str, Any]]] = None) -> str:
    """py-spy-style text rendering of :func:`thread_stacks`."""
    if stacks is None:
        stacks = thread_stacks()
    lines = []
    for s in stacks:
        flags = " daemon" if s.get("daemon") else ""
        lines.append(f'--- Thread "{s["name"]}" (tid {s["tid"]}{flags}) ---')
        lines.extend(s["stack"])
        lines.append("")
    return "\n".join(lines)


# -------------------------------------------------------------------- dumps


# extra record sections contributed by other subsystems (lockwatch,
# future watchdogs): name -> zero-arg callable returning a JSON-able
# value. Registered once at subsystem install time; every dump calls
# them, and a section that raises becomes {"error": ...} in the record
# rather than sinking the dump.
_section_lock = threading.Lock()
_sections: Dict[str, Any] = {}


def register_section(name: str, fn) -> None:
    """Contribute a named section to every future flight record."""
    with _section_lock:
        _sections[name] = fn


def unregister_section(name: str) -> None:
    with _section_lock:
        _sections.pop(name, None)


def dump_flight_record(reason: str,
                       dump_dir: Optional[str] = None,
                       max_spans: int = 512,
                       journal_tail: int = 200) -> Optional[str]:
    """Write one flight record; returns the dump directory path, or
    None when the write failed (never raises)."""
    try:
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        safe_reason = "".join(
            c if c.isalnum() or c in "-_" else "_" for c in reason
        )[:40] or "dump"
        base = dump_dir or crash_dir()
        host = os.uname().nodename if hasattr(os, "uname") else "host"
        out = os.path.join(
            base,
            f"flight-{stamp}-{host}-pid{os.getpid()}-{safe_reason}",
        )
        os.makedirs(out, exist_ok=True)
        # count + journal BEFORE snapshotting, so the dump's own
        # breadcrumbs are part of the record it writes
        registry_mod.counter(
            "dlrover_flight_dumps_total",
            "Flight-recorder dumps written", ["reason"],
        ).labels(reason=safe_reason[:20]).inc()
        journal_mod.record(
            "flight.dumped", reason=reason, path=out,
            step=tracing.current_step(),
        )
        stacks = thread_stacks()
        record: Dict[str, Any] = {
            "reason": reason,
            "ts": time.time(),
            "host": host,
            "pid": os.getpid(),
            "proc": current_process_index(),
            "step": tracing.current_step(),
            "threads": stacks,
            "spans": tracing.tail(max_spans),
            "journal": journal_mod.default_journal().tail(journal_tail),
        }
        try:
            record["metrics"] = registry_mod.default_registry().to_dict()
        except Exception as e:
            record["metrics"] = {"error": str(e)}
        try:
            # what phase the job died in (telemetry/goodput.py);
            # None when no ledger was armed in this process
            from dlrover_tpu_torch.telemetry import goodput

            record["goodput"] = goodput.local_snapshot()
        except Exception as e:
            record["goodput"] = {"error": str(e)}
        with _section_lock:
            sections = dict(_sections)
        for name, fn in sections.items():
            try:
                record[name] = fn()
            except Exception as e:
                record[name] = {"error": str(e)}
        with open(os.path.join(out, "record.json"), "w") as f:
            json.dump(record, f, default=str, indent=1)
        with open(os.path.join(out, "stacks.txt"), "w") as f:
            f.write(format_stacks(stacks))
        logger.error("flight record written: %s (%s)", out, reason)
        return out
    except Exception as e:  # diagnosis must never crash the patient
        try:
            logger.warning("flight record failed: %s", e)
        except Exception:
            pass
        return None


def dump_on_hang(stalled_for: float, step: int,
                 threshold: float) -> Optional[str]:
    """The HangingDetector trigger: honors the enable env, then dumps
    with the stall context folded into the reason."""
    if not auto_dump_enabled():
        return None
    return dump_flight_record(
        f"hang-step{step}-{stalled_for:.0f}s"
        if step >= 0 else f"hang-{stalled_for:.0f}s"
    )


# ------------------------------------------------------------- signal hook


_hook_lock = threading.Lock()
_hooked: Dict[int, Any] = {}  # signum -> previous handler


def _on_signal(signum, frame):
    dump_flight_record(
        f"signal-{signal.Signals(signum).name}"
        if hasattr(signal, "Signals") else f"signal-{signum}"
    )
    prev = _hooked.get(signum)
    if callable(prev):
        prev(signum, frame)
        return
    # restore the pre-hook disposition and re-deliver so the process
    # still dies the way the sender intended (SIG_DFL terminates)
    signal.signal(signum, prev if prev is not None else signal.SIG_DFL)
    os.kill(os.getpid(), signum)


def install_signal_hook(signums=(signal.SIGTERM,)) -> bool:
    """Chain a dump-then-propagate handler onto ``signums``. Idempotent
    per signal; returns False when not installed (recorder disabled, or
    not on the main thread — CPython restricts signal.signal to it)."""
    if not auto_dump_enabled():
        return False
    if threading.current_thread() is not threading.main_thread():
        return False
    installed = False
    with _hook_lock:
        for signum in signums:
            if signum in _hooked:
                installed = True
                continue
            try:
                prev = signal.signal(signum, _on_signal)
            except (ValueError, OSError) as e:
                logger.warning(
                    "flight-recorder signal hook for %s failed: %s",
                    signum, e,
                )
                continue
            _hooked[signum] = prev
            installed = True
    return installed


def uninstall_signal_hook() -> None:
    """Restore pre-hook handlers (tests)."""
    with _hook_lock:
        for signum, prev in list(_hooked.items()):
            try:
                signal.signal(
                    signum, prev if prev is not None else signal.SIG_DFL
                )
            except (ValueError, OSError):
                pass
            del _hooked[signum]
