"""Structured event journal: append-only JSONL with monotonic sequence.

Every consequential control-plane and training-plane event — rendezvous
rounds, scale actions, checkpoint save/restore, compile-cache state,
kernel-tuning decisions, hang detections, fault injections — writes
through here, so failure attribution after a restart reads one ordered
timeline instead of grepping stderr across processes (the ElasWave /
HSDP-at-100k lesson: elastic decisions are only auditable if the events
that drove them are durable and ordered).

Envelope per event (payload nested under ``data`` so domain fields —
a tuning key's ``seq``, say — can never collide with the envelope)::

    {"seq": 17, "ts": 1754300000.123, "host": "tpu-vm-3", "pid": 4242,
     "proc": 2, "kind": "checkpoint.save", "data": {...payload}}

``seq`` is monotonic PER PROCESS (the writer); ``ts`` is wall time;
``proc`` is the JAX process index when known (the agent's NodeEnv
contract, or :func:`dlrover_tpu_torch.common.log.set_process_index` after
``jax.distributed`` init). Multiple processes may append to one file:
each event is a single ``os.write`` on an ``O_APPEND`` fd, which POSIX
keeps atomic for these line sizes, and the dump CLI orders by ``ts``
with ``(pid, seq)`` as the tiebreak.

A bounded in-memory ring always mirrors the tail (tests and the
``/journal`` HTTP view read it without touching disk); the JSONL file
is written only when a path is configured — ``DLROVER_TPU_JOURNAL``
in the env, or :func:`configure`. The env route is deliberate: the
launcher exports it once and master, agent, and trainer all inherit
the same timeline file.
"""

import json
import os
import socket
import threading
from collections import deque
from typing import Any, Dict, List, Optional

from dlrover_tpu_torch.common.log import current_process_index
from dlrover_tpu_torch.common.log import default_logger as logger

ENV_JOURNAL = "DLROVER_TPU_JOURNAL"

#: job namespace: processes launched for a named job stamp
#: a ``job`` field into every envelope so one shared journal file can
#: be split back into per-job timelines (``dump --job``). Unset or
#: ``"default"`` keeps the envelope byte-identical to the pre-job
#: format.
ENV_JOB_ID = "DLROVER_TPU_JOB_ID"

#: size cap (MB) on the backing JSONL file; past it the file is
#: atomically renamed to ``<path>.1`` (replacing the previous ``.1``)
#: and a fresh file begins with a ``journal.rotated`` event, so a
#: months-long run holds at most ~2x the cap on disk. 0/unset = never
#: rotate. Readers (``read_journal``, ``/journal?source=file``, the
#: dump CLI) stitch ``<path>.1`` + ``<path>`` back into one timeline.
ENV_JOURNAL_MAX_MB = "DLROVER_TPU_JOURNAL_MAX_MB"

#: every N writes the writer re-syncs against the file (fstat size —
#: other processes append to the same file — and an inode check that
#: detects a rotation done by a SIBLING process, so this writer
#: reopens the new file instead of growing the rotated one forever)
_RESYNC_EVERY = 128

__all__ = [
    "ENV_JOURNAL",
    "ENV_JOURNAL_MAX_MB",
    "ENV_JOB_ID",
    "EventJournal",
    "current_job_id",
    "default_journal",
    "set_default_journal",
    "configure",
    "record",
    "read_journal",
    "add_tap",
    "remove_tap",
]

# ------------------------------------------------------------------- taps
#
# Module-level observers invoked for every event recorded in this
# process (any journal instance — taps must survive the test-time
# set_default_journal swaps). The goodput ledger derives its phase
# transitions from events that already fire by tapping here instead of
# adding instrumentation points. Taps run OUTSIDE the journal lock, so
# a tap may itself record() (e.g. a phase-transition breadcrumb)
# without deadlocking; tap exceptions are swallowed — observation must
# never take the instrumented path down.

_taps_lock = threading.Lock()
_taps: List[Any] = []


def add_tap(fn) -> None:
    """Register ``fn(event_dict)`` to observe every recorded event."""
    with _taps_lock:
        if fn not in _taps:
            _taps.append(fn)


def remove_tap(fn) -> None:
    with _taps_lock:
        if fn in _taps:
            _taps.remove(fn)


def current_job_id() -> str:
    """This process's job namespace (``DLROVER_TPU_JOB_ID``), or
    ``"default"`` — the identity every job-scoped consumer keys on."""
    return os.getenv(ENV_JOB_ID, "") or "default"


def _notify_taps(event: Dict[str, Any]) -> None:
    with _taps_lock:
        taps = list(_taps)
    for fn in taps:
        try:
            fn(event)
        except Exception as e:
            logger.warning("journal tap failed: %s", e)


class EventJournal:
    """Append-only structured event sink (memory ring + optional JSONL)."""

    def __init__(self, path: Optional[str] = None, capacity: int = 4096,
                 max_bytes: Optional[int] = None):
        self.path = path
        self._lock = threading.Lock()
        self._seq = 0
        self._ring: deque = deque(maxlen=capacity)
        self._fd: Optional[int] = None
        self._host = socket.gethostname()
        job = os.getenv(ENV_JOB_ID, "") or ""
        self._job = job if job != "default" else ""
        if max_bytes is None:
            try:
                max_mb = float(
                    os.getenv(ENV_JOURNAL_MAX_MB, "0") or 0
                )
            except ValueError:
                max_mb = 0.0
            max_bytes = int(max_mb * 1024 * 1024)
        self._max_bytes = max(0, max_bytes)  # 0 = never rotate
        self._size = 0
        self._writes_since_resync = 0
        if path:
            try:
                os.makedirs(
                    os.path.dirname(os.path.abspath(path)), exist_ok=True
                )
                self._fd = os.open(
                    path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
                )
                self._size = os.fstat(self._fd).st_size
            except OSError as e:
                logger.warning(
                    "event journal %s unavailable (%s); memory-only",
                    path, e,
                )
                self.path = None

    def record(self, kind: str, **fields: Any) -> Dict[str, Any]:
        """Append one event; returns the full envelope dict. Never
        raises — telemetry must not take the instrumented path down."""
        rotated_from_bytes = 0
        with self._lock:
            self._seq += 1
            event = {
                "seq": self._seq,
                "ts": __import__("time").time(),
                "host": self._host,
                "pid": os.getpid(),
                "proc": current_process_index(),
                "kind": kind,
                "data": dict(fields),
            }
            if self._job:
                event["job"] = self._job
            self._ring.append(event)
            if self._fd is not None:
                try:
                    line = json.dumps(event, default=str) + "\n"
                    os.write(self._fd, line.encode())
                    self._size += len(line)
                    self._writes_since_resync += 1
                    if self._writes_since_resync >= _RESYNC_EVERY:
                        self._resync_locked()
                    if self._max_bytes \
                            and self._size >= self._max_bytes:
                        rotated_from_bytes = self._size
                        self._rotate_locked()
                except OSError as e:
                    logger.warning(
                        "journal write failed (%s); memory-only from "
                        "here", e,
                    )
                    try:
                        os.close(self._fd)
                    except OSError:
                        pass
                    self._fd = None
        _notify_taps(event)
        if rotated_from_bytes:
            # first event of the fresh file — outside the lock, via the
            # normal path, so taps/ring see it too
            self.record(
                "journal.rotated", path=self.path,
                rotated_to=self.path + ".1",
                size_bytes=rotated_from_bytes,
                max_bytes=self._max_bytes,
            )
        return event

    def _resync_locked(self):
        """Periodic truth check against the filesystem: other processes
        append to the same file (count their bytes toward the cap), and
        one of them may have rotated it (our fd then points at the
        renamed ``.1`` — reopen the path so we write the NEW file)."""
        self._writes_since_resync = 0
        try:
            fd_stat = os.fstat(self._fd)
            try:
                path_stat = os.stat(self.path)
            except FileNotFoundError:
                path_stat = None
            if path_stat is None or path_stat.st_ino != fd_stat.st_ino:
                os.close(self._fd)
                self._fd = os.open(
                    self.path,
                    os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644,
                )
                self._size = os.fstat(self._fd).st_size
            else:
                self._size = fd_stat.st_size
        except OSError:
            pass  # keep the approximate counter; never take record() down

    def _rotate_locked(self):
        """Atomic rename to ``<path>.1`` + fresh file. The rename is a
        single ``os.replace``: readers either see the old name or the
        new, never a torn file."""
        try:
            os.close(self._fd)
        except OSError:
            pass
        self._fd = None
        try:
            os.replace(self.path, self.path + ".1")
        except OSError as e:
            logger.warning("journal rotation failed: %s", e)
        try:
            self._fd = os.open(
                self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
            )
            self._size = os.fstat(self._fd).st_size
        except OSError as e:
            logger.warning(
                "journal reopen after rotation failed (%s); "
                "memory-only from here", e,
            )
            self._fd = None

    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        """In-memory tail, oldest first; ``kind`` filters exact or by
        dotted prefix (``"checkpoint"`` matches ``"checkpoint.save"``)."""
        with self._lock:
            evts = list(self._ring)
        if kind is None:
            return evts
        return [
            e for e in evts
            if e["kind"] == kind or e["kind"].startswith(kind + ".")
        ]

    def tail(self, n: int = 100) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)[-n:]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def close(self):
        with self._lock:
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None


_default_lock = threading.Lock()
_default: Optional[EventJournal] = None


def default_journal() -> EventJournal:
    """The process-wide journal; file-backed iff ``DLROVER_TPU_JOURNAL``
    is set when first touched."""
    global _default
    with _default_lock:
        if _default is None:
            _default = EventJournal(os.getenv(ENV_JOURNAL, "") or None)
        return _default


def set_default_journal(
    journal: Optional[EventJournal],
) -> EventJournal:
    """Swap the process default (tests); None re-reads the env."""
    global _default
    with _default_lock:
        # explicit None test: an EMPTY journal is falsy (__len__), and
        # `journal or ...` would silently discard a fresh file-backed one
        if journal is None:
            journal = EventJournal(os.getenv(ENV_JOURNAL, "") or None)
        _default = journal
        return _default


def configure(path: Optional[str],
              capacity: int = 4096) -> EventJournal:
    """Point the default journal at ``path`` (masters/launchers call
    this; workers usually inherit the env var instead)."""
    return set_default_journal(EventJournal(path, capacity=capacity))


def record(kind: str, **fields: Any) -> Dict[str, Any]:
    """Record on the default journal — the one-line instrumentation
    call sites use."""
    return default_journal().record(kind, **fields)


def _open_for_read(p: str):
    # indirection point: the rotation-race regression test swaps this
    # to rotate the file between the two opens of a stitching pass
    return open(p, "r")


def _read_stitched_once(path: str):
    """One stitching pass over ``<path>.1`` + ``<path>``. Returns
    ``(events, opened, ino_of_dot1)`` where ``ino_of_dot1`` is the
    inode of the rotated predecessor actually read (None if absent) —
    the caller compares it against a post-pass stat to detect a
    rotation that happened between the two opens."""
    events: List[Dict[str, Any]] = []
    opened = False
    dot1_ino = None
    for p in (path + ".1", path):
        try:
            f = _open_for_read(p)
        except OSError:
            continue
        opened = True
        with f:
            if p.endswith(".1"):
                try:
                    dot1_ino = os.fstat(f.fileno()).st_ino
                except OSError:
                    pass
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return events, opened, dot1_ino


def read_journal(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL journal file; unparseable lines (a torn write from
    a crashed process) are skipped, not fatal. Ordered by ``(ts, pid,
    seq)`` so multi-process appends interleave into one timeline. A
    rotated predecessor (``<path>.1``, see ``ENV_JOURNAL_MAX_MB``) is
    stitched in front, so consumers read across the rotation boundary
    without knowing it exists.

    A rotation can also land BETWEEN the two opens of one stitching
    pass: the pass then reads the pre-rotation ``.1`` (or none) plus
    the fresh post-rotation file, silently dropping the rotated tail.
    Detected by re-statting ``.1`` after the pass — a changed inode
    means the pass straddled a rotation, and the read retries once."""
    events, opened, read_ino = _read_stitched_once(path)
    try:
        now_ino = os.stat(path + ".1").st_ino
    except OSError:
        now_ino = None
    if now_ino is not None and now_ino != read_ino:
        retry_events, retry_opened, _ = _read_stitched_once(path)
        if retry_opened:
            events, opened = retry_events, True
    if not opened:
        # neither the file nor a rotated predecessor: keep the
        # pre-rotation contract (callers report the missing path)
        raise FileNotFoundError(path)
    events.sort(
        key=lambda e: (
            e.get("ts", 0.0), e.get("pid", 0), e.get("seq", 0)
        )
    )
    return events
