"""Lockwatch: runtime lock-order watchdog.

A copy of ``dlrover_tpu/telemetry/lockwatch.py`` that wraps the locks
of the port's own modules (``dlrover_tpu_torch``).

dlint's lock rules prove discipline *statically* — that every access is
guarded, that nothing blocks under a lock. What static analysis cannot
see is the *order* two threads take two locks in: an A→B acquisition on
one thread and B→A on another is a deadlock that only fires under the
right interleaving, usually in the fleet at 3am. Lockwatch makes that
class observable in ANY run cheap enough to leave on in chaos drills:

  * ``DLROVER_TPU_LOCKWATCH=1`` + :func:`install` wraps every
    ``threading.Lock`` / ``threading.RLock`` **created by
    dlrover_tpu_torch code** (caller-frame filename filter; third-party and stdlib locks
    are left alone) in a thin proxy;
  * each proxy maintains a per-thread held-stack and feeds a global
    acquisition-order graph: holding A while acquiring B adds edge
    A→B;
  * a new edge that closes a cycle journals ``lockwatch.cycle`` once
    per distinct cycle (the journal is the delivery channel — the
    flight recorder and the drill assertions both read it);
  * a lock held longer than ``DLROVER_TPU_LOCKWATCH_LONG_HOLD_MS``
    (default 500) journals ``lockwatch.long_hold`` — the runtime twin
    of dlint's blocking-under-lock rule;
  * :func:`install` registers a ``lockwatch`` section with the flight
    recorder, so every crash dump carries the observed lock graph.

Lock names are creation sites (``module.py:123``): stable across runs,
meaningful in a report, and free — no registration API to adopt.

Everything is best-effort: watchdog work runs behind a reentrancy
guard (the journal's own locks may be wrapped; reporting must not
recurse into itself) and never raises into the caller.
"""

import contextlib
import os
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from dlrover_tpu_torch.telemetry import journal as journal_mod

ENV_LOCKWATCH = "DLROVER_TPU_LOCKWATCH"
ENV_LONG_HOLD_MS = "DLROVER_TPU_LOCKWATCH_LONG_HOLD_MS"

#: the real factories, captured at import so the watchdog's own
#: bookkeeping lock (and uninstall) always uses unwrapped primitives
_ORIG_LOCK = threading.Lock
_ORIG_RLOCK = threading.RLock

# reentrancy guard: journal.record() acquires journal locks which may
# themselves be watched — watchdog work triggered by watchdog work is
# silently skipped instead of recursing
_guard = threading.local()


@contextlib.contextmanager
def _reporting():
    """Guard + swallow around journal emission: a watchdog must never
    recurse into itself or take down the patient."""
    _guard.active = True
    try:
        yield
    except Exception:
        pass
    finally:
        _guard.active = False


class LockWatch:
    """The acquisition-order graph and its two detectors."""

    def __init__(self, long_hold_s: Optional[float] = None):
        if long_hold_s is None:
            long_hold_s = float(
                os.getenv(ENV_LONG_HOLD_MS, "500")
            ) / 1000.0
        self.long_hold_s = long_hold_s
        self._mutex = _ORIG_LOCK()
        self._held = threading.local()  # .stack: [(name, t0), ...]
        self._edges: Dict[str, Set[str]] = {}
        self._cycles_seen: Set[frozenset] = set()
        self._cycles: List[List[str]] = []
        self._long_holds: Dict[str, float] = {}  # name -> worst seconds

    # ------------------------------------------------------------ events

    def note_acquire(self, name: str) -> None:
        if getattr(_guard, "active", False):
            return
        stack = self._stack()
        if any(n == name for n, _ in stack):
            stack.append((name, time.monotonic()))
            return  # RLock re-entry: no new edges
        new_cycle = None
        with self._mutex:
            for held_name, _ in stack:
                succ = self._edges.setdefault(held_name, set())
                if name in succ:
                    continue
                succ.add(name)
                cyc = self._find_cycle_locked(name, held_name)
                if cyc is not None and frozenset(cyc) not in self._cycles_seen:
                    self._cycles_seen.add(frozenset(cyc))
                    self._cycles.append(cyc)
                    new_cycle = cyc
        stack.append((name, time.monotonic()))
        if new_cycle is not None:
            with _reporting():
                journal_mod.record(
                    "lockwatch.cycle",
                    cycle=new_cycle,
                    edge=f"{new_cycle[0]}->{new_cycle[1]}",
                    thread=threading.current_thread().name,
                )

    def note_release(self, name: str) -> None:
        if getattr(_guard, "active", False):
            return
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == name:
                _, t0 = stack.pop(i)
                break
        else:
            return  # release of an acquire we never saw (guard window)
        if any(n == name for n, _ in stack):
            return  # RLock still held at an outer level
        held_s = time.monotonic() - t0
        if held_s < self.long_hold_s:
            return
        with self._mutex:
            worst = self._long_holds.get(name, 0.0)
            first = name not in self._long_holds
            self._long_holds[name] = max(worst, held_s)
        if first:  # journal once per lock, not once per occurrence
            with _reporting():
                journal_mod.record(
                    "lockwatch.long_hold",
                    lock=name,
                    held_ms=round(held_s * 1000.0, 1),
                    threshold_ms=round(self.long_hold_s * 1000.0, 1),
                    thread=threading.current_thread().name,
                )

    # ----------------------------------------------------------- reading

    def snapshot(self) -> Dict[str, Any]:
        """The flight-recorder section: the full observed graph."""
        with self._mutex:
            return {
                "edges": {a: sorted(bs)
                          for a, bs in sorted(self._edges.items())},
                "cycles": [list(c) for c in self._cycles],
                "long_holds_ms": {
                    n: round(s * 1000.0, 1)
                    for n, s in sorted(self._long_holds.items())
                },
            }

    def cycles(self) -> List[List[str]]:
        with self._mutex:
            return [list(c) for c in self._cycles]

    # ----------------------------------------------------------- helpers

    def _stack(self) -> List[Tuple[str, float]]:
        stack = getattr(self._held, "stack", None)
        if stack is None:
            stack = self._held.stack = []
        return stack

    def _find_cycle_locked(self, start: str,
                           target: str) -> Optional[List[str]]:
        """DFS ``start`` → ``target`` over the edge graph (caller holds
        _mutex). A path means target→start (just added) closes a cycle;
        returns [target, start, ...path..., target]."""
        path = self._dfs_locked(start, target, {start})
        if path is None:
            return None
        return [target] + path

    def _dfs_locked(self, node: str, target: str,
                    seen: Set[str]) -> Optional[List[str]]:
        if node == target:
            return [node]
        for nxt in self._edges.get(node, ()):
            if nxt in seen:
                continue
            seen.add(nxt)
            sub = self._dfs_locked(nxt, target, seen)
            if sub is not None:
                return [node] + sub
        return None


class _WatchedLock:
    """Proxy around one real lock, reporting to a :class:`LockWatch`.

    Implements the full ``Condition``-compatible surface
    (``_is_owned`` / ``_release_save`` / ``_acquire_restore``) so
    ``threading.Condition(watched_lock)`` keeps the held-stack honest
    across ``wait()``.
    """

    __slots__ = ("_inner", "_name", "_watch")

    def __init__(self, inner, name: str, watch: LockWatch):
        self._inner = inner
        self._name = name
        self._watch = watch

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            try:
                self._watch.note_acquire(self._name)
            except Exception:
                pass
        return got

    def release(self):
        try:
            self._watch.note_release(self._name)
        except Exception:
            pass
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    # --- Condition protocol ------------------------------------------
    def _is_owned(self):
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def _release_save(self):
        try:
            self._watch.note_release(self._name)
        except Exception:
            pass
        if hasattr(self._inner, "_release_save"):
            return self._inner._release_save()
        self._inner.release()
        return None

    def _acquire_restore(self, state):
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        try:
            self._watch.note_acquire(self._name)
        except Exception:
            pass

    def __repr__(self):
        return f"<WatchedLock {self._name} {self._inner!r}>"


# ---------------------------------------------------------------- install


_install_lock = _ORIG_LOCK()
_watch: Optional[LockWatch] = None

_PKG_MARKER = os.sep + "dlrover_tpu_torch" + os.sep
_SELF = os.sep + "lockwatch.py"


def _site_name(depth: int = 2) -> Tuple[str, bool]:
    """(creation-site name, is-project-code) from the caller frame."""
    import sys

    try:
        frame = sys._getframe(depth)
    except ValueError:
        return "<unknown>", False
    fname = frame.f_code.co_filename
    ours = _PKG_MARKER in fname and not fname.endswith(_SELF)
    return f"{os.path.basename(fname)}:{frame.f_lineno}", ours


def enabled() -> bool:
    return os.getenv(ENV_LOCKWATCH, "0") == "1"


def install(force: bool = False) -> Optional[LockWatch]:
    """Arm the watchdog: wrap project-created locks, hook the flight
    recorder. No-op (returns None) unless ``DLROVER_TPU_LOCKWATCH=1``
    or ``force``. Idempotent."""
    global _watch
    if not force and not enabled():
        return None
    with _install_lock:
        if _watch is not None:
            return _watch
        watch = LockWatch()

        def make_lock():
            name, ours = _site_name()
            inner = _ORIG_LOCK()
            return _WatchedLock(inner, name, watch) if ours else inner

        def make_rlock():
            name, ours = _site_name()
            inner = _ORIG_RLOCK()
            return _WatchedLock(inner, name, watch) if ours else inner

        threading.Lock = make_lock
        threading.RLock = make_rlock
        _watch = watch
    try:
        from dlrover_tpu_torch.telemetry import flight_recorder

        flight_recorder.register_section("lockwatch", watch.snapshot)
    except Exception:
        pass
    return watch


def uninstall() -> None:
    """Restore the real lock factories (already-wrapped locks keep
    reporting to the old watch, which is inert once dereferenced)."""
    global _watch
    with _install_lock:
        threading.Lock = _ORIG_LOCK
        threading.RLock = _ORIG_RLOCK
        _watch = None
    try:
        from dlrover_tpu_torch.telemetry import flight_recorder

        flight_recorder.unregister_section("lockwatch")
    except Exception:
        pass


def current() -> Optional[LockWatch]:
    return _watch
