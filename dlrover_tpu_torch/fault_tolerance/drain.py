"""Preemption-aware graceful drain.

Counterpart of ``dlrover_tpu/fault_tolerance/drain.py``. Spot and
preemptible machines die with a termination notice, not a negotiation:
the platform delivers SIGTERM (or a maintenance-event flag) and reclaims
the host seconds later no matter what the process is doing. Without a
drain that death looks like any other crash — the master notices
heartbeat loss, the task-timeout watchdog requeues the dead worker's
shards minutes later, and the restart budget is charged for a failure
the node did not cause.

:class:`DrainCoordinator` spends the notice window instead. Armed by
the elastic trainer (or any worker loop), it turns SIGTERM into a
deadline-budgeted drain sequence bounded by
``DLROVER_TPU_PREEMPT_NOTICE_BUDGET`` (default 30 s):

1. journal ``preempt.notice`` and report PREEMPTED to the master
   (``report_preemption`` RPC) — the master marks the node and evicts
   it from the rendezvous waiting/alive sets so the next round never
   blocks on a departed peer;
2. fire a deadline-bounded emergency flash checkpoint
   (``FlashCheckpointer.save(force_persist=True, durable=True)`` and
   ``wait()``, so the archive is on the persist tier: a RAM tier dies
   with the reclaimed host); when the remaining budget cannot cover the
   durable save, fall back to the staged RAM tier — never block past
   the deadline;
3. relinquish in-flight shards (``relinquish_shards`` RPC) so the
   ``TaskManager`` requeues them immediately instead of waiting out
   the task-timeout watchdog;
4. send the final goodput snapshot (``report_goodput(final=True)``) so
   the master closes the incarnation under the preempt cause;
5. chain the previously installed signal disposition and exit with
   :data:`DRAIN_EXIT_CODE` so the agent classifies the death as
   PREEMPTED, not a crash.

Every step runs in a bounded daemon thread joined against the
remaining budget: a dead master must cost one step's slice of the
window, never the RPC supervisor's multi-minute reconnect timeout.

**The notice waits for the step's end.** The port's optimizer updates
the parameters and moments in place on the card, as a chain of
``_foreach`` calls, and Python runs a signal handler on the main thread
between any two of them: a save taken from inside a step could archive
the first moment after the update and the second before it. So while a
step is open — :meth:`DrainCoordinator.hold` to
:meth:`DrainCoordinator.release`, which ``ElasticTrainer`` calls from a
step's dispatch to the end of the loop's ``maybe_checkpoint`` for it —
the handler only records the notice, and the sequence runs at
``release()`` against the deadline counted from the notice. A notice
between steps drains at once, and so does one inside a step that
``stalled_fn`` (the hang detector) says will not end: then without the
emergency save, since the state is not whole. The JAX package drains at
signal time from a host copy the loop takes after every step; copying
the port's state (6.6 GB for Llama-1.1B) to the host every step is no
option.

The flight recorder's SIGTERM hook (telemetry/flight_recorder.py),
installed after the drain is armed, dumps at signal time and then calls
this handler, which may defer the notice as above: the dump neither
breaks the hold nor re-delivers the signal.
"""

import os
import signal
import threading
import time
from typing import Any, Callable, Optional, Tuple

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import counter, record

__all__ = [
    "DRAIN_EXIT_CODE",
    "DEFAULT_NOTICE_BUDGET_S",
    "DURABLE_FLOOR_S",
    "DrainCoordinator",
    "notice_budget_from_env",
]

#: distinct from a worker crash (17), a master crash (28), a failed
#: job (3) and an OOM kill (137): the agent maps this rc to
#: NodeExitReason.PREEMPTED and does not restart the worker locally
DRAIN_EXIT_CODE = 21

#: default termination-notice window (GCE preemptible VMs give 30s)
DEFAULT_NOTICE_BUDGET_S = 30.0

#: minimum remaining budget to attempt the DURABLE persist; below it
#: the emergency save stays on the staged RAM tier (a tmpfs archive
#: survives the process, not the host — but a truncated durable write
#: that the deadline guillotines helps nobody)
DURABLE_FLOOR_S = 3.0


def notice_budget_from_env() -> float:
    raw = os.getenv(NodeEnv.PREEMPT_NOTICE_BUDGET, "").strip()
    if not raw:
        return DEFAULT_NOTICE_BUDGET_S
    try:
        budget = float(raw)
    except ValueError:
        logger.warning(
            "bad %s=%r; using %.0fs",
            NodeEnv.PREEMPT_NOTICE_BUDGET, raw, DEFAULT_NOTICE_BUDGET_S,
        )
        return DEFAULT_NOTICE_BUDGET_S
    return budget if budget > 0 else DEFAULT_NOTICE_BUDGET_S


class DrainCoordinator:
    """Turns a termination notice into a bounded drain sequence.

    ``state_provider`` returns ``(step, state)`` for the emergency
    checkpoint, or ``None`` when no state is available yet; ``state``
    may be a callable that builds the state, called inside the bounded
    save. The provider is read when the sequence runs, so arming can
    happen before the first step. ``checkpointer_fn``/``master_client_fn``
    are also lazy for the same reason. ``stalled_fn`` says whether the
    open step has stalled. ``exit_fn`` exists for tests (the real one
    never returns).
    """

    def __init__(
        self,
        master_client_fn: Callable[[], Any] = lambda: None,
        checkpointer_fn: Callable[[], Any] = lambda: None,
        state_provider: Optional[
            Callable[[], Optional[Tuple[int, Any]]]
        ] = None,
        notice_budget_s: Optional[float] = None,
        restart_count: int = 0,
        exit_fn: Callable[[int], None] = os._exit,
        stalled_fn: Callable[[], bool] = lambda: False,
    ):
        self._master_client_fn = master_client_fn
        self._checkpointer_fn = checkpointer_fn
        self._state_provider = state_provider
        self._budget = (
            notice_budget_s if notice_budget_s and notice_budget_s > 0
            else notice_budget_from_env()
        )
        self._restart_count = restart_count
        self._exit_fn = exit_fn
        self._stalled_fn = stalled_fn
        self._prev = {}  # signum -> pre-arm disposition
        self._lock = threading.Lock()
        self._draining = threading.Event()
        self._armed = False
        #: a step is open: a notice now waits for release()
        self._held = False
        #: (reason, signum) of a notice that landed inside a step
        self._pending: Optional[Tuple[str, int]] = None
        #: monotonic time of the notice the deadline counts from
        self._notice_mono: Optional[float] = None

    # ------------------------------------------------------------- wiring

    def set_state_provider(
        self, provider: Callable[[], Optional[Tuple[int, Any]]]
    ) -> None:
        self._state_provider = provider

    @property
    def notice_budget_s(self) -> float:
        return self._budget

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    @property
    def pending(self) -> bool:
        """A notice landed inside the open step and waits for its end."""
        return self._pending is not None

    # ------------------------------------------------------------- arming

    def arm(self, signums=(signal.SIGTERM,)) -> bool:
        """Install the drain handler, chaining whatever disposition was
        there before. Idempotent; returns False off the main thread
        (CPython restricts signal.signal)."""
        if threading.current_thread() is not threading.main_thread():
            return False
        armed = False
        with self._lock:
            for signum in signums:
                if signum in self._prev:
                    armed = True
                    continue
                try:
                    prev = signal.signal(signum, self._on_signal)
                except (ValueError, OSError) as e:
                    logger.warning(
                        "drain handler for signal %s failed: %s",
                        signum, e,
                    )
                    continue
                self._prev[signum] = prev
                armed = True
            self._armed = self._armed or armed
        return armed

    def disarm(self) -> None:
        """Restore pre-arm dispositions (tests)."""
        with self._lock:
            for signum, prev in list(self._prev.items()):
                try:
                    signal.signal(
                        signum, prev if prev is not None else signal.SIG_DFL
                    )
                except (ValueError, OSError):
                    pass
                del self._prev[signum]
            self._armed = False

    # -------------------------------------------------------- step window

    def hold(self) -> None:
        """A step opens: the state is being updated in place, so a
        notice from now on waits for :meth:`release`."""
        self._held = True

    def release(self) -> None:
        """The step ended and its state is whole: run the sequence for
        a notice that landed inside it, then exit (never returns with
        the default ``exit_fn``)."""
        self._held = False
        pending, self._pending = self._pending, None
        if pending is None:
            return
        reason, signum = pending
        self.drain(reason=reason)
        self._chain_prev(signum, None)
        self._exit_fn(DRAIN_EXIT_CODE)

    # ------------------------------------------------------------ sequence

    def _on_signal(self, signum, frame):
        if self._draining.is_set() or self._pending is not None:
            # a second notice adds nothing; the reclaim deadline is
            # already running
            return
        try:
            name = signal.Signals(signum).name
        except (ValueError, AttributeError):
            name = str(signum)
        reason = f"signal-{name.lower()}"
        self._note_notice(reason)
        whole = True
        if self._held:
            if not self._stalled_fn():
                self._pending = (reason, signum)
                logger.warning(
                    "PREEMPTION NOTICE (%s) inside a step: draining at "
                    "its end", reason,
                )
                return
            # the step will not end: its state is half updated
            whole = False
        self.drain(reason=reason, save=whole)
        self._chain_prev(signum, frame)
        self._exit_fn(DRAIN_EXIT_CODE)

    def trigger(self, reason: str = "maintenance") -> None:
        """Non-signal entry (maintenance notices): run the sequence and
        exit. Never returns with the default ``exit_fn``."""
        if self._draining.is_set():
            return
        self.drain(reason=reason)
        self._exit_fn(DRAIN_EXIT_CODE)

    def _provided(self) -> Optional[Tuple[int, Any]]:
        try:
            if self._state_provider is not None:
                return self._state_provider()
        except Exception as e:
            logger.warning("drain state provider failed: %s", e)
        return None

    def _note_notice(self, reason: str) -> None:
        """The notice arrived: the deadline counts from now."""
        self._notice_mono = time.monotonic()
        step_state = self._provided()
        record(
            "preempt.notice", reason=reason,
            step=step_state[0] if step_state else -1,
            notice_budget_s=self._budget,
            restart_count=self._restart_count, deferred=self._held,
        )
        counter(
            "dlrover_preemptions_total",
            "Termination notices handled by the drain sequence",
            ["reason"],
        ).labels(reason=reason[:40]).inc()

    def drain(self, reason: str = "sigterm", save: bool = True) -> dict:
        """The bounded sequence itself; returns a result dict (tests).
        Never raises, never blocks past the notice deadline. ``save``
        False skips the emergency checkpoint (a stalled step's state is
        not whole)."""
        self._draining.set()
        if self._notice_mono is None:
            self._note_notice(reason)
        deadline = self._notice_mono + self._budget
        result = {"reason": reason, "budget_s": self._budget}
        step_state = self._provided()
        step = step_state[0] if step_state else -1
        logger.warning(
            "PREEMPTION NOTICE (%s): draining with %.1fs left of %.1fs",
            reason, deadline - time.monotonic(), self._budget,
        )

        # 1. tell the master first: rendezvous eviction must land even
        # if the rest of the window is lost
        result["reported"] = self._bounded(
            "report", deadline,
            lambda: self._report_preemption(reason, deadline),
        )
        # 2. emergency checkpoint with whatever budget remains
        result["checkpoint"] = self._emergency_checkpoint(
            step_state if save else None, deadline
        )
        # 3. hand in-flight shards back NOW, not at watchdog timeout
        result["relinquished"] = self._bounded(
            "relinquish", deadline, self._relinquish_shards
        )
        # 4. final goodput snapshot closes the incarnation under the
        # preempt cause instead of an open-ended restart window
        result["goodput"] = self._bounded(
            "goodput", deadline, self._final_goodput
        )
        record(
            "preempt.drained", reason=reason, step=step,
            remaining_s=round(max(0.0, deadline - time.monotonic()), 3),
            reported=bool(result.get("reported", {}).get("ok")),
            relinquished=result.get("relinquished", {}).get("value"),
            goodput=bool(result["goodput"].get("ok")),
        )
        return result

    # ------------------------------------------------------------- steps

    def _report_preemption(self, reason: str, deadline: float):
        client = self._master_client_fn()
        if client is None:
            return None
        return client.report_preemption(
            reason=reason,
            notice_budget_s=self._budget,
            deadline_ts=time.time() + max(0.0, deadline - time.monotonic()),
            restart_count=self._restart_count,
        )

    def _emergency_checkpoint(self, step_state, deadline: float) -> dict:
        out = {"attempted": False, "ok": False, "durable": False}
        ckpt = self._checkpointer_fn()
        if ckpt is None or not step_state:
            return out
        step, state = step_state
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return out
        # durable (drain the persist pipeline) only when the window can
        # plausibly cover it; otherwise the staged RAM tier is the best
        # checkpoint a guillotined process can leave behind
        durable = remaining > DURABLE_FLOOR_S
        out.update(attempted=True, durable=durable, step=step)
        t0 = time.monotonic()

        def save():
            snapshot = state() if callable(state) else state
            ckpt.save(step, snapshot, force_persist=True, durable=durable)
            t_ram = time.monotonic()
            if durable:
                # save(durable=True) drains to the RAM tier only, and
                # tmpfs dies with the reclaimed host: the forced
                # persist must land on the durable store too
                ckpt.wait()
            stats = getattr(ckpt, "save_stats", {}).get(step, {})
            return {"ram_s": round(t_ram - t0, 3),
                    "persist_s": round(time.monotonic() - t_ram, 3),
                    # the pinned block the previous save still held
                    "pin_wait_s": stats.get("pin_wait_s")}

        res = self._bounded("emergency_ckpt", deadline, save)
        out["ok"] = bool(res.get("ok"))
        out["timed_out"] = bool(res.get("timed_out"))
        record(
            "preempt.emergency_ckpt", step=step, durable=durable,
            ok=out["ok"], timed_out=out["timed_out"],
            elapsed_s=round(time.monotonic() - t0, 3),
            error=res.get("error"), **(res.get("value") or {}),
        )
        return out

    def _relinquish_shards(self):
        client = self._master_client_fn()
        if client is None:
            return None
        return client.relinquish_shards()

    def _final_goodput(self):
        client = self._master_client_fn()
        if client is None:
            return None
        return client.report_goodput(final=True)

    # ------------------------------------------------------------ plumbing

    def _bounded(self, name: str, deadline: float,
                 fn: Callable[[], Any]) -> dict:
        """Run ``fn`` in a daemon thread joined against the remaining
        budget. A hung RPC (dead master behind the reconnect
        supervisor) costs this step's slice of the window, nothing
        more; the abandoned thread cannot outlive the imminent exit."""
        out = {"ok": False, "timed_out": False, "value": None}
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            out["timed_out"] = True
            record("preempt.step_skipped", step_name=name)
            return out

        def run():
            try:
                out["value"] = fn()
                out["ok"] = True
            except Exception as e:
                out["error"] = str(e)[:200]
                logger.warning("drain step %s failed: %s", name, e)

        t = threading.Thread(
            target=run, name=f"drain-{name}", daemon=True
        )
        t.start()
        t.join(remaining)
        if t.is_alive():
            out["timed_out"] = True
            record(
                "preempt.step_timeout", step_name=name,
                waited_s=round(remaining, 3),
            )
            logger.warning(
                "drain step %s still running at deadline (waited "
                "%.1fs); moving on", name, remaining,
            )
        return out

    def _chain_prev(self, signum, frame) -> None:
        """Compose with the pre-arm disposition. The flight recorder's
        hook is special-cased: when it was installed first (we chained
        onto it), calling it back would call the handler it chains to
        (an older coordinator's, say) or re-deliver the signal after
        its own chain bottoms out on SIG_DFL and kill the process with
        the wrong rc — dump directly instead."""
        prev = self._prev.get(signum)
        if prev in (None, signal.SIG_IGN, signal.SIG_DFL):
            return
        if (
            getattr(prev, "__func__", None) is DrainCoordinator._on_signal
        ):
            # another coordinator armed earlier in this process (an
            # earlier trainer's, say): the drain has already run once,
            # and invoking the older handler would start a second
            # sequence and hard-exit through ITS exit_fn
            return
        from dlrover_tpu_torch.telemetry import flight_recorder

        if prev is flight_recorder._on_signal:
            flight_recorder.dump_flight_record("preempt-drain")
            return
        if callable(prev):
            try:
                prev(signum, frame)
            except Exception as e:
                logger.warning(
                    "chained signal handler failed: %s", e
                )
