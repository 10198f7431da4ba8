"""Worker-side step-progress hang detection.

Parity reference: atorch/atorch/fault_tolerance/hanging_detector.py:86
(HangingDetector judges "hung" from relative step time vs the history it
has seen) and dlrover/python/master/node/dist_job_manager.py:662 (the
master-side resource-stagnation signal).

The detector is a daemon thread inside the training process,
fed by ``ElasticTrainer.report_step``. The hang threshold adapts to the
observed cadence: ``max(min_timeout, multiplier * median(recent step
durations))`` — so a job whose steps take 0.1 s is flagged in seconds
while a job with 60 s steps is given minutes, with no per-model tuning.
It arms only after the first completed step, so the first step's
compile and warm-up can never trip it.

On detection it calls ``report_fn(elapsed_seconds)`` once per stall; the
standard wiring reports a HANG-level failure to the master, which answers
the supervising agent's next heartbeat with a ``restart`` action — the
process is replaced without the node ever leaving RUNNING (the agent and
its heartbeat survive; only the training process is recycled).

A copy of ``dlrover_tpu/fault_tolerance/hanging_detector.py``: a
detected stall writes a flight record (telemetry/flight_recorder.py)
before it is journaled and reported.
"""

import threading
import time
from collections import deque
from statistics import median
from typing import Callable, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import counter, record


class HangingDetector:
    """Flags a stalled training loop from the absence of step progress."""

    def __init__(
        self,
        report_fn: Optional[Callable[[float], None]] = None,
        min_timeout: float = 300.0,
        multiplier: float = 10.0,
        check_interval: float = 1.0,
        history: int = 50,
    ):
        if multiplier <= 1.0:
            raise ValueError(f"multiplier must be > 1, got {multiplier}")
        self._report_fn = report_fn
        self._min_timeout = min_timeout
        self._multiplier = multiplier
        self._check_interval = check_interval
        self._durations = deque(maxlen=history)
        self._last_step_time: float = 0.0  # 0 = not armed yet
        self._last_step: int = -1
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._reported_stall = False

    # -- feeding -----------------------------------------------------------

    def record_step(self, step: int) -> None:
        """Called after every completed optimizer step."""
        now = time.monotonic()
        with self._lock:
            if self._last_step_time > 0:
                duration = now - self._last_step_time
                threshold = (
                    max(
                        self._min_timeout,
                        self._multiplier * median(self._durations),
                    )
                    if self._durations else self._min_timeout
                )
                # a gap beyond the hang threshold was a stall (recovered
                # or transient), not training cadence — recording it
                # would inflate the threshold and mask the next hang
                if duration <= threshold:
                    self._durations.append(duration)
            self._last_step_time = now
            self._last_step = step
            self._reported_stall = False

    # -- threshold ---------------------------------------------------------

    def timeout(self) -> float:
        """Current adaptive hang threshold in seconds."""
        with self._lock:
            if not self._durations:
                return self._min_timeout
            return max(
                self._min_timeout,
                self._multiplier * median(self._durations),
            )

    def stalled_for(self) -> float:
        """Seconds since the last completed step (0 if not armed)."""
        with self._lock:
            if self._last_step_time <= 0:
                return 0.0
            return time.monotonic() - self._last_step_time

    @property
    def last_step(self) -> int:
        """The last completed step (-1 before the first one) — the
        ``/healthz`` degraded payload and flight records carry it."""
        with self._lock:
            return self._last_step

    def is_hanged(self) -> bool:
        elapsed = self.stalled_for()
        return elapsed > 0 and elapsed > self.timeout()

    # -- monitor thread ----------------------------------------------------

    def start(self) -> "HangingDetector":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="hang-detector"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopped.set()

    def _run(self) -> None:
        while not self._stopped.wait(self._check_interval):
            try:
                self._check_once()
            except Exception as e:  # never kill the monitor
                logger.warning("hang check failed: %s", e)

    def _check_once(self) -> None:
        if not self.is_hanged():
            return
        with self._lock:
            if self._reported_stall:
                return
            self._reported_stall = True
            elapsed = time.monotonic() - self._last_step_time
            step = self._last_step
        logger.error(
            "Training hang: no step since step %d for %.1fs "
            "(threshold %.1fs)", step, elapsed, self.timeout(),
        )
        counter(
            "dlrover_hang_stalls_total",
            "Stalls the step-progress hang detector flagged",
        ).inc()
        # flight record FIRST: the report_fn path can end in the master
        # restarting this process — the stacks must be on disk by then
        dump_path = None
        try:
            from dlrover_tpu_torch.telemetry import flight_recorder

            dump_path = flight_recorder.dump_on_hang(
                stalled_for=elapsed, step=step,
                threshold=self.timeout(),
            )
        except Exception as e:  # diagnosis never blocks the report
            logger.warning("hang flight record failed: %s", e)
        record(
            "hang.detected", step=step,
            stalled_for=round(elapsed, 1),
            stalled_s=round(elapsed, 1),
            threshold_s=round(self.timeout(), 1),
            flight_record=dump_path,
        )
        if self._report_fn is not None:
            self._report_fn(elapsed)
