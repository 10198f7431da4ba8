"""Silent-failure sentinel: NaN/SDC detection and rollback plumbing.

Fail-stop faults (crash, hang, preemption, master loss) are covered by
the drain/relaunch machinery; a silently corrupting node is not — a
NaN loss or a bit-flipped gradient trains straight through the
flash-checkpoint tiers and poisons every save. The
:class:`TrainingSentinel` is the worker-side detector the
``ElasticTrainer`` consults every step:

* **non-finite trip** — the loss scalar the trainer already pulls to
  host (and the optimizer's global grad norm when the ``optim/bf16``
  guard provides it) is checked with ``math.isfinite``; no extra D2H
  sync is added to the step.
* **loss-spike trip** — a rolling window of recent finite losses feeds
  a robust z-score (median + MAD); a sample further than
  ``DLROVER_TPU_SENTINEL_ZMAX`` deviations out trips the sentinel.
  Median/MAD (not mean/stddev) so the detector's own baseline is not
  dragged by the outliers it exists to catch.

A trip journals ``anomaly.detected``, opens the *anomaly window*
(checkpoints saved inside it are tagged ``last_good=False`` via
``FlashCheckpointer.set_clean_fn``), and reports to the master over
the supervised ``report_anomaly`` RPC carrying the last sentinel-clean
checkpoint step. The master answers with a coordinated rollback order
(or a ``job_failed`` verdict once ``DLROVER_TPU_MAX_ROLLBACKS`` is
exhausted); non-detecting ranks learn the same order from the master
KV store key ``sentinel/rollback_order``, polled on the step cadence.

A copy of ``dlrover_tpu/fault_tolerance/sentinel.py``; its telemetry
goes through the port's ``telemetry`` package. The optimizer's global
grad norm (the ``grad_norm`` input) waits for the bf16 optimizer's
non-finite guard (ROADMAP.md, queue A): the port's trainer passes the
loss alone.

Knobs (env):

  DLROVER_TPU_SENTINEL            "0" disables the sentinel entirely
  DLROVER_TPU_SENTINEL_WINDOW     rolling-window size (default 64)
  DLROVER_TPU_SENTINEL_ZMAX      robust z-score trip threshold (6.0)
  DLROVER_TPU_SENTINEL_MIN_STEPS warm-up samples before the spike
                                  detector arms (default 16)
"""

import json
import math
import os
from collections import deque
from typing import Optional

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import counter, gauge, record, tracing

#: KV-store key the master broadcasts rollback orders under; every
#: worker polls it so ranks that did not detect the anomaly still
#: converge on the same last-good step
ROLLBACK_ORDER_KEY = "sentinel/rollback_order"

#: 0.6745 scales MAD to the stddev of a normal distribution, so ZMAX
#: reads in "sigmas" like a plain z-score would
_MAD_SCALE = 0.6745


def _anomaly_counter():
    return counter(
        "dlrover_sentinel_anomalies_total",
        "Training anomalies the sentinel tripped on",
        ["kind"],
    )


class TrainingSentinel:
    """Per-step anomaly detector + coordinated-rollback client."""

    def __init__(
        self,
        master_client=None,
        window: int = 64,
        zmax: float = 6.0,
        min_steps: int = 16,
        node_rank: int = 0,
        host: str = "",
        poll_every: int = 1,
    ):
        self._client = master_client
        self._window = deque(maxlen=max(4, int(window)))
        self._zmax = float(zmax)
        self._min_steps = max(2, int(min_steps))
        self._node_rank = node_rank
        self._host = host
        self._poll_every = max(1, int(poll_every))
        #: open between a trip and the post-rollback reset: saves taken
        #: inside it are tagged last_good=False
        self._anomaly_open = False
        self._last_good_step: Optional[int] = None
        self._anomaly_count = 0
        #: highest rollback order id already acted on (orders are
        #: re-broadcast via KV; the id makes adoption exactly-once)
        self._seen_rollback_id = 0
        self._pending_rollback: Optional[dict] = None
        self._job_failed = False
        self._quarantined = False

    @classmethod
    def from_env(cls, master_client=None) -> Optional["TrainingSentinel"]:
        """Build from the process env; None when disabled."""
        if os.environ.get("DLROVER_TPU_SENTINEL", "1") in ("0", "off"):
            return None
        return cls(
            master_client=master_client,
            window=int(
                os.environ.get("DLROVER_TPU_SENTINEL_WINDOW", "64")
            ),
            zmax=float(
                os.environ.get("DLROVER_TPU_SENTINEL_ZMAX", "6.0")
            ),
            min_steps=int(
                os.environ.get("DLROVER_TPU_SENTINEL_MIN_STEPS", "16")
            ),
            node_rank=int(os.environ.get(NodeEnv.NODE_RANK, "0")),
            host=os.environ.get("HOSTNAME", ""),
        )

    # -- state the checkpoint layer consumes -------------------------------

    def is_clean(self) -> bool:
        """False inside an anomaly window — the ``set_clean_fn`` hook
        the FlashCheckpointer evaluates at save time."""
        return not self._anomaly_open

    @property
    def last_good_step(self) -> Optional[int]:
        return self._last_good_step

    @property
    def anomaly_count(self) -> int:
        return self._anomaly_count

    @property
    def job_failed(self) -> bool:
        """The master answered ``job_failed`` (rollback budget spent)."""
        return self._job_failed

    @property
    def quarantined(self) -> bool:
        """The master quarantined this rank's host (repeat offender):
        honor any pending rollback, then step aside so the job
        finishes on the remaining nodes."""
        return self._quarantined

    def note_checkpoint(self, step: int) -> None:
        """A save landed at ``step``; remember it as the rollback
        target while the window is clean."""
        if not self._anomaly_open:
            self._last_good_step = int(step)

    # -- detection ---------------------------------------------------------

    def check(self, step: int, loss, grad_norm=None) -> Optional[dict]:
        """Inspect one step's scalars; returns the anomaly record when
        tripped (after journaling + reporting it), else None. Also
        polls the master for rollback orders issued on behalf of a
        *different* rank's anomaly."""
        if step % self._poll_every == 0:
            self.poll_rollback_order()
        loss = float(loss)
        if grad_norm is not None and not math.isfinite(float(grad_norm)):
            return self._trip(
                "nonfinite_grad", step, float(grad_norm), None
            )
        if not math.isfinite(loss):
            return self._trip("nonfinite_loss", step, loss, None)
        zscore = self._spike_zscore(loss)
        if zscore is not None and zscore > self._zmax:
            return self._trip("loss_spike", step, loss, zscore)
        self._window.append(loss)
        return None

    def _spike_zscore(self, loss: float) -> Optional[float]:
        if len(self._window) < self._min_steps:
            return None
        ordered = sorted(self._window)
        n = len(ordered)
        med = (ordered[n // 2] + ordered[(n - 1) // 2]) / 2.0
        devs = sorted(abs(x - med) for x in ordered)
        mad = (devs[n // 2] + devs[(n - 1) // 2]) / 2.0
        if mad <= 0.0:
            # degenerate (constant) window: only a gross departure —
            # beyond the larger of 1.0 and the level itself — trips
            return math.inf if abs(loss - med) > max(
                1.0, abs(med)
            ) else None
        return _MAD_SCALE * abs(loss - med) / mad

    def _trip(
        self, kind: str, step: int, value: float,
        zscore: Optional[float],
    ) -> dict:
        self._anomaly_open = True
        self._anomaly_count += 1
        anomaly = {
            "kind": kind,
            "step": int(step),
            # non-finite floats are not valid JSON for the journal or
            # the RPC envelope; "kind" already carries the meaning
            "value": value if math.isfinite(value) else None,
            "zscore": zscore if zscore not in (None, math.inf) else None,
        }
        logger.error(
            "SENTINEL TRIP: %s at step %d (value=%r zscore=%s "
            "last_good=%s)", kind, step, value, zscore,
            self._last_good_step,
        )
        # journal-data key is "anomaly", not "kind" — record()'s first
        # parameter owns that name (same convention as fault.injected's
        # "fault" field)
        record(
            "anomaly.detected", node_rank=self._node_rank,
            host=self._host, last_good_step=self._last_good_step,
            anomaly=kind, step=anomaly["step"],
            value=anomaly["value"], zscore=anomaly["zscore"],
        )
        _anomaly_counter().labels(kind=kind).inc()
        anomaly["action"] = self._report(anomaly)
        return anomaly

    def _report(self, anomaly: dict) -> str:
        if self._client is None:
            return "none"
        resp = self._client.report_anomaly(
            kind=anomaly["kind"],
            step=anomaly["step"],
            value=anomaly["value"] if anomaly["value"] is not None
            else 0.0,
            zscore=anomaly["zscore"] or 0.0,
            host=self._host,
            last_good_step=self._last_good_step
            if self._last_good_step is not None else -1,
        )
        if resp is None:
            # the masterless client: no coordination available; the
            # local anomaly window still guards saves
            return "none"
        if getattr(resp, "quarantined", False) and not self._quarantined:
            self._quarantined = True
            logger.error(
                "QUARANTINED: the master evicted host %r after this "
                "report — finish the pending rollback, then stand "
                "down", self._host,
            )
        if resp.action == "rollback":
            self._adopt_order(
                int(resp.rollback_id), int(resp.rollback_step)
            )
        elif resp.action == "job_failed":
            self._job_failed = True
        return resp.action

    # -- coordinated rollback ----------------------------------------------

    def poll_rollback_order(self) -> Optional[dict]:
        """Check the master KV store for a rollback order issued on an
        anomaly some other rank detected."""
        if self._client is None:
            return self._pending_rollback
        try:
            raw = self._client.kv_store_get(ROLLBACK_ORDER_KEY)
        except Exception as e:
            logger.warning("rollback-order poll failed: %s", e)
            return self._pending_rollback
        if raw:
            try:
                order = json.loads(raw.decode())
                self._adopt_order(
                    int(order["id"]), int(order["step"]),
                    trace=str(order.get("trace", "")),
                )
            except (ValueError, KeyError) as e:
                logger.warning("bad rollback order %r: %s", raw, e)
        return self._pending_rollback

    def _adopt_order(self, rollback_id: int, step: int,
                     trace: str = "") -> None:
        if rollback_id <= self._seen_rollback_id:
            return
        self._seen_rollback_id = rollback_id
        self._pending_rollback = {"id": rollback_id, "step": step}
        # opens the rollback badput phase on this rank's ledger even
        # when the anomaly was detected elsewhere. The carried trace
        # (stamped at cut time in the servicer) chains this rank's
        # adoption under the initiating anomaly RPC.
        with tracing.trace_context(
            *tracing.parse_traceparent(trace)
        ), tracing.span("rollback.adopt", {
            "rollback": rollback_id, "rank": self._node_rank,
        }):
            record(
                "rollback.ordered", rollback_id=rollback_id, step=step,
                node_rank=self._node_rank,
            )

    def pending_rollback(self) -> Optional[dict]:
        return self._pending_rollback

    def note_restored(self, step: int, rollback_id: int = 0) -> None:
        """The rollback restore landed: journal it, close the anomaly
        window, and reset the spike baseline (pre-rollback losses are
        from a future this rank just rewound out of)."""
        record(
            "rollback.restored", step=int(step),
            rollback_id=rollback_id, node_rank=self._node_rank,
        )
        self._pending_rollback = None
        self._anomaly_open = False
        self._last_good_step = int(step)
        self._window.clear()
        gauge(
            "dlrover_sentinel_last_good_step",
            "Last sentinel-clean checkpoint step on this rank",
        ).set(float(step))
