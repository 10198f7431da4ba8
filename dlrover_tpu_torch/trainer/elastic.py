"""ElasticTrainer: a fixed global batch under a changing node count.

Counterpart of ``dlrover_tpu/trainer/elastic.py`` (parity reference:
dlrover/trainer/torch/elastic.py:170). When nodes drop out, each
remaining node runs ``ceil(max_nodes / cur_nodes)`` microbatches per
optimizer update, so the global batch and the optimizer's update count
stay what they were. Where the JAX trainer jits one step per
accumulation count, this one drives the port's
:class:`~dlrover_tpu_torch.trainer.sharded.ShardedTrainer`, which updates
the model and optimizer in place; :meth:`ElasticTrainer.set_world` moves
the moments and the update count across a change of accumulation count
(``ShardedTrainer.set_accum_steps``).

The in-place update is where the JAX trainer's donation contract lands:
once a checkpointer is attached, each step orders the optimizer's
in-place writes after the newest save's device-to-host copies
(``FlashCheckpointer.wait_staged``), so a save that returned before its
copies finished never sees the next update.

Two of the JAX trainer's fault-tolerance hooks are armed at
construction (``_init_fault_tolerance``) and fed by :meth:`report_step`:
the step-progress hang detector, which reports a stall to the master as
a HANG failure (the agent then restarts the process on the master's
action), and the fault injector of the drills (``DLROVER_FAULT_INJECT``).
Not ported yet (ROADMAP.md, queue A): the sentinel, mesh transition,
trace capture, drain coordinator and compile-cache telemetry, and the
goodput ledger and fleet roll-up that ``report_step`` and
``maybe_checkpoint`` feed. A checkpoint failure is raised into the step
loop rather than logged: a failed device copy must not pass unseen.
"""

import os
import time
import weakref
from typing import Any, Callable, Dict, Optional

from dlrover_tpu_torch.common.constants import TrainingExceptionLevel
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.fault_tolerance.hanging_detector import (
    HangingDetector,
)
from dlrover_tpu_torch.fault_tolerance.injection import FaultInjector
from dlrover_tpu_torch.telemetry import tracing


def compute_accum_steps(max_nodes: int, cur_nodes: int) -> int:
    """gradient_accumulation_steps = ceil(max/cur) keeps the global batch
    fixed when nodes drop out (parity: elastic.py:208)."""
    if cur_nodes <= 0:
        return 1
    return max(1, -(-max_nodes // cur_nodes))


class ElasticTrainer:
    """Keeps the global batch fixed across elastic world changes.

    Usage::

        elastic = ElasticTrainer(trainer, max_nodes=4,
                                 cur_nodes=env.node_num,
                                 master_client=client)
        loss = elastic.train_step(elastic.microbatch(batch))
        elastic.report_step(loss=loss)
        elastic.maybe_checkpoint(state)
    """

    def __init__(
        self,
        trainer,
        max_nodes: int,
        cur_nodes: int,
        master_client=None,
        report_interval: int = 10,
    ):
        self._trainer = trainer
        self._max_nodes = max_nodes
        self._master_client = master_client
        self._report_interval = report_interval
        self._step_cache: Dict[int, Callable] = {}
        self._global_step = 0
        self._checkpointer = None
        self._ckpt_interval = 0
        self._hang_detector = None
        self._fault_injector = None
        self._init_fault_tolerance()
        self.set_world(cur_nodes)

    def _init_fault_tolerance(self):
        """Step-progress hang detection (fault_tolerance/hanging_detector
        .py) + the injection drill hook. Both are no-ops without a master
        client; detection defaults on, DLROVER_HANG_DETECTION=0 disables,
        DLROVER_HANG_MIN_TIMEOUT / _MULTIPLIER tune the threshold."""
        self._fault_injector = FaultInjector.from_env(self._master_client)
        if self._master_client is None:
            return
        if os.environ.get("DLROVER_HANG_DETECTION", "1") == "0":
            return

        client = self._master_client
        # weak: the detector's thread must not keep the trainer, and the
        # model it drives, alive
        trainer = weakref.ref(self)

        def report(elapsed: float):
            me = trainer()
            try:
                client.report_failure(
                    f"no step progress for {elapsed:.1f}s (last step "
                    f"{me._global_step if me is not None else -1})",
                    TrainingExceptionLevel.HANG,
                )
            except Exception as e:
                logger.warning("hang report failed: %s", e)

        self._hang_detector = HangingDetector(
            report_fn=report,
            min_timeout=float(
                os.environ.get("DLROVER_HANG_MIN_TIMEOUT", "300")
            ),
            multiplier=float(
                os.environ.get("DLROVER_HANG_MULTIPLIER", "10")
            ),
        ).start()
        # ... and the thread ends with the trainer
        weakref.finalize(self, self._hang_detector.stop)

    def set_world(self, cur_nodes: int):
        self._cur_nodes = cur_nodes
        self._accum_steps = compute_accum_steps(self._max_nodes, cur_nodes)
        self._trainer.set_accum_steps(self._accum_steps)
        logger.info(
            "Elastic world: %d/%d nodes -> accum_steps=%d",
            cur_nodes, self._max_nodes, self._accum_steps,
        )

    @property
    def accum_steps(self) -> int:
        return self._accum_steps

    @property
    def trainer(self):
        return self._trainer

    @property
    def train_step(self) -> Callable:
        """The step for the current accumulation count, cached by it:
        ``train_step(batches) -> mean loss`` on ``[accum, batch/accum,
        ...]`` batches (see :meth:`microbatch`)."""
        key = self._accum_steps
        step_fn = self._step_cache.get(key)
        if step_fn is None:
            trainer = self._trainer

            def step_fn(batches):
                if trainer.accum_steps != key:
                    trainer.set_accum_steps(key)
                with tracing.span("train.dispatch"):
                    return trainer.train_step(batches)

            self._step_cache[key] = step_fn
        return step_fn

    def microbatch(self, batch):
        """Split a per-node batch into the accum microbatch layout
        [accum_steps, batch/accum, ...]."""
        a = self._accum_steps
        return tuple(
            x.reshape((a, x.shape[0] // a) + tuple(x.shape[1:]))
            for x in batch
        )

    def report_step(self, step: Optional[int] = None, loss=None):
        """Advance the step bookkeeping, tag spans with the step, and
        report the global step to the master every ``report_interval``
        steps. A completed step feeds the hang detector and is where a
        planted fault fires. Returns ``loss`` as a float (which waits
        for the step) when one is passed."""
        self._global_step = step if step is not None else (
            self._global_step + 1
        )
        tracing.set_step(self._global_step)
        if self._hang_detector is not None:
            self._hang_detector.record_step(self._global_step)
        if self._fault_injector is not None:
            self._fault_injector.maybe_inject(self._global_step)
        if loss is not None:
            loss = float(loss)
        if (
            self._master_client is not None
            and self._global_step % self._report_interval == 0
        ):
            try:
                self._master_client.report_global_step(
                    self._global_step, time.time()
                )
            except Exception as e:
                logger.warning("report_global_step failed: %s", e)
        return loss

    # ---------------------------------------------------------- checkpoint

    def attach_checkpointer(self, checkpointer,
                            save_interval: int = 10) -> None:
        """Register a :class:`~dlrover_tpu_torch.trainer.checkpoint.
        FlashCheckpointer` on the step cadence, and order each step's
        in-place optimizer writes after its newest save's copies
        (``wait_staged``)."""
        self._checkpointer = checkpointer
        self._ckpt_interval = max(0, int(save_interval))

        def before_update():
            with tracing.span("train.wait_staged"):
                checkpointer.wait_staged()

        self._trainer.before_update = before_update

    def checkpoint_due(self, step: Optional[int] = None) -> bool:
        step = self._global_step if step is None else step
        return (self._checkpointer is not None
                and self._ckpt_interval > 0 and step > 0
                and step % self._ckpt_interval == 0)

    def maybe_checkpoint(self, state: Any, step: Optional[int] = None,
                         force: bool = False,
                         durable: bool = False) -> Optional[float]:
        """Save ``state`` when the attached cadence is due (call after
        each step with the post-update state; a callable is called only
        then, to build it). Returns the train-thread stall in ms when a
        save was issued, else None. ``force`` also persists the save;
        ``durable`` waits until it is on the RAM tier
        (``FlashCheckpointer.save``)."""
        if self._checkpointer is None:
            return None
        step = self._global_step if step is None else step
        if not (force or self.checkpoint_due(step)):
            return None
        if callable(state):
            state = state()
        return self._checkpointer.save(step, state, force_persist=force,
                                       durable=durable)

    @property
    def global_step(self) -> int:
        return self._global_step
