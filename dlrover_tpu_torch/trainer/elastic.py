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

Not ported yet (ROADMAP.md, queue A): the fault-tolerance hooks of the
JAX trainer -- hang detector, fault injector, sentinel, mesh transition,
trace capture, drain coordinator, compile-cache telemetry -- and the
goodput ledger and fleet roll-up its ``report_step`` and
``maybe_checkpoint`` feed. A checkpoint failure is raised into the step
loop rather than logged: a failed device copy must not pass unseen.
"""

import time
from typing import Any, Callable, Dict, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
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
        self.set_world(cur_nodes)

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
        steps. Returns ``loss`` as a float (which waits for the step)
        when one is passed."""
        self._global_step = step if step is not None else (
            self._global_step + 1
        )
        tracing.set_step(self._global_step)
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
