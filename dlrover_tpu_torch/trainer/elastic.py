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

Four of the JAX trainer's fault-tolerance hooks are armed at
construction (``_init_fault_tolerance``): the step-progress hang
detector, which reports a stall to the master as a HANG failure (the
agent then restarts the process on the master's action); the fault
injector of the drills (``DLROVER_FAULT_INJECT``); the silent-failure
sentinel (``TrainingSentinel.from_env``), which :meth:`report_step`
feeds the step's loss (through the injector's ``corrupt_loss``) and
which tags the saves of an anomaly window (``set_clean_fn``); and the
preemption drain (``DrainCoordinator``, armed on SIGTERM), whose
emergency save takes the state :meth:`maybe_checkpoint` was last given
unless the loop sets its own provider. A step is open for the drain
from its dispatch to the end of :meth:`maybe_checkpoint` for it (or the
next dispatch): a notice inside it waits for its end, since the update
runs in place (fault_tolerance/drain.py). With the hang detector come
its observability hooks, installed after the drain is armed: ``/healthz``
reports the stall (telemetry/http.py), SIGTERM writes a flight record
before the drain's handler runs (telemetry/flight_recorder.py), and the
lock watch arms when ``DLROVER_TPU_LOCKWATCH=1``.

The process's goodput ledger (telemetry/goodput.py) is armed at
construction: :meth:`report_step` marks training, and the train-thread
stall that :meth:`maybe_checkpoint`'s save returns is credited as
``ckpt_stall``. :meth:`report_model_profile` sends the step's profile
(trainer/profiler.py) to the master, and ``DLROVER_TRACE_DIR`` opens a
window of ``torch.profiler`` trace over a few steps.

Reshard-in-place (``reshard/``): a ``MeshTransition`` armed at
construction (``DLROVER_TPU_RESHARD=0`` disables) adopts the master's
transition orders in :meth:`report_step`; the loop takes one at a step
boundary (:meth:`pending_reshard`, or :meth:`wait_reshard` after a step
that failed in a collective because a peer died) and carries it out in
process with :meth:`execute_reshard`: a new process group, the state
migrated to the new world's trainer, the data plane resized. A step
whose collective fails leaves the state at the last finished step where
the step runs every collective before its first in-place write (fsdp,
ddp, tp: ``ShardedTrainer._sharded_step``), so the survivor's live
tensors are those of its last save, and the live tier is pinned to that
step all the same (``LiveShardSource.step``); a step that raised inside
its update (a ZeRO step's gather after it) flags the state
(``ShardedTrainer.updating``), which then never serves as live. Not
ported yet (ROADMAP.md, queue A): compile-cache telemetry and the fleet
roll-up. A checkpoint failure is raised into the step loop rather than
logged: a failed device copy must not pass unseen.
"""

import os
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from dlrover_tpu_torch.common.constants import (
    NodeEnv,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.fault_tolerance.drain import DrainCoordinator
from dlrover_tpu_torch.fault_tolerance.hanging_detector import (
    HangingDetector,
)
from dlrover_tpu_torch.fault_tolerance.injection import FaultInjector
from dlrover_tpu_torch.fault_tolerance.sentinel import TrainingSentinel
from dlrover_tpu_torch.reshard import MeshTransition
from dlrover_tpu_torch.telemetry import (
    flight_recorder,
    goodput,
    lockwatch,
    record,
    tracing,
)
from dlrover_tpu_torch.telemetry.http import (
    attach_hang_detector,
    set_shard_provider,
)
from dlrover_tpu_torch.trainer import profiler


def _world() -> int:
    return dist.get_world_size() if (
        dist.is_available() and dist.is_initialized()) else 1


def _gather_pairs(pair) -> List[Tuple[int, int]]:
    """Every rank's int pair, over the gloo group of host tensors."""
    from dlrover_tpu_torch.trainer.distributed import host_group

    group = host_group()
    mine = torch.tensor(pair, dtype=torch.int64)
    rows = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(rows, mine, group=group)
    return [tuple(int(v) for v in r) for r in rows]


def _settled_step(store, settle_s: float = 0.5,
                  timeout_s: float = 10.0) -> int:
    """The newest step the store committed (-1: none), read until two
    reads ``settle_s`` apart agree: commits only add, and the old
    world's last uploads can still land while the new world decides.
    Restorable by any process of the new world: a sharded step through
    its step manifest, a one-process step through process 0's archive
    (``FlashCheckpointer._restore_v2``)."""
    from dlrover_tpu_torch.trainer import ckpt_store

    steps = ckpt_store.available_steps(store, 0)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        time.sleep(settle_s)
        again = ckpt_store.available_steps(store, 0)
        if again == steps:
            break
        steps = again
    return max(steps, default=-1)


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
        order = elastic.sentinel.pending_rollback()  # restore order["step"]

    ``max_nodes`` and ``cur_nodes`` count data-parallel ranks, which by
    default are those of the trainer's strategy on its mesh
    (``ShardedTrainer.data_parallel_size``: the axes of its rule table's
    batch entry): the ranks of one tensor group, or of one fsdp group
    under "rowwise", share a batch, so they add nothing to the global
    batch.
    """

    def __init__(
        self,
        trainer,
        max_nodes: Optional[int] = None,
        cur_nodes: Optional[int] = None,
        master_client=None,
        report_interval: int = 10,
    ):
        dp = getattr(trainer, "data_parallel_size", 1)
        max_nodes = dp if max_nodes is None else max_nodes
        cur_nodes = dp if cur_nodes is None else cur_nodes
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
        #: (step, state) given to the newest maybe_checkpoint: the
        #: drain's emergency save takes it
        self._last_state = None
        # per-process goodput ledger (telemetry/goodput.py): phase
        # transitions ride on events that already fire; the trainer
        # only marks steps (-> training) and checkpoint stalls
        self._goodput = goodput.install()
        self._init_fault_tolerance()
        self.set_world(cur_nodes)

    def _init_fault_tolerance(self):
        """Step-progress hang detection (fault_tolerance/hanging_detector
        .py), the injection drill hook, the silent-failure sentinel
        (``DLROVER_TPU_SENTINEL=0`` disables) and the graceful drain on
        SIGTERM. Hang detection needs a master client; it defaults on,
        DLROVER_HANG_DETECTION=0 disables, DLROVER_HANG_MIN_TIMEOUT /
        _MULTIPLIER tune the threshold."""
        self._fault_injector = FaultInjector.from_env(self._master_client)
        self._sentinel = TrainingSentinel.from_env(self._master_client)
        # reshard-in-place (reshard/transition.py): adopts the master's
        # transition orders exactly once; the step loop carries them
        # out at a boundary (pending_reshard, execute_reshard)
        self._mesh_transition = MeshTransition.from_env(
            self._master_client)
        # zero-code timeline capture (DLROVER_TRACE_DIR): see
        # trainer/profiler.py TraceCapture
        self._trace_capture = profiler.TraceCapture.from_env()
        # weak: neither the signal handler nor the detector's thread may
        # keep the trainer, and the model it drives, alive
        trainer = weakref.ref(self)

        def attr(name):
            me = trainer()
            return None if me is None else getattr(me, name)

        def stalled():
            # a hung step never reaches its end: drain without waiting
            detector = attr("_hang_detector")
            return detector is not None and detector.is_hanged()

        self._drain = DrainCoordinator(
            master_client_fn=lambda: attr("_master_client"),
            checkpointer_fn=lambda: attr("_checkpointer"),
            state_provider=lambda: attr("_last_state"),
            restart_count=int(
                os.environ.get(NodeEnv.RESTART_COUNT, "0") or 0
            ),
            stalled_fn=stalled,
        )
        self._drain.arm()
        if self._master_client is None:
            return
        if os.environ.get("DLROVER_HANG_DETECTION", "1") == "0":
            return

        client = self._master_client

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
        # observability wiring around the detector: /healthz on any
        # telemetry endpoint in THIS process reports the stall (503 +
        # stalled_for), and a SIGTERM leaves a flight record (all-thread
        # stacks + last spans). The recorder hooks SIGTERM after the
        # drain, so it dumps first and then hands the signal to the
        # drain's handler, which holds it to the step's end
        attach_hang_detector(self._hang_detector)
        flight_recorder.install_signal_hook()
        # runtime lock-order watchdog (no-op unless
        # DLROVER_TPU_LOCKWATCH=1); late is still useful — the
        # trainer's own locks are created after this point
        lockwatch.install()

    def set_world(self, cur_nodes: int):
        self._cur_nodes = cur_nodes
        self._accum_steps = compute_accum_steps(self._max_nodes, cur_nodes)
        if self._trainer is not None:  # a joiner has none until it joins
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
            trainer, drain = self._trainer, self._drain

            def step_fn(batches):
                # the state is whole until this dispatch: a notice that
                # waited for the previous step's end drains here at the
                # latest, and one from now on waits for this step's
                drain.release()
                drain.hold()
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

    def report_model_profile(self, batch, batch_size: int = 0,
                             seq_len: int = 0):
        """Profile one forward and backward of the current step on
        ``batch`` (the layout :attr:`train_step` takes) and send it to
        the master's stats pipeline (trainer/profiler.py). The training
        state, the random generators and the flash kernels' launch
        counts are as before. Call once after the first step; a failure
        is logged and never interrupts training."""
        if self._master_client is None:
            return None
        try:
            prof = profiler.profile_step(
                self._trainer.forward_backward, batch,
                params=self._trainer.model,
            )
        except Exception as e:
            logger.warning("model profiling failed: %s", e)
            return None
        profiler.report_profile(
            self._master_client, prof, batch_size=batch_size,
            seq_len=seq_len,
        )
        return prof

    def report_step(self, step: Optional[int] = None, loss=None,
                    grad_norm=None):
        """Advance the step bookkeeping, tag spans with the step, and
        report the global step to the master every ``report_interval``
        steps. A completed step feeds the hang detector; its loss
        (through a planted corruption) goes to the sentinel, which
        otherwise polls for a rollback order; above one rank the ranks
        then agree on the rollback order (ROADMAP C.1), and a planted
        fault fires last. Returns ``loss`` as a float (which waits for
        the step) when one is passed."""
        self._global_step = step if step is not None else (
            self._global_step + 1
        )
        tracing.set_step(self._global_step)
        # a completed step is the proof of useful work: it opens the
        # training phase and closes any hang/restart window
        self._goodput.on_step()
        if self._hang_detector is not None:
            self._hang_detector.record_step(self._global_step)
        if self._trace_capture is not None:
            self._trace_capture.step(self._global_step)
        if loss is not None:
            loss = float(loss)
            if self._fault_injector is not None:
                # corruption drills (nan@N / sdc@N) poison the scalar
                # here so the sentinel sees exactly what a corrupting
                # host would produce
                loss = self._fault_injector.corrupt_loss(
                    self._global_step, loss
                )
            if self._sentinel is not None:
                self._sentinel.check(self._global_step, loss, grad_norm)
        elif self._sentinel is not None:
            # no scalar this step: still poll for rollback orders
            # issued on another rank's anomaly
            self._sentinel.poll_rollback_order()
        if self._sentinel is not None and _world() > 1:
            # the ranks adopt an order at the same step boundary
            self._sentinel.agree_rollback(_gather_pairs)
        if self._mesh_transition is not None:
            # transition orders are adopted here (exactly once by order
            # id) and carried out by the step loop at the boundary it
            # chooses -- see pending_reshard()
            self._mesh_transition.poll_order()
        if self._fault_injector is not None:
            # after the ranks' agreement: a planted crash or hang ends
            # the step as a real one would, its collectives all run
            self._fault_injector.maybe_inject(self._global_step)
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
        if self._sentinel is not None and hasattr(
            checkpointer, "set_clean_fn"
        ):
            # archives saved inside an anomaly window get tagged
            # last_good=False and are skipped by the restore walk-down
            checkpointer.set_clean_fn(self._sentinel.is_clean)

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
        (``FlashCheckpointer.save``). This is the step's end for the
        drain: a notice that landed inside the step drains here, before
        any cadence save; one that lands during the cadence save waits
        for its end, since the emergency save needs the pinned block and
        the serializer that this save holds."""
        step = self._global_step if step is None else step
        self._last_state = (step, state)
        self._drain.release()
        self._drain.hold()
        try:
            if self._checkpointer is None:
                return None
            if not (force or self.checkpoint_due(step)):
                return None
            if callable(state):
                state = state()
            stall_ms = self._checkpointer.save(
                step, state, force_persist=force, durable=durable)
            if self._sentinel is not None:
                # ignored inside an anomaly window: a tainted save is
                # never a rollback target
                self._sentinel.note_checkpoint(step)
            if stall_ms:
                # the train-thread stall save() measured (not the
                # archive's time, nor the drain's hold) re-labels the
                # tail of the current training interval as ckpt_stall
                self._goodput.credit(goodput.Phase.CKPT_STALL,
                                     stall_ms / 1000.0)
            return stall_ms
        finally:
            # a notice during the cadence save drains after it
            self._drain.release()

    @property
    def global_step(self) -> int:
        return self._global_step

    @property
    def checkpointer(self):
        """The attached checkpointer (a mesh transition replaces it)."""
        return self._checkpointer

    # ------------------------------------------------------------ reshard

    def pending_reshard(self):
        """The adopted but not yet executed :class:`~dlrover_tpu_torch.
        reshard.order.TransitionOrder`, or None. The step loop checks
        it at each step boundary and carries a hit out with
        :meth:`execute_reshard`."""
        if self._mesh_transition is None:
            return None
        return self._mesh_transition.pending()

    @property
    def mesh_transition(self) -> Optional[MeshTransition]:
        """The armed :class:`~dlrover_tpu_torch.reshard.transition.
        MeshTransition` (None when DLROVER_TPU_RESHARD=0)."""
        return self._mesh_transition

    def wait_reshard(self, timeout: float, poll: float = 0.2):
        """Poll for a transition order for up to ``timeout`` seconds: a
        step failed in a collective because a peer died, or a joiner
        waits to be grown in. Returns the adopted order (still pending,
        for :meth:`execute_reshard`), or None when none came, the
        transition was aborted (``mesh_transition.fallback``) or this
        rank was excluded."""
        mt = self._mesh_transition
        if mt is None:
            return None
        deadline = time.monotonic() + timeout
        while True:
            order = mt.poll_order()
            if order is not None or mt.fallback or mt.excluded:
                return order
            if time.monotonic() > deadline:
                return None
            time.sleep(poll)

    def execute_reshard(
        self,
        order,
        build_trainer: Callable[[], Any],
        persist_dir: str,
        ckpt_kwargs: Optional[Dict[str, Any]] = None,
        peer_url: str = "",
        live_step: Optional[int] = None,
        resize: Optional[Callable[[int, int, Any], None]] = None,
        extra_sources: Optional[List[Any]] = None,
        backend: Optional[str] = None,
        timeout_s: float = 120.0,
        save_interval: Optional[int] = None,
    ) -> Optional[Dict[str, Any]]:
        """Carry ``order`` out at this step boundary, in process.

        ``build_trainer()`` builds and initializes the trainer of the
        new world (its mesh from the re-formed group); the restore target
        takes the dtypes the pinned step saved (fp32 AdamW moments stay
        fp32, ``ckpt_store.with_dtypes``), the state then picks the
        optimizer (``load_train_state``) and ``set_world`` the new
        world's microbatch count. The state is
        ``{"model", "optimizer", "step", "data"}`` as the
        examples save it, flash-saved under ``persist_dir``. A survivor
        passes ``live_step``, the step its live state holds (its last
        finished step); a joiner passes None. In order:

        1. the process group is re-formed among the new world
           (``distributed.reform_world``; the address through the
           master KV under the order's id);
        2. the save-attempt namespace (``NodeEnv.RDZV_ROUND``) becomes
           the order id, so the new world's uploads never mix with the
           old world's partial ones;
        3. the restore step is pinned across the world
           (``MeshTransition.agree_step``: the newest step the store
           committed, read until two reads agree);
        4. a checkpointer for ``(new_index, world_size)`` replaces the
           attached one on its cadence (``save_interval``, by default
           the attached one's; ``ckpt_kwargs``: its other arguments; a
           ``peer_url``, this process's telemetry server, serves and
           advertises its RAM tier);
        5. the state moves: a survivor runs ``migrate_live`` (its live
           boxes first, the checkpoint tiers for the rest); a joiner
           runs ``migrate_from_checkpoint`` with ``extra_sources`` (a
           hot spare's cache);
        6. ``set_world`` and ``resize(world_size, new_index, data)``
           (the sampler's or sharding client's, with the restored
           ``"data"``);
        7. ``note_migrated`` and then ``complete``.

        Returns ``{"step", "stats", "seconds", "parts", "world_size",
        "index", "order"}`` (``parts``: the seconds of the re-form, the
        pin, the build, the migration and the load), or None when the
        transition was aborted (no step to
        restore, a refused report): the caller then takes the
        restart-the-world path.
        """
        from dlrover_tpu_torch.checkpoint.peer import PeerRegistry
        from dlrover_tpu_torch.reshard.migrate import (
            merge_stats,
            migrate_from_checkpoint,
            migrate_live,
        )
        from dlrover_tpu_torch.trainer import ckpt_store
        from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer
        from dlrover_tpu_torch.trainer.distributed import reform_world

        mt = self._mesh_transition
        t0 = time.time()
        if mt.pending() is order:
            mt.pop_pending()  # taken at this boundary
        new_index = order.new_index(mt.node_rank)
        old = self._trainer if live_step is not None else None
        # the live state is read before the old group goes: its boxes
        # are this rank's own, no collective builds them. A step that
        # raised inside its update left it half-updated: never live
        live = None
        if old is not None and not old.updating:
            live = {**old.train_state(), "step": int(live_step), "data": ""}
        elif old is not None:
            logger.warning("the live state of rank %d is half-updated: "
                           "its boxes come from the checkpoint tiers",
                           mt.node_rank)
        with tracing.span("reshard.execute", {"order": order.id}):
            parts, t_part = {}, time.time()

            def part(name):
                nonlocal t_part
                now = time.time()
                parts[name] = now - t_part
                t_part = now

            reform_world(order.world_size, new_index, self._master_client,
                         f"reshard/world/{order.id}/addr",
                         timeout_s=timeout_s, backend=backend)
            os.environ[NodeEnv.RDZV_ROUND] = str(order.id)
            part("reform_s")
            store = ckpt_store.get_store(persist_dir)
            step = mt.agree_step(
                order, lambda: _settled_step(store),
                timeout=timeout_s)
            part("pin_s")
            if step < 0:
                mt.abort(order, "no committed step to migrate from")
                return None
            if self._checkpointer is not None:
                self._checkpointer.close()
            registry = (PeerRegistry(self._master_client, new_index, peer_url)
                        if peer_url else None)
            ckpt = FlashCheckpointer(
                persist_dir, process_index=new_index,
                n_processes=order.world_size, peer_registry=registry,
                **(ckpt_kwargs or {}))
            if peer_url:
                set_shard_provider(ckpt.shard_provider())
            trainer = build_trainer()
            target = ckpt_store.with_dtypes(
                {**trainer.train_state(), "step": 0, "data": ""},
                ckpt_store.step_dtypes(store, step))
            part("build_s")
            if live is not None:
                state, got, stats = migrate_live(
                    ckpt, live, target=target, step=step,
                    live_step=live_step)
            else:
                state, got, stats = migrate_from_checkpoint(
                    ckpt, target=target, step=step,
                    extra_sources=extra_sources)
            if state is None or got != step:
                ckpt.close()
                mt.abort(order, f"migration found {got}, wanted {step}")
                return None
            part("migrate_s")
            stats = merge_stats(stats)
            data = state.get("data")
            trainer.load_train_state(state)
            del state, live, old
            self._trainer = trainer
            self._step_cache.clear()
            self._global_step = step
            self.set_world(order.world_size)
            self.attach_checkpointer(
                ckpt, self._ckpt_interval if save_interval is None
                else save_interval)
            if resize is not None:
                resize(order.world_size, new_index, data)
            part("load_s")
            seconds = time.time() - t0
            # "none": a master without a coordinator supervises nothing
            carry_on = ("ok", "none", None)
            if (mt.note_migrated(order, stats, duration_s=seconds)
                    not in carry_on or mt.complete(order) not in carry_on):
                return None
        record("reshard.executed", order_id=order.id, step=step,
               world_size=order.world_size, index=new_index,
               seconds=round(seconds, 6), **parts)
        return {"step": step, "stats": stats, "seconds": seconds,
                "parts": parts, "world_size": order.world_size,
                "index": new_index, "order": order.id}

    @property
    def sentinel(self) -> Optional[TrainingSentinel]:
        """The armed :class:`~dlrover_tpu_torch.fault_tolerance.sentinel.
        TrainingSentinel` (None when DLROVER_TPU_SENTINEL=0)."""
        return self._sentinel

    @property
    def drain(self) -> DrainCoordinator:
        """The armed :class:`~dlrover_tpu_torch.fault_tolerance.drain.
        DrainCoordinator` (set its state provider where the loop knows
        its step and state better than :meth:`maybe_checkpoint`)."""
        return self._drain
