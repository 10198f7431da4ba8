"""Distributed job master: full control plane for multi-host jobs.

Parity reference: dlrover/python/master/dist_master.py:53
(DistributedJobMaster composing JobManager/TaskManager/RendezvousManagers/
SpeedMonitor/JobAutoScaler, prepare:129, 30s run loop:165 with
exit-reason logic).

Counterpart of ``dlrover_tpu/master/dist_master.py``: the platform's
scaler and watcher under the distributed job manager (status flow,
relaunch policy, heartbeat watchdog), the auto-scaler behind
``request_scale``, the quarantine's placement sink into the scaler, the
durable state journal (the KV store, the rendezvous rounds and params,
the global step, the datasets' shard ledgers and the goodput account)
and its restore into a restarted master, and, with
``DLROVER_TPU_RESHARD=1``, the ``TransitionCoordinator`` fed by the
master's own node events. ``master_crash`` (fault_tolerance/injection.py)
fires in its run loop.

Left out, each refused where JAX builds it so nothing is dropped
quietly:

* the Brain (ROADMAP.md, queue A.2.4): a ``brain_client``, a job's
  ``brain_addr`` or ``brain_store_path``, and ``DLROVER_TPU_BRAIN`` set
  to anything but ``off`` raise. JAX's resource advisor and its stats
  archive are not built.
* serving (queue A.3): ``DLROVER_TPU_SERVE_AUTOSCALE`` on raises. There
  is no request router, so the ``serve_*`` RPCs stay "unknown RPC
  method" and the run loop has no serving stream to drain.
* the fleet plane (queue A.2.5): ``/fleet`` keeps answering 404
  (telemetry/http.py) and no SLO signal is registered.
"""

import os
import time
from typing import Optional

from dlrover_tpu_torch.common.constants import (
    JobExitReason,
    NodeType,
    RendezvousName,
    TaskType,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.elastic_training.kv_store_service import (
    KVStoreService,
)
from dlrover_tpu_torch.master.elastic_training.rdzv_manager import (
    ElasticTrainingRendezvousManager,
    NetworkCheckRendezvousManager,
)
from dlrover_tpu_torch.master.elastic_training.sync_service import (
    SyncService,
)
from dlrover_tpu_torch.master.monitor.error_monitor import ErrorMonitor
from dlrover_tpu_torch.master.monitor.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.master.node.dist_job_manager import create_job_manager
from dlrover_tpu_torch.master.node.job_auto_scaler import new_job_auto_scaler
from dlrover_tpu_torch.master.node.quarantine import QuarantineManager
from dlrover_tpu_torch.master.resource.local_optimizer import (
    TPULocalOptimizer,
)
from dlrover_tpu_torch.master.servicer import create_master_service
from dlrover_tpu_torch.master.shard.dataset_splitter import (
    new_dataset_splitter,
)
from dlrover_tpu_torch.master.shard.task_manager import TaskManager
from dlrover_tpu_torch.master.state_journal import build_master_state_journal
from dlrover_tpu_torch.master.stats import (
    JobMeta,
    JobMetricCollector,
    LocalStatsReporter,
)
from dlrover_tpu_torch.reshard.coordinator import (
    TransitionCoordinator,
    reshard_opted_in,
)
from dlrover_tpu_torch.telemetry import goodput as goodput_mod
from dlrover_tpu_torch.telemetry import record
from dlrover_tpu_torch.telemetry.http import start_metrics_server

#: how long the servicer stays up after the last data task completes:
#: must cover a full WAIT-poll cycle of the sharding client (0.5s)
#: plus scheduling slack, so every worker sees the dataset drain
#: instead of a dead socket
_COMPLETION_GRACE = 2.0


def _refuse_left_out(job_args, brain_client) -> None:
    """Raise for each knob that would turn on a plane the port's master
    does not build (the module docstring lists them)."""
    if (brain_client is not None
            or getattr(job_args, "brain_addr", "")
            or getattr(job_args, "brain_store_path", "")):
        raise NotImplementedError(
            "the Brain (brain_client, brain_addr, brain_store_path) "
            "waits for the port of brain/ (ROADMAP.md, queue A.2.4)")
    brain = os.environ.get("DLROVER_TPU_BRAIN")
    if brain is not None and brain.strip().lower() != "off":
        raise NotImplementedError(
            f"DLROVER_TPU_BRAIN={brain!r}: the resource advisor waits "
            "for the port of brain/ (ROADMAP.md, queue A.2.4)")
    if os.environ.get("DLROVER_TPU_SERVE_AUTOSCALE", "").lower() not in (
            "", "0", "off", "false"):
        raise NotImplementedError(
            "DLROVER_TPU_SERVE_AUTOSCALE: the serving router and "
            "autoscaler wait for the port of serving/ (ROADMAP.md, "
            "queue A.3)")


class DistributedJobMaster:
    """Composes every master-side manager and runs the job loop.

    The scaler/watcher pair defines the platform: ProcessScaler for a
    single host or fake-cluster tests.
    """

    def __init__(self, port: int = 0, job_args=None, scaler=None,
                 watcher=None, autoscale_interval: float = 60.0,
                 brain_client=None, state_dir: Optional[str] = None,
                 fresh: bool = False):
        _refuse_left_out(job_args, brain_client)
        self.speed_monitor = SpeedMonitor()
        # anomaly attribution across incarnations: the quarantine
        # rides on the error monitor so the servicer (anomaly reports)
        # and the job manager (relaunch placement) share one verdict;
        # newly quarantined hosts merge into the scaler's placement
        # blacklist
        self.quarantine = QuarantineManager(
            placement_sink=(
                scaler.add_avoid_hosts if scaler is not None else None
            )
        )
        self.error_monitor = ErrorMonitor(quarantine=self.quarantine)
        job_name = getattr(job_args, "job_name", "") or "job"
        # durable job-state journal (master/state_journal.py): None
        # unless a state dir is configured (env or --state_dir)
        self.state_journal = build_master_state_journal(
            job_name, state_dir=state_dir, fresh=fresh
        )
        job_meta = JobMeta(
            uuid=f"{job_name}-{int(time.time())}",
            name=job_name,
            namespace=getattr(job_args, "namespace", "default"),
        )
        self.stats_reporter = LocalStatsReporter(job_meta)
        self.job_metric_collector = JobMetricCollector(
            job_meta, reporter=self.stats_reporter
        )
        self.job_optimizer = TPULocalOptimizer(
            job_args=job_args, speed_monitor=self.speed_monitor,
            node_unit=getattr(job_args, "node_unit", 1) if job_args else 1,
            stats_reporter=self.stats_reporter,
        )
        self.job_manager = create_job_manager(
            job_args, self.speed_monitor, scaler=scaler, watcher=watcher,
            job_optimizer=self.job_optimizer,
            error_monitor=self.error_monitor,
        )
        self.task_manager = TaskManager(speed_monitor=self.speed_monitor)
        self.rdzv_managers = {
            RendezvousName.TRAINING: ElasticTrainingRendezvousManager(),
            RendezvousName.NETWORK_CHECK: NetworkCheckRendezvousManager(),
        }
        self.kv_store = KVStoreService(
            listener=(
                self.state_journal.save_kv if self.state_journal else None
            )
        )
        # the round listener is single-slot, and two consumers want
        # it: the state journal (crash recovery) and the transition
        # coordinator (a completed TRAINING round seals the reshard
        # membership so later unseen RUNNING ranks read as joins) —
        # _on_rdzv_round fans out to whichever are configured
        for name, mgr in self.rdzv_managers.items():
            mgr.set_round_listener(
                lambda r, _n=name: self._on_rdzv_round(_n, r)
            )
        if self.state_journal is not None:
            self.task_manager.attach_state_journal(self.state_journal)
            for name, mgr in self.rdzv_managers.items():
                mgr.set_params_listener(
                    lambda p, _n=name:
                        self.state_journal.save_rdzv_params(_n, p)
                )
            # with the group-commit lane on, the lane does the
            # coalescing — the monitor-side 1/s throttle would only
            # add staleness on top of the flush window
            self.speed_monitor.set_step_listener(
                self.state_journal.save_global_step,
                persist_interval=(
                    0.0 if self.state_journal.coalescing else 1.0
                ),
            )
        # job-wide goodput/badput/MTTR accounting: worker ledgers ride
        # in on report_global_step / report_goodput, the aggregator
        # checkpoints itself through the state journal so the account
        # survives a master kill (telemetry/goodput.py)
        coalescing = bool(
            self.state_journal and self.state_journal.coalescing)
        self.goodput_aggregator = goodput_mod.GoodputAggregator(
            persist_fn=(
                self.state_journal.save_goodput
                if self.state_journal else None
            ),
            persist_interval=0.0 if coalescing else 1.0,
        )
        # reshard-in-place (reshard/coordinator.py): node loss/join
        # becomes an online mesh transition. Opt-in
        # (DLROVER_TPU_RESHARD=1): the coordinator changes the recovery
        # semantics of every worker loss, so jobs without the flag keep
        # restart-the-world.
        self.transition_coordinator = None
        if reshard_opted_in():
            self.transition_coordinator = TransitionCoordinator(
                self.kv_store,
                task_manager=self.task_manager,
                goodput=self.goodput_aggregator,
                fallback_fn=self._reshard_fallback,
            )
        self.sync_service = SyncService(self.job_manager)
        self.auto_scaler = new_job_auto_scaler(
            self.job_manager, self.job_optimizer, scaler,
            interval=autoscale_interval,
            # straggler shrink reads the network-check pairing verdicts
            straggler_fn=self.rdzv_managers[
                RendezvousName.NETWORK_CHECK
            ].get_straggler_nodes,
            min_nodes=getattr(job_args, "min_node_num", 0) or 0,
            # the elasticity ceiling: maxReplicas when declared, else
            # the provisioned count (no throughput growth possible)
            max_nodes=max(
                getattr(job_args, "max_node_num", 0) or 0,
                getattr(job_args, "node_num", 0) or 0,
            ),
        )
        self._server, self.servicer = create_master_service(
            port,
            task_manager=self.task_manager,
            job_manager=self.job_manager,
            speed_monitor=self.speed_monitor,
            rdzv_managers=self.rdzv_managers,
            sync_service=self.sync_service,
            error_monitor=self.error_monitor,
            job_metric_collector=self.job_metric_collector,
            auto_scaler=self.auto_scaler,
            kv_store=self.kv_store,
            goodput_aggregator=self.goodput_aggregator,
            transition_coordinator=self.transition_coordinator,
        )
        self.port = self._server.port
        self._exit_code = 0
        self._exit_reason = ""
        self._metrics_server = None
        self._goodput_summary_recorded = False
        self._wire_callbacks()
        # restore BEFORE prepare() opens the server: agents must never
        # observe the pre-restore (empty) state
        self._restore_state()

    @property
    def addr(self) -> str:
        return f"localhost:{self.port}"

    @property
    def metrics_port(self) -> int:
        return self._metrics_server.port if self._metrics_server else 0

    def _wire_callbacks(self):
        """parity: event_callback.py — node events fan out to task
        recovery and rendezvous alive-set maintenance."""

        def on_failed(node):
            if node.type != NodeType.WORKER:
                return
            rank = (node.rank_index if node.rank_index is not None
                    else node.id)
            # reshard-in-place first: when the coordinator cuts a
            # shrink order for this loss, the survivors transition
            # online and the dead rank must NOT be relaunched (the new
            # world does not include it). A None order — disabled,
            # budget spent, world too small, transition in flight —
            # falls through to the restart path untouched.
            if self.transition_coordinator is not None:
                order = self.transition_coordinator.note_node_lost(
                    rank, reason=node.exit_reason or ""
                )
                if order is not None:
                    node.relaunchable = False
            # requeue the dead worker's data shards
            # (parity: TaskRescheduleCallback event_callback.py:117);
            # a no-op after the coordinator's exactly-once relinquish
            self.task_manager.recover_tasks(node.type, node.id)
            # rendezvous sets are keyed by RANK: a relaunched node keeps
            # its rank under a fresh id
            for mgr in self.rdzv_managers.values():
                mgr.remove_alive_node(rank)

        self.job_manager.add_callback("on_node_failed", on_failed)
        self.job_manager.add_callback("on_node_deleted", on_failed)

    def _restore_state(self):
        """Resume a prior incarnation's job state from the journal.

        Datasets are rebuilt from their journaled params and their
        ledger restored with keep_doing=True: in-flight shards stay
        assigned under their original task ids, so a surviving worker's
        completion report is accepted instead of the shard being
        re-dispatched (exactly-once across the master restart). The
        rendezvous round counters resume so coordinator-election KV keys
        (keyed by round) never regress; the KV store itself comes back
        verbatim."""
        journal = self.state_journal
        if journal is None:
            return
        if not journal.has_state():
            journal.mark_started()
            return
        restored_datasets = []
        for name in journal.saved_datasets():
            params, ckpt = journal.load_dataset(name)
            try:
                splitter = new_dataset_splitter(
                    shuffle=params.get("shuffle", False),
                    shard_size=params["batch_size"]
                    * params.get("num_minibatches_per_shard", 1),
                    dataset_size=params["dataset_size"],
                    num_epochs=params.get("num_epochs", 1),
                    dataset_name=name,
                    storage_type=params.get("storage_type", "table"),
                )
                self.task_manager.new_dataset(
                    batch_size=params["batch_size"],
                    dataset_size=params["dataset_size"],
                    dataset_name=name,
                    dataset_splitter=splitter,
                    task_type=params.get("task_type")
                    or TaskType.TRAINING,
                    params=params,
                )
                if ckpt:
                    self.task_manager.restore_dataset_from_checkpoint(
                        ckpt, keep_doing=True
                    )
                restored_datasets.append(name)
            except Exception as e:
                logger.error(
                    "Failed to restore dataset %s from the state "
                    "journal: %s", name, e,
                )
        kv_data = journal.load_kv()
        if kv_data:
            self.kv_store.load(kv_data)
        rounds = journal.load_rdzv_rounds()
        rdzv_params = journal.load_rdzv_params()
        for name, mgr in self.rdzv_managers.items():
            if name in rounds:
                mgr.restore_round(rounds[name])
            if name in rdzv_params:
                # round completion is gated on reported params: restore
                # them so re-joining agents can form a world before any
                # agent re-reports
                mgr.update_rdzv_params(**rdzv_params[name])
        step, batch_feed = journal.load_global_step()
        if step:
            self.speed_monitor.restore_global_step(
                step, batch_feed=batch_feed
            )
        goodput_state = journal.load_goodput()
        if goodput_state:
            # the window since the prior incarnation's last persist is
            # the master's own downtime: restore folds it in as one
            # more (recovered) fault toward MTTR/MTBF
            self.goodput_aggregator.restore_state(goodput_state)
        journal.mark_started()
        record(
            "master.restored",
            datasets=restored_datasets,
            kv_keys=len(kv_data),
            rdzv_rounds=rounds,
            global_step=step,
        )
        logger.info(
            "Restored master state: datasets=%s kv_keys=%d "
            "rdzv_rounds=%s global_step=%d",
            restored_datasets, len(kv_data), rounds, step,
        )

    def prepare(self):
        init_plan = self.job_optimizer.init_job_resource(None)
        if not init_plan.empty():
            worker = init_plan.node_group_resources.get(NodeType.WORKER)
            if worker:
                self.speed_monitor.set_target_worker_num(worker.count)
        self.job_manager.start()
        self.task_manager.start()
        self.auto_scaler.start_auto_scaling()
        self._server.start()
        # /goodput on this master serves the job-level aggregation
        # (and refreshes the goodput gauges on every read)
        goodput_mod.set_job_provider(self._goodput_summary)
        # Prometheus /metrics + /journal (telemetry/http.py);
        # DLROVER_TPU_METRICS_PORT pins the port, "off" disables
        self._metrics_server = start_metrics_server()
        logger.info("Distributed master serving on port %d", self.port)

    def run(self, check_interval: float = 3.0) -> int:
        """parity: dist_master.py:165 — run until workers finish/fail."""
        # chaos drills: DLROVER_FAULT_INJECT master_crash@step[:delay]
        # kills THIS process when the reported global step arrives
        # (fault_tolerance/injection.py; worker kinds are filtered out)
        from dlrover_tpu_torch.fault_tolerance.injection import (
            FaultInjector,
        )

        injector = FaultInjector.from_env(role="master")
        try:
            while True:
                if injector is not None:
                    injector.maybe_inject(
                        self.speed_monitor.completed_global_step
                    )
                if self.job_manager.all_workers_exited():
                    if self.job_manager.all_workers_succeeded():
                        self._exit_reason = JobExitReason.SUCCEEDED
                    else:
                        self._exit_code = 1
                        self._exit_reason = JobExitReason.UNKNOWN_ERROR
                    break
                if self.task_manager.finished():
                    logger.info("All data tasks done; stopping master")
                    self._exit_reason = JobExitReason.SUCCEEDED
                    # workers poll get_tasks on a ~0.5s WAIT cycle: the
                    # server must outlive the completion long enough
                    # for every poller to observe the drained dataset
                    self._broadcast_stop(
                        max(check_interval, _COMPLETION_GRACE)
                    )
                    break
                if self.job_manager.all_running_node_hanged():
                    logger.error("All nodes hang; failing the job")
                    self._exit_code = 1
                    self._exit_reason = JobExitReason.HANG_ERROR
                    self._broadcast_stop(check_interval)
                    break
                if self.transition_coordinator is not None:
                    # abort watchdog: an order still open past the
                    # timeout falls back to restart-the-world
                    self.transition_coordinator.check_abort()
                if self.job_manager.is_job_failed():
                    # critical-node fast-fail (dist_job_manager
                    # mark_job_failed): don't limp at reduced capacity
                    logger.error(
                        "Job failed: %s", self.job_manager.failed_reason
                    )
                    self._exit_code = 1
                    self._exit_reason = JobExitReason.UNKNOWN_ERROR
                    self._broadcast_stop(check_interval)
                    break
                time.sleep(check_interval)
        except KeyboardInterrupt:
            logger.info("Master interrupted")
        finally:
            self.stop()
        self.job_metric_collector.collect_job_exit_reason(
            self._exit_reason
        )
        logger.info(
            "Job exits: code=%d reason=%s", self._exit_code,
            self._exit_reason,
        )
        return self._exit_code

    def _broadcast_stop(self, grace: float):
        """Queue STOP heartbeat actions for live agents and hold the
        servicer open one beat so they can collect them (best effort —
        an agent between heartbeats just sees the channel drop)."""
        try:
            self.job_manager.request_stop_all()
            time.sleep(grace)
        except Exception as e:
            logger.warning("stop broadcast failed: %s", e)

    def _on_rdzv_round(self, name, rdzv_round):
        """Fan a completed rendezvous round out to its consumers (the
        managers' round listener is single-slot)."""
        if self.state_journal is not None:
            self.state_journal.save_rdzv_round(name, rdzv_round)
        if (self.transition_coordinator is not None
                and name == RendezvousName.TRAINING):
            self.transition_coordinator.seal_world()

    def _reshard_fallback(self, order):
        """An online transition aborted: hand the incident to the
        restart-the-world machinery — the shed ranks become
        relaunchable again and come back as fresh incarnations."""
        self.job_manager.handle_reshard_fallback(order.lost)

    def _goodput_summary(self, job=None):
        summary = self.goodput_aggregator.summary(job=job)
        if job is None:
            # gauges stay job-wide: a scoped read must not shrink the
            # exported totals to one job's slice
            goodput_mod.export_metrics(summary)
        return summary

    def stop(self):
        self.auto_scaler.stop()
        self.task_manager.stop()
        self.job_manager.stop()
        # journal the final job account before the server goes away:
        # a post-mortem compares the offline `dump --goodput` replay
        # against this live total
        if not self._goodput_summary_recorded:
            self._goodput_summary_recorded = True
            try:
                summary = self._goodput_summary()
                if summary.get("job", {}).get("procs"):
                    record("goodput.job_summary", **summary["job"])
            except Exception as e:
                logger.warning("goodput summary failed: %s", e)
        goodput_mod.set_job_provider(None)
        self._server.stop(grace=1.0)
        if self.state_journal is not None:
            # drain the group-commit lane: everything staged lands in
            # one final transaction before the process exits
            self.state_journal.close()
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None
