"""Master RPC servicer — the only wire interface to workers.

Parity reference: dlrover/python/master/servicer.py:62 (MasterServicer, ~35
RPCs; create_master_service:478). Transport is the generic RPC envelope
(common/grpc_utils.py); each public ``rpc_*`` method here is one RPC from
the reference service (elastic_training.proto:243-299).

Counterpart of ``dlrover_tpu/master/servicer.py`` with the RPCs of the
launcher: sharding, rendezvous and the KV store, node status,
heartbeats, failures and the global step, the coalesced status report,
sync and barriers, the run config and ping; and those of the one-node
fault drills: the drain's ``report_preemption`` and the sentinel's
``report_anomaly`` (quarantine, one rollback order per incident, the
``DLROVER_TPU_MAX_ROLLBACKS`` budget, the order broadcast under
``sentinel/rollback_order``); and those of the job's accounting: the
goodput aggregator (telemetry/goodput.py) fed by ``report_global_step``,
the status report's goodput section and ``report_goodput``, with the
preemption and rollback windows noted and closed for MTTR, and the job
metric collector (master/stats) fed by the dataset, task, step and
``report_model_info`` / ``report_custom_data`` calls; and the
distributed master's ``request_scale``, through its auto-scaler's
``manual_scale`` (refused without one, as on the local master). Not
ported yet (ROADMAP.md, queue A), each answered with the same "unknown RPC method"
error as an RPC that does not exist: serving (``serve_*``), the relay
batch and fleet digests. ``report_reshard`` carries a mesh transition's
progress to a ``TransitionCoordinator`` (reshard/) when the servicer
was built with one, and answers ``"none"`` without. The JAX master's ingest
plane (event loop, shards, admission and load shedding) is left out
too: ``report_node_status`` runs on the RPC thread against one
:class:`ReporterLedger`.
"""

import json
import os
import threading
import time
from typing import Dict, Optional, Tuple

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import (
    NodeType,
    RendezvousName,
    TaskType,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common.grpc_utils import GenericRpcServer
from dlrover_tpu_torch.master.elastic_training.kv_store_service import (
    KVStoreService,
)
from dlrover_tpu_torch.master.shard.dataset_splitter import new_dataset_splitter
from dlrover_tpu_torch.telemetry import counter, histogram, record, tracing

#: sub-millisecond KV polls up to multi-second shard waits
_RPC_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0,
)


#: per-reporter ledger entries the master retains; at the cap the
#: stalest entry is evicted (resync heals a live one)
LEDGER_CAP = 16384


class ReporterLedger:
    """Per-reporter delta state behind ``report_node_status``:
    ``(node_type, node_id)`` -> ``(incarnation, seq, last_seen_ts)``.

    Bounded at :data:`LEDGER_CAP`: a ``final`` report (process exit)
    evicts its entry at once, and at the cap the stalest incumbent is
    evicted to admit a newcomer. An evicted reporter that is still
    alive finds no baseline on its next delta report and is acked
    ``resync=True``, the path a master restart takes. Thread-safe."""

    def __init__(self, cap: int = LEDGER_CAP):
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, int], Tuple[int, int, float]] = {}
        self._cap = max(2, cap)
        self.evictions = 0

    def observe(self, key: Tuple[str, int], incarnation: int, seq: int,
                full: bool, timestamp: float) -> bool:
        """Fold one report into the ledger; returns ``resync`` — True
        when the reporter is unknown (restart lost the baseline, or it
        was evicted) or switched incarnation without a full report."""
        with self._lock:
            last = self._entries.get(key)
            resync = not full and (
                last is None or last[0] != incarnation
            )
            if last is None and len(self._entries) >= self._cap:
                # liveness must always land: evict the stalest
                # incumbent to admit the newcomer
                stalest = min(
                    self._entries, key=lambda k: self._entries[k][2]
                )
                del self._entries[stalest]
                self.evictions += 1
            self._entries[key] = (incarnation, seq, timestamp)
            return resync

    def evict(self, key: Tuple[str, int]) -> bool:
        """Drop one reporter (its process exited); True if present."""
        with self._lock:
            if self._entries.pop(key, None) is None:
                return False
            self.evictions += 1
            return True


class MasterServicer:
    """Dispatches RPCs to master components."""

    def __init__(
        self,
        task_manager=None,
        job_manager=None,
        speed_monitor=None,
        rdzv_managers=None,
        sync_service=None,
        error_monitor=None,
        kv_store=None,
        job_metric_collector=None,
        goodput_aggregator=None,
        transition_coordinator=None,
        auto_scaler=None,
    ):
        self._task_manager = task_manager
        self._job_manager = job_manager
        self._speed_monitor = speed_monitor
        self._rdzv_managers = rdzv_managers or {}
        self._sync_service = sync_service
        self._error_monitor = error_monitor
        self._kv_store = kv_store or KVStoreService()
        self._job_metric_collector = job_metric_collector
        # job-level goodput accounting (telemetry/goodput.py): fed by
        # the workers' ledger snapshots; the RUNNING report closes the
        # fault window a preemption or rollback opened
        self._goodput = goodput_aggregator
        # reshard-in-place (reshard/coordinator.py); None falls back
        # to restart-the-world for every scale event. The local master
        # builds none, as in JAX; the distributed master builds one
        # when DLROVER_TPU_RESHARD=1
        self._transition_coordinator = transition_coordinator
        # the distributed master's AllreduceTrainingAutoScaler (None on
        # the local master): request_scale retargets the job through it
        self._auto_scaler = auto_scaler
        self._start_training_time = 0.0
        self.run_configs = {}
        # ranks with an announced preemption in flight: their next
        # RUNNING report closes the preemption window
        self._preempted_ranks = set()
        # silent-failure sentinel coordination (sentinel.py): the
        # quarantine manager rides in on the error monitor so one
        # object serves the servicer AND the job manager's relaunch
        # placement
        self._quarantine = getattr(error_monitor, "quarantine", None)
        self._rollback_ranks = set()
        #: the in-flight rollback order, if any: duplicate anomaly
        #: reports ride it instead of burning budget on one incident
        self._active_rollback: Optional[dict] = None
        self._rollback_id = 0
        self._rollbacks_done = 0
        # bounded rollback budget: a job that keeps rolling back is
        # livelocked — convert it into a diagnosed failure
        self._max_rollbacks = int(
            os.environ.get("DLROVER_TPU_MAX_ROLLBACKS", "3")
        )
        # per-reporter delta state behind report_node_status
        self._ledger = ReporterLedger()
        # method -> (requests counter child, latency histogram child):
        # binding the labelled children once keeps the registry walk
        # off the per-RPC dispatch path
        self._method_metrics: Dict[
            str, Tuple[object, object]
        ] = {}
        # the master's own job namespace: reports stamped with it (or
        # "default") drive the primary speed monitor; any OTHER job
        # gets a lazily created monitor of its own, so straggler
        # scoring and step-rate views never mix jobs
        from dlrover_tpu_torch.telemetry.journal import current_job_id

        self._job = current_job_id()
        self._job_monitors_lock = threading.Lock()
        self._job_monitors: Dict[str, object] = {}

    def _running_nodes(self):
        """Deferred node-list snapshot for the stats collector: only
        materialized when its rate limiter actually takes a sample."""
        return (
            self._job_manager.get_running_nodes()
            if self._job_manager else []
        )

    def speed_monitor_for(self, job: str):
        """The speed monitor owning ``job``'s step stream: the primary
        monitor for the master's own job (and the default namespace),
        a per-job one otherwise."""
        if not job or job == "default" or job == self._job:
            return self._speed_monitor
        with self._job_monitors_lock:
            mon = self._job_monitors.get(job)
            if mon is None:
                from dlrover_tpu_torch.master.monitor.speed_monitor import (
                    SpeedMonitor,
                )

                mon = self._job_monitors[job] = SpeedMonitor()
            return mon

    # ------------------------------------------------------------- dispatch

    def _bound_metrics(self, method: str) -> Tuple[object, object]:
        bound = self._method_metrics.get(method)
        if bound is None:
            bound = (
                counter(
                    "dlrover_rpc_requests_total",
                    "RPCs dispatched by the master servicer",
                    ["method"],
                ).labels(method=method),
                histogram(
                    "dlrover_rpc_latency_seconds",
                    "Master-side RPC handling latency", ["method"],
                    buckets=_RPC_BUCKETS,
                ).labels(method=method),
            )
            self._method_metrics[method] = bound
        return bound

    def handle(self, method: str, message):
        fn = getattr(self, f"rpc_{method}", None)
        if fn is None:
            counter(
                "dlrover_rpc_errors_total",
                "RPCs that raised in the servicer", ["method"],
            ).labels(method=method).inc()
            raise ValueError(f"unknown RPC method {method}")
        requests_c, latency_h = self._bound_metrics(method)
        requests_c.inc()
        t0 = time.perf_counter()
        try:
            with tracing.span("rpc." + method):
                return fn(message)
        except Exception:
            counter(
                "dlrover_rpc_errors_total",
                "RPCs that raised in the servicer", ["method"],
            ).labels(method=method).inc()
            raise
        finally:
            latency_h.observe(time.perf_counter() - t0)

    # ------------------------------------------------------------ sharding

    def rpc_report_dataset_shard_params(
        self, req: comm.DatasetShardParams
    ) -> comm.Response:
        splitter = new_dataset_splitter(
            shuffle=req.shuffle,
            shard_size=req.batch_size * req.num_minibatches_per_shard,
            dataset_size=req.dataset_size,
            num_epochs=req.num_epochs,
            dataset_name=req.dataset_name,
            storage_type=req.storage_type,
        )
        self._task_manager.new_dataset(
            batch_size=req.batch_size,
            dataset_size=req.dataset_size,
            dataset_name=req.dataset_name,
            dataset_splitter=splitter,
            task_type=req.task_type or TaskType.TRAINING,
            # raw params, journaled so a RESTARTED master can rebuild
            # the splitter before any worker re-registers
            params={
                "batch_size": req.batch_size,
                "num_epochs": req.num_epochs,
                "dataset_size": req.dataset_size,
                "shuffle": req.shuffle,
                "num_minibatches_per_shard":
                    req.num_minibatches_per_shard,
                "dataset_name": req.dataset_name,
                "task_type": req.task_type or TaskType.TRAINING,
                "storage_type": req.storage_type,
            },
        )
        if self._job_metric_collector and req.task_type == TaskType.TRAINING:
            self._job_metric_collector.collect_dataset_metric(
                req.dataset_name, req.dataset_size
            )
        return comm.Response(success=True)

    def _note_training_started(self):
        if not self._start_training_time:
            self._start_training_time = time.time()
            if self._speed_monitor:
                self._speed_monitor.set_start_timestamp()

    @staticmethod
    def _wire_task(task) -> comm.Task:
        shard = comm.Shard(
            name=task.shard.name,
            start=task.shard.start,
            end=task.shard.end,
            record_indices=task.shard.record_indices,
        )
        return comm.Task(
            task_id=task.task_id, task_type=task.task_type, shard=shard
        )

    def rpc_get_task(self, req: comm.TaskRequest) -> comm.Task:
        self._note_training_started()
        task = self._task_manager.get_dataset_task(
            req.node_type, req.node_id, req.dataset_name,
            incarnation=req.incarnation,
        )
        return self._wire_task(task)

    def rpc_get_tasks(self, req: comm.TaskBatchRequest) -> comm.TaskBatch:
        """Batched dispatch: up to ``max_tasks`` shards per round-trip,
        ledger group-committed before the reply leaves."""
        self._note_training_started()
        tasks = self._task_manager.get_dataset_tasks(
            req.node_type, req.node_id, req.dataset_name,
            max_tasks=req.max_tasks, incarnation=req.incarnation,
        )
        return comm.TaskBatch(tasks=[self._wire_task(t) for t in tasks])

    def rpc_report_task_result(self, req: comm.TaskResult) -> comm.Response:
        success = not req.err_message
        try:
            accepted = self._task_manager.report_dataset_task(
                req.dataset_name, req.task_id, success, req.err_message
            )
        except ValueError as e:
            return comm.Response(success=False, reason=str(e))
        if not accepted:
            # unknown/requeued task (e.g. the watchdog already gave it
            # to someone else): the reporter must NOT count this range
            # as its own completion
            return comm.Response(
                success=False, reason="task not accepted"
            )
        if self._job_metric_collector:
            # shard-fed jobs advance the speed window here, not via
            # report_global_step — sample runtime stats on the same
            # trigger so the resource optimizer sees their throughput
            self._job_metric_collector.collect_runtime_stats(
                self._speed_monitor, self._running_nodes,
            )
        return comm.Response(success=True)

    def rpc_get_shard_checkpoint(
        self, req: comm.ShardCheckpointRequest
    ) -> comm.ShardCheckpoint:
        ckpt = self._task_manager.get_dataset_checkpoint(req.dataset_name)
        return comm.ShardCheckpoint(content=ckpt.to_json() if ckpt else "")

    def rpc_report_shard_checkpoint(
        self, req: comm.ShardCheckpoint
    ) -> comm.Response:
        ok = self._task_manager.restore_dataset_from_checkpoint(req.content)
        return comm.Response(success=ok)

    def rpc_get_dataset_epoch(
        self, req: comm.DatasetEpochRequest
    ) -> comm.DatasetEpoch:
        return comm.DatasetEpoch(
            epoch=self._task_manager.get_dataset_epoch(req.dataset_name)
        )

    # ----------------------------------------------------------- rendezvous

    def rpc_report_rdzv_params(
        self, req: comm.RendezvousParams
    ) -> comm.Response:
        for mgr in self._rdzv_managers.values():
            mgr.update_rdzv_params(
                req.min_nodes, req.max_nodes, req.waiting_timeout,
                req.node_unit, req.joint_timeout,
            )
        return comm.Response(success=True)

    def rpc_join_rendezvous(
        self, req: comm.JoinRendezvousRequest
    ) -> comm.RendezvousRound:
        mgr = self._rdzv_managers.get(
            req.rdzv_name or RendezvousName.TRAINING
        )
        round_ = mgr.join_rendezvous(req.node_id, req.local_world_size)
        return comm.RendezvousRound(round=round_)

    def rpc_get_comm_world(self, req: comm.CommWorldRequest) -> comm.CommWorld:
        mgr = self._rdzv_managers.get(
            req.rdzv_name or RendezvousName.TRAINING
        )
        rdzv_round, group, world = mgr.get_comm_world(req.node_id)
        return comm.CommWorld(
            rdzv_round=rdzv_round, group=group, world=world
        )

    def rpc_num_nodes_waiting(
        self, req: comm.WaitingNodeNumRequest
    ) -> comm.WaitingNodeNum:
        mgr = self._rdzv_managers.get(
            req.rdzv_name or RendezvousName.TRAINING
        )
        return comm.WaitingNodeNum(waiting_num=mgr.num_nodes_waiting())

    def rpc_report_node_check_status(
        self, req: comm.NodeCheckStatus
    ) -> comm.Response:
        mgr = self._rdzv_managers.get(RendezvousName.NETWORK_CHECK)
        if mgr:
            mgr.report_network_check_result(
                req.node_id, req.normal, req.elapsed_time,
                rdzv_round=req.rdzv_round,
            )
        return comm.Response(success=True)

    def rpc_network_check_success(
        self, req: comm.NetworkReadyRequest
    ) -> comm.NetworkCheckResult:
        mgr = self._rdzv_managers.get(RendezvousName.NETWORK_CHECK)
        if not mgr:
            return comm.NetworkCheckResult(success=True)
        success, reason = mgr.network_check_success()
        return comm.NetworkCheckResult(success=success, reason=reason)

    def rpc_get_fault_nodes(self, req: comm.BaseRequest):
        mgr = self._rdzv_managers.get(RendezvousName.NETWORK_CHECK)
        return mgr.get_fault_nodes() if mgr else []

    def rpc_get_straggler_nodes(self, req: comm.BaseRequest):
        mgr = self._rdzv_managers.get(RendezvousName.NETWORK_CHECK)
        return mgr.get_straggler_nodes() if mgr else []

    def rpc_request_scale(self, req: comm.ScaleRequest) -> comm.Response:
        """Operator-requested manual scaling (parity: the ScalePlan
        CRD's manualScaling consumed by the reference master)."""
        if self._auto_scaler is None:
            return comm.Response(
                success=False, reason="no auto scaler (local master?)"
            )
        ok = self._auto_scaler.manual_scale(req.node_num)
        record(
            "scale.request", source="rpc", node_num=req.node_num,
            accepted=bool(ok),
        )
        return comm.Response(success=bool(ok))

    # ------------------------------------------------------------- kv store

    def rpc_kv_store_set(self, req: comm.KVStoreSetRequest) -> comm.Response:
        self._kv_store.set(req.key, req.value)
        return comm.Response(success=True)

    def rpc_kv_store_get(self, req: comm.KVStoreGetRequest) -> comm.KVStoreValue:
        return comm.KVStoreValue(value=self._kv_store.get(req.key))

    def rpc_kv_store_keys(self, req: comm.KVStoreKeysRequest) -> comm.KVStoreKeys:
        return comm.KVStoreKeys(keys=self._kv_store.keys(req.prefix))

    def rpc_kv_store_add(self, req: comm.KVStoreAddRequest) -> comm.KVStoreAddResult:
        return comm.KVStoreAddResult(
            value=self._kv_store.add(req.key, req.amount)
        )

    # ---------------------------------------------------------- node status

    def _rank_of(self, node_type: str, node_id: int) -> int:
        """Rendezvous sets are keyed by node RANK (agents join with
        their rank); a relaunched node has a fresh id but keeps its
        rank."""
        rank = node_id
        if self._job_manager:
            node = self._job_manager.get_node(node_type, node_id)
            if node is not None and node.rank_index is not None:
                rank = node.rank_index
        return rank

    def rpc_update_node_status(
        self, req: comm.NodeStatusRequest
    ) -> comm.Response:
        if self._job_manager:
            self._job_manager.update_node_status(
                req.node_type, req.node_id, req.status, req.exit_reason,
                req.restart_count,
            )
        rank = self._rank_of(req.node_type, req.node_id)
        for mgr in self._rdzv_managers.values():
            if req.status == "succeeded":
                mgr.mark_node_succeeded(rank)
            elif req.status in ("failed", "deleted"):
                mgr.remove_alive_node(rank)
        if req.status == "running" and self._transition_coordinator:
            # RUNNING workers are mesh-transition material: the
            # coordinator's world membership is what a shrink order's
            # survivor list is computed from
            if req.node_type == NodeType.WORKER:
                self._transition_coordinator.note_node_running(rank)
        if req.status == "running" and rank in self._preempted_ranks:
            # the relaunched incarnation is back: the preemption window
            # closes here for MTTR accounting
            self._preempted_ranks.discard(rank)
            if self._goodput is not None:
                self._goodput.mark_recovered("preempt")
            record(
                "preempt.recovered", node_type=req.node_type,
                node_id=req.node_id, rank=rank,
            )
        if req.status == "running" and rank in self._rollback_ranks:
            # the detecting rank restored the last-good step and is
            # training again: the rollback window closes, and a LATER
            # anomaly starts a fresh (budget-counted) rollback
            self._rollback_ranks.discard(rank)
            if not self._rollback_ranks:
                self._active_rollback = None
            if self._goodput is not None:
                self._goodput.mark_recovered("rollback")
            record(
                "rollback.recovered", node_type=req.node_type,
                node_id=req.node_id, rank=rank,
            )
        return comm.Response(success=True)

    def rpc_report_preemption(
        self, req: comm.PreemptionNotice
    ) -> comm.Response:
        """Drain step 1 lands here while the node is still alive: mark
        it PREEMPTED, evict its rank from every rendezvous so the next
        round never waits on a departed peer, and hand the notice to
        the job manager when it schedules budget-free relaunches
        (fault_tolerance/drain.py)."""
        record(
            "preempt.reported", node_type=req.node_type,
            node_id=req.node_id, reason=req.reason,
            notice_budget_s=req.notice_budget_s,
            restart_count=req.restart_count,
        )
        counter(
            "dlrover_preemptions_reported_total",
            "Preemption notices received from draining nodes",
        ).inc()
        rank = self._rank_of(req.node_type, req.node_id)
        self._preempted_ranks.add(rank)
        if self._job_manager:
            handle = getattr(
                self._job_manager, "handle_preemption_notice", None
            )
            if handle is not None:
                handle(req.node_type, req.node_id, req.reason)
        # instant rendezvous eviction: waiting AND alive sets, so a
        # round forming right now re-forms without the departing peer
        for mgr in self._rdzv_managers.values():
            mgr.remove_alive_node(rank)
        if self._goodput is not None:
            self._goodput.note_fault(cause="preempt", node_id=req.node_id)
        return comm.Response(success=True)

    def rpc_report_anomaly(
        self, req: comm.AnomalyReport
    ) -> comm.AnomalyResponse:
        """A sentinel trip (fault_tolerance/sentinel.py): attribute the
        anomaly to its physical host (repeat offenders are
        quarantined), then coordinate a job-wide rollback to the
        reporter's last sentinel-clean checkpoint — or fail the job
        once the rollback budget is exhausted. A job manager without
        ``mark_job_failed`` (the local one) still gets the
        ``job_failed`` answer."""
        record(
            "anomaly.reported", node_type=req.node_type,
            node_id=req.node_id, anomaly=req.kind, step=req.step,
            value=req.value, zscore=req.zscore, host=req.host,
            last_good_step=req.last_good_step,
            restart_count=req.restart_count,
        )
        counter(
            "dlrover_anomalies_reported_total",
            "Anomaly reports received from worker sentinels", ["kind"],
        ).labels(kind=req.kind or "unknown").inc()
        rank = self._rank_of(req.node_type, req.node_id)
        host = req.host or f"node-{req.node_id}"
        quarantined = False
        if self._quarantine is not None:
            quarantined = self._quarantine.note_anomaly(
                host, kind=req.kind, step=req.step
            )
            if quarantined:
                # surgical removal: the host's rank leaves every
                # rendezvous NOW (the next round forms without it) and
                # the job manager stops relaunching onto the host
                for mgr in self._rdzv_managers.values():
                    mgr.remove_alive_node(rank)
                if self._job_manager is not None:
                    handle = getattr(
                        self._job_manager, "handle_quarantine", None
                    )
                    if handle is not None:
                        handle(req.node_type, req.node_id, host)
        if self._active_rollback is not None:
            # one incident, many reporters: every rank that trips on
            # the same corrupted state rides the in-flight order
            self._rollback_ranks.add(rank)
            return comm.AnomalyResponse(
                action="rollback",
                rollback_id=self._active_rollback["id"],
                rollback_step=self._active_rollback["step"],
                quarantined=quarantined,
            )
        if req.last_good_step < 0:
            # no sentinel-clean checkpoint exists yet: nothing to roll
            # back to — the reporter restarts from scratch on its own
            return comm.AnomalyResponse(
                action="none", quarantined=quarantined
            )
        if self._rollbacks_done >= self._max_rollbacks:
            record(
                "rollback.budget_exhausted",
                rollbacks=self._rollbacks_done,
                budget=self._max_rollbacks, anomaly=req.kind,
                node_id=req.node_id, host=host,
            )
            mark_failed = getattr(self._job_manager, "mark_job_failed",
                                  None)
            if mark_failed is not None:
                mark_failed(
                    f"rollback budget exhausted "
                    f"({self._rollbacks_done}/{self._max_rollbacks}): "
                    f"recurring {req.kind} anomaly"
                )
            return comm.AnomalyResponse(
                action="job_failed", quarantined=quarantined
            )
        self._rollbacks_done += 1
        self._rollback_id += 1
        order = {
            "id": self._rollback_id, "step": int(req.last_good_step),
            # chains every rank's adoption under the initiating
            # report_anomaly RPC span
            "trace": tracing.traceparent() or "",
        }
        self._active_rollback = order
        self._rollback_ranks.add(rank)
        # KV broadcast: ranks that did NOT trip learn the order from
        # their sentinel's step-cadence poll and converge on the same
        # restore step
        self._kv_store.set(
            "sentinel/rollback_order", json.dumps(order).encode()
        )
        record(
            "rollback.initiated", rollback_id=order["id"],
            step=order["step"], anomaly=req.kind, node_id=req.node_id,
            host=host, rollbacks=self._rollbacks_done,
            budget=self._max_rollbacks,
        )
        counter(
            "dlrover_rollbacks_initiated_total",
            "Coordinated last-good rollbacks ordered by the master",
        ).inc()
        if self._goodput is not None:
            self._goodput.note_fault(
                cause="rollback", node_id=req.node_id
            )
        return comm.AnomalyResponse(
            action="rollback", rollback_id=order["id"],
            rollback_step=order["step"], quarantined=quarantined,
        )

    def rpc_relinquish_shards(
        self, req: comm.RelinquishShardsRequest
    ) -> comm.RelinquishShardsResponse:
        """Drain step 3: requeue the draining node's in-flight shards
        immediately (group-committed) instead of waiting out the
        task-timeout watchdog."""
        requeued = 0
        if self._task_manager is not None:
            requeued = self._task_manager.relinquish_tasks(
                req.node_type, req.node_id, dataset_name=req.dataset_name
            )
        record(
            "preempt.relinquished", node_type=req.node_type,
            node_id=req.node_id, requeued=requeued,
        )
        return comm.RelinquishShardsResponse(requeued=requeued)

    def rpc_report_reshard(
        self, req: comm.ReshardReport
    ) -> comm.ReshardResponse:
        """Mesh-transition progress (reshard/): a survivor reports how
        far it got executing the active TransitionOrder. The
        coordinator completes the transition once every survivor says
        ``completed``, or aborts it on the first ``aborted``."""
        if self._transition_coordinator is None:
            return comm.ReshardResponse(action="none")
        rank = self._rank_of(req.node_type, req.node_id)
        action = self._transition_coordinator.note_worker_phase(
            rank, req.order_id, req.phase
        )
        return comm.ReshardResponse(action=action)

    def rpc_update_node_address(
        self, req: comm.NodeAddressRequest
    ) -> comm.Response:
        if self._job_manager:
            self._job_manager.update_node_service_addr(
                req.node_type, req.node_id, req.address
            )
        return comm.Response(success=True)

    def rpc_report_heartbeat(self, req: comm.HeartBeat) -> comm.HeartbeatResponse:
        action = ""
        if self._job_manager:
            action = self._job_manager.collect_node_heartbeat(
                req.node_type, req.node_id, req.timestamp
            ) or ""
        return comm.HeartbeatResponse(action=action)

    def rpc_report_failure(self, req: comm.NodeFailure) -> comm.Response:
        record(
            "fault.reported", node_type=req.node_type,
            node_id=req.node_id, level=req.level,
            restart_count=req.restart_count,
            error=str(req.error_data)[:200],
        )
        node = None
        if self._job_manager:
            node = self._job_manager.get_node(req.node_type, req.node_id)
        if self._error_monitor:
            self._error_monitor.process_error(
                node or req.node_id, req.restart_count, req.error_data,
                req.level,
            )
        if (
            req.level == TrainingExceptionLevel.HANG
            and self._job_manager is not None
        ):
            self._job_manager.handle_training_hang(
                req.node_type, req.node_id, req.error_data
            )
        return comm.Response(success=True)

    def rpc_report_used_resource(self, req: comm.ResourceStats) -> comm.Response:
        if self._job_manager:
            self._job_manager.update_node_resource_usage(
                req.node_type, req.node_id, req.cpu_percent, req.memory_mb,
                req.tpu_stats,
            )
        return comm.Response(success=True)

    def rpc_query_running_nodes(
        self, req: comm.RunningNodesRequest
    ) -> comm.RunningNodes:
        nodes = []
        if self._job_manager:
            for node in self._job_manager.get_all_nodes():
                nodes.append(node.to_dict())
        return comm.RunningNodes(nodes=nodes)

    # -------------------------------------------------------------- metrics

    def rpc_report_global_step(self, req: comm.GlobalStep) -> comm.Response:
        if self._speed_monitor:
            # node_id attributes the report to its host so the speed
            # monitor can score per-host step cadence (stragglers)
            self._speed_monitor.collect_global_step(
                req.step, req.timestamp, node_id=req.node_id
            )
        if self._job_metric_collector:
            self._job_metric_collector.collect_runtime_stats(
                self._speed_monitor, self._running_nodes,
            )
        if self._goodput is not None and req.goodput_phases:
            self._goodput.observe_report(
                node_id=req.node_id, pid=req.pid,
                start_ts=req.goodput_start_ts,
                elapsed_s=req.goodput_elapsed_s,
                phases=req.goodput_phases,
                phase=req.goodput_phase,
            )
        return comm.Response(success=True)

    def rpc_report_goodput(self, req: comm.GoodputReport) -> comm.Response:
        """A full ledger snapshot off the step cadence (process exit
        sends final=True, closing the incarnation in the aggregator)."""
        if self._goodput is not None and req.goodput_phases:
            self._goodput.observe_report(
                node_id=req.node_id, pid=req.pid,
                start_ts=req.goodput_start_ts,
                elapsed_s=req.goodput_elapsed_s,
                phases=req.goodput_phases,
                phase=req.goodput_phase,
                host=req.host, final=req.final,
            )
        return comm.Response(success=True)

    def rpc_report_node_status(
        self, req: comm.NodeStatusReport
    ) -> comm.NodeStatusAck:
        """The coalesced fan-in path: one rpc per agent per
        interval carrying heartbeat + whatever changed since the last
        ack (step, goodput, resource), with the pending action piggy-
        backed on the ack. The ledger update and the section
        application happen, in that order, before the ack is
        composed."""
        key = (req.node_type, req.node_id)
        resync = self._ledger.observe(
            key, req.incarnation, req.seq, req.full, req.timestamp
        )
        action = self._apply_status_sections(req)
        if req.final:
            # process exit closes the incarnation: its baseline can
            # never be consulted again — drop it now, not at the cap
            self._ledger.evict(key)
        return comm.NodeStatusAck(
            accepted=True, action=action, resync=resync,
            acked_seq=req.seq,
        )

    def _apply_status_sections(self, req: comm.NodeStatusReport) -> str:
        """Fan one report's sections out to the shared consumers;
        returns the piggy-backed action."""
        action = ""
        job = req.job_id or "default"
        if self._job_manager:
            action = self._job_manager.collect_node_heartbeat(
                req.node_type, req.node_id, req.timestamp
            ) or ""
        if req.has_step and self._speed_monitor:
            monitor = self.speed_monitor_for(job)
            monitor.collect_global_step(
                req.step, req.step_ts or req.timestamp,
                node_id=req.node_id,
            )
            if self._job_metric_collector \
                    and monitor is self._speed_monitor:
                self._job_metric_collector.collect_runtime_stats(
                    self._speed_monitor, self._running_nodes,
                )
        if req.has_goodput and self._goodput is not None \
                and req.goodput_phases:
            self._goodput.observe_report(
                node_id=req.node_id, pid=req.pid,
                start_ts=req.goodput_start_ts,
                elapsed_s=req.goodput_elapsed_s,
                phases=req.goodput_phases,
                phase=req.goodput_phase,
                host=req.host, final=req.final,
                job=job,
            )
        if req.has_resource and self._job_manager:
            self._job_manager.update_node_resource_usage(
                req.node_type, req.node_id, req.cpu_percent,
                req.memory_mb, [],
            )
        return action

    def rpc_report_model_info(self, req: comm.ModelInfo) -> comm.Response:
        if self._job_metric_collector:
            self._job_metric_collector.collect_model_metric(req)
        return comm.Response(success=True)

    def rpc_report_custom_data(self, req: comm.CustomData) -> comm.Response:
        """Evaluator results / user counters into the stats pipeline
        (parity: report_customized_data RPC). The dict is ONE row —
        splitting it per key would detach eval metrics from their
        step."""
        if self._job_metric_collector and req.data:
            self._job_metric_collector.collect_custom_metrics(req.data)
        return comm.Response(success=True)

    # ----------------------------------------------------------------- sync

    def rpc_join_sync(self, req: comm.SyncJoin) -> comm.Response:
        ok = self._sync_service.join_sync(
            req.sync_name, req.node_type, req.node_id
        )
        return comm.Response(success=ok)

    def rpc_sync_finished(self, req: comm.SyncFinish) -> comm.Response:
        return comm.Response(
            success=self._sync_service.sync_finished(req.sync_name)
        )

    def rpc_barrier(self, req: comm.SyncBarrier) -> comm.Response:
        if req.notify:
            return comm.Response(
                success=self._sync_service.notify_barrier(req.barrier_name)
            )
        return comm.Response(
            success=self._sync_service.barrier(req.barrier_name)
        )

    # ---------------------------------------------------------------- misc

    def rpc_get_elastic_run_config(
        self, req: comm.ElasticRunConfigRequest
    ) -> comm.ElasticRunConfig:
        return comm.ElasticRunConfig(configs=dict(self.run_configs))

    def rpc_ping(self, req) -> comm.Response:
        return comm.Response(success=True)


def create_master_service(
    port: int,
    task_manager=None,
    job_manager=None,
    speed_monitor=None,
    rdzv_managers=None,
    sync_service=None,
    error_monitor=None,
    kv_store=None,
    job_metric_collector=None,
    goodput_aggregator=None,
    transition_coordinator=None,
    auto_scaler=None,
):
    """Build the RPC server around a MasterServicer
    (parity: servicer.py:478)."""
    servicer = MasterServicer(
        task_manager=task_manager,
        job_manager=job_manager,
        speed_monitor=speed_monitor,
        rdzv_managers=rdzv_managers,
        sync_service=sync_service,
        error_monitor=error_monitor,
        kv_store=kv_store,
        job_metric_collector=job_metric_collector,
        goodput_aggregator=goodput_aggregator,
        transition_coordinator=transition_coordinator,
        auto_scaler=auto_scaler,
    )
    server = GenericRpcServer(servicer.handle, port=port)
    return server, servicer
