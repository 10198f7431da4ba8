"""Agent-side client for every master RPC, behind reconnect supervision.

Counterpart of ``dlrover_tpu/agent/master_client.py`` (parity reference:
dlrover/python/elastic_agent/master_client.py:51, MasterClient,
build_master_client:466). :class:`MasterClient` speaks the generic RPC
of common/grpc_utils.py; :class:`LocalMasterClient` serves the sharding
protocol in process when no master address is configured.

Every public RPC of :class:`MasterClient` runs under a
:class:`ConnectionSupervisor`:

* errors are CLASSIFIED — only connection-level failures (a refused or
  reset connection, a timeout) enter the reconnect loop; application
  errors (``common.grpc_utils.RpcError``)
  surface to the caller immediately;
* reconnects back off with decorrelated jitter up to a hard deadline
  (``DLROVER_TPU_MASTER_RECONNECT_TIMEOUT``, default 600 s — generous
  enough to cover a master pod reschedule);
* recovery is probed with a raw ping, then registered re-hello hooks
  run BEFORE the original call retries (re-register the node,
  re-report dataset params) so the restarted master has the context
  the retried RPC assumes;
* the outage is observable: ``agent.master_lost`` /
  ``agent.master_reconnected`` journal events and a reconnect-attempts
  counter.

``report_global_step`` carries this process's goodput ledger
(telemetry/goodput.py) when one is armed, and ``report_goodput`` sends
it off the step cadence (``final=True`` at a drain's end).
``report_reshard`` carries a mesh transition's progress
(reshard/transition.py). Not ported yet (ROADMAP.md, queue A): the
relay tier's failover, the fleet observation of RPC latency, and the
serving calls.
"""

import functools
import os
import random
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import (
    NodeEnv,
    RendezvousName,
    TaskType,
)
from dlrover_tpu_torch.common.grpc_utils import GenericRpcClient
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.shard.dataset_splitter import (
    new_dataset_splitter,
)
from dlrover_tpu_torch.master.shard.task_manager import TaskManager
from dlrover_tpu_torch.telemetry import counter, goodput, record, tracing

#: hard reconnect deadline (seconds) — how long a worker rides out a
#: master outage before giving up. Default covers a pod reschedule plus
#: image pull with room to spare.
ENV_RECONNECT_TIMEOUT = "DLROVER_TPU_MASTER_RECONNECT_TIMEOUT"
DEFAULT_RECONNECT_TIMEOUT = 600.0

#: decorrelated-jitter backoff bounds for the reconnect probe loop
ENV_BACKOFF_CAP = "DLROVER_TPU_MASTER_RECONNECT_BACKOFF_MAX"
BACKOFF_BASE = 0.25
DEFAULT_BACKOFF_CAP = 15.0

#: public MasterClient methods deliberately NOT supervised: ``ping`` IS
#: the supervisor's liveness probe and its contract is an immediate
#: True/False — blocking it for the reconnect deadline would deadlock
#: the probe and stall every caller that just wants a health answer.
UNSUPERVISED_RPCS = ("ping",)


class MasterLostError(ConnectionError):
    """The master stayed unreachable past the reconnect deadline."""


def is_connection_error(exc: BaseException) -> bool:
    """Connection-level (reconnect-worthy) vs application error.

    The generic RPC server answers INVALID_ARGUMENT on wire errors and
    a handler's ``ValueError``, INTERNAL on other handler exceptions
    (common/grpc_utils.py): those arrive as ``RpcError`` — the remote
    code talking — and must surface immediately. A dead or
    rescheduling master shows as a refused or reset connection, a
    connection closed mid-call, or a timeout: all ``OSError``."""
    return isinstance(exc, OSError)


class ConnectionSupervisor:
    """Shared reconnect state machine for one MasterClient.

    Any number of threads (heartbeat, shard prefetch, rendezvous
    polling) may hit the outage concurrently; the first records
    ``agent.master_lost``, exactly one at a time probes the master, and
    the winning probe runs the re-hello hooks once before any supervised
    call retries."""

    def __init__(self, client: GenericRpcClient, node_desc: str = "",
                 reconnect_timeout: Optional[float] = None):
        self._client = client
        self._node_desc = node_desc
        if reconnect_timeout is None:
            reconnect_timeout = float(
                os.getenv(ENV_RECONNECT_TIMEOUT, "")
                or DEFAULT_RECONNECT_TIMEOUT
            )
        self.reconnect_timeout = reconnect_timeout
        self._backoff_cap = float(
            os.getenv(ENV_BACKOFF_CAP, "") or DEFAULT_BACKOFF_CAP
        )
        self._hooks: Dict[str, Callable[[], None]] = {}
        self._state_lock = threading.Lock()
        self._connected = True
        self._lost_at = 0.0
        self._local = threading.local()

    # ------------------------------------------------------------- hooks

    def add_hook(self, name: str, fn: Callable[[], None]):
        """Register an idempotent re-hello, run (in registration order)
        after every reconnect BEFORE supervised calls retry. Hooks may
        freely call supervised RPCs — supervision is bypassed inside."""
        with self._state_lock:
            self._hooks[name] = fn

    def remove_hook(self, name: str):
        with self._state_lock:
            self._hooks.pop(name, None)

    # -------------------------------------------------------------- core

    def call(self, method: str, fn: Callable):
        if getattr(self._local, "bypass", False):
            return fn()
        deadline = None
        sleep = BACKOFF_BASE
        attempts = 0
        first_error: Optional[BaseException] = None
        while True:
            try:
                return fn()
            except Exception as e:
                if not is_connection_error(e):
                    raise
                now = time.monotonic()
                if deadline is None:
                    deadline = now + self.reconnect_timeout
                    first_error = e
                    self._note_lost(method, e)
                # probe-and-backoff until reconnected or out of time;
                # fn() only retries AFTER a successful probe ran the
                # re-hello hooks (the retried call may assume them)
                while True:
                    if time.monotonic() >= deadline:
                        raise MasterLostError(
                            f"master unreachable for "
                            f"{self.reconnect_timeout:.0f}s "
                            f"({attempts} reconnect attempts) during "
                            f"RPC {method}"
                        ) from first_error
                    attempts += 1
                    counter(
                        "dlrover_agent_master_reconnect_attempts_total",
                        "Reconnect probes sent while the master was "
                        "unreachable",
                    ).inc()
                    # decorrelated jitter: spreads a whole fleet's
                    # probes instead of synchronized thundering herds
                    sleep = min(
                        self._backoff_cap,
                        random.uniform(BACKOFF_BASE, sleep * 3),
                    )
                    time.sleep(
                        max(0.02, min(sleep,
                                      deadline - time.monotonic()))
                    )
                    if self._try_reconnect():
                        break

    def _raw_ping(self) -> bool:
        try:
            res = self._client.call("ping", comm.BaseRequest())
            return bool(getattr(res, "success", True))
        except Exception:
            return False

    def _note_lost(self, method: str, exc: BaseException):
        with self._state_lock:
            if not self._connected:
                return
            self._connected = False
            self._lost_at = time.time()
        logger.warning(
            "Master connection lost during RPC %s: %s — entering "
            "reconnect supervision (deadline %.0fs)",
            method, exc, self.reconnect_timeout,
        )
        record(
            "agent.master_lost", method=method, error=str(exc)[:200],
            node=self._node_desc,
        )

    def _try_reconnect(self) -> bool:
        """Probe the master; on success run re-hello hooks and flip back
        to connected. Serialized: concurrent stranded threads wait on
        the lock and see _connected already True."""
        with self._state_lock:
            if self._connected:
                return True
            if not self._raw_ping():
                return False
            self._local.bypass = True
            try:
                for name, hook in list(self._hooks.items()):
                    try:
                        hook()
                    except Exception as e:
                        logger.warning(
                            "re-hello hook %s failed after "
                            "reconnect: %s", name, e,
                        )
            finally:
                self._local.bypass = False
            outage = time.time() - self._lost_at
            self._connected = True
        logger.info(
            "Master reconnected after %.1fs outage; re-hello hooks "
            "done", outage,
        )
        record(
            "agent.master_reconnected",
            outage_seconds=round(outage, 3), node=self._node_desc,
        )
        return True


def supervised_rpc(func):
    """Route a MasterClient RPC method through its ConnectionSupervisor
    (classification + reconnect + re-hello; see module docstring)."""

    @functools.wraps(func)
    def wrapped(self, *args, **kwargs):
        return self._supervisor.call(
            func.__name__, lambda: func(self, *args, **kwargs)
        )

    wrapped._supervised_rpc = True
    return wrapped


class MasterClient:
    """One client instance per agent/worker process."""

    def __init__(self, master_addr: str, node_id: int, node_type: str,
                 timeout: float = 30.0,
                 reconnect_timeout: Optional[float] = None):
        self._client = GenericRpcClient(master_addr, timeout=timeout)
        self._node_id = node_id
        self._node_type = node_type
        self.master_addr = master_addr
        self._supervisor = ConnectionSupervisor(
            self._client,
            node_desc=f"{node_type}-{node_id}",
            reconnect_timeout=reconnect_timeout,
        )

    def add_reconnect_hook(self, name: str, fn: Callable[[], None]):
        """Register an idempotent re-hello run after every reconnect
        (e.g. re-register this node, re-report dataset params)."""
        self._supervisor.add_hook(name, fn)

    def remove_reconnect_hook(self, name: str):
        self._supervisor.remove_hook(name)

    def _call(self, method: str, message):
        return self._client.call(method, message)

    def _fill(self, req: comm.BaseRequest):
        req.node_id = self._node_id
        req.node_type = self._node_type
        return req

    # ------------------------------------------------------------ sharding

    @supervised_rpc
    def report_dataset_shard_params(
        self, batch_size: int, num_epochs: int, dataset_size: int,
        shuffle: bool, num_minibatches_per_shard: int, dataset_name: str,
        task_type: str = TaskType.TRAINING, storage_type: str = "table",
    ):
        req = self._fill(comm.DatasetShardParams(
            batch_size=batch_size, num_epochs=num_epochs,
            dataset_size=dataset_size, shuffle=shuffle,
            num_minibatches_per_shard=num_minibatches_per_shard,
            dataset_name=dataset_name, task_type=task_type,
            storage_type=storage_type,
        ))
        return self._call("report_dataset_shard_params", req)

    @supervised_rpc
    def get_task(self, dataset_name: str,
                 incarnation: int = -1) -> comm.Task:
        req = self._fill(comm.TaskRequest(
            dataset_name=dataset_name, incarnation=incarnation,
        ))
        return self._call("get_task", req)

    @supervised_rpc
    def get_tasks(self, dataset_name: str, max_tasks: int = 1,
                  incarnation: int = -1) -> List[comm.Task]:
        """Batched dispatch: up to ``max_tasks`` shards in one
        round-trip. A master that predates this RPC rejects the unknown
        message type/method with an application error (not a connection
        error) — callers catch that and fall back to :meth:`get_task`."""
        req = self._fill(comm.TaskBatchRequest(
            dataset_name=dataset_name, incarnation=incarnation,
            max_tasks=max_tasks,
        ))
        return self._call("get_tasks", req).tasks

    @supervised_rpc
    def report_task_result(self, dataset_name: str, task_id: int,
                           err_message: str = ""):
        req = self._fill(comm.TaskResult(
            dataset_name=dataset_name, task_id=task_id,
            err_message=err_message,
        ))
        return self._call("report_task_result", req)

    @supervised_rpc
    def get_shard_checkpoint(self, dataset_name: str) -> str:
        req = self._fill(
            comm.ShardCheckpointRequest(dataset_name=dataset_name)
        )
        res = self._call("get_shard_checkpoint", req)
        return res.content

    @supervised_rpc
    def report_shard_checkpoint(self, content: str):
        return self._call(
            "report_shard_checkpoint", comm.ShardCheckpoint(content=content)
        )

    @supervised_rpc
    def get_dataset_epoch(self, dataset_name: str) -> int:
        req = self._fill(comm.DatasetEpochRequest(dataset_name=dataset_name))
        return self._call("get_dataset_epoch", req).epoch

    # ---------------------------------------------------------- rendezvous

    @supervised_rpc
    def report_rdzv_params(self, min_nodes: int, max_nodes: int,
                           waiting_timeout: float, node_unit: int,
                           join_timeout: float = 600.0):
        req = self._fill(comm.RendezvousParams(
            min_nodes=min_nodes, max_nodes=max_nodes,
            waiting_timeout=waiting_timeout, node_unit=node_unit,
            joint_timeout=join_timeout,
        ))
        return self._call("report_rdzv_params", req)

    @supervised_rpc
    def join_rendezvous(self, node_rank: int, local_world_size: int,
                        rdzv_name: str = RendezvousName.TRAINING) -> int:
        req = comm.JoinRendezvousRequest(
            node_id=node_rank, node_type=self._node_type,
            local_world_size=local_world_size, rdzv_name=rdzv_name,
        )
        return self._call("join_rendezvous", req).round

    @supervised_rpc
    def get_comm_world(
        self, rdzv_name: str, node_rank: int
    ):
        req = comm.CommWorldRequest(
            node_id=node_rank, rdzv_name=rdzv_name
        )
        res = self._call("get_comm_world", req)
        return res.rdzv_round, res.group, res.world

    @supervised_rpc
    def num_nodes_waiting(
        self, rdzv_name: str = RendezvousName.TRAINING
    ) -> int:
        req = self._fill(comm.WaitingNodeNumRequest(rdzv_name=rdzv_name))
        try:
            return self._call("num_nodes_waiting", req).waiting_num
        except Exception as e:
            # connection loss must reach the supervisor (it owns the
            # reconnect loop); only APP errors degrade to "0 waiting"
            if is_connection_error(e):
                raise
            logger.warning("num_nodes_waiting failed: %s", e)
            return 0

    @supervised_rpc
    def report_node_check_status(self, rdzv_round: int, normal: bool,
                                 elapsed_time: float):
        req = self._fill(comm.NodeCheckStatus(
            rdzv_round=rdzv_round, normal=normal, elapsed_time=elapsed_time,
        ))
        return self._call("report_node_check_status", req)

    @supervised_rpc
    def network_check_success(self):
        req = self._fill(comm.NetworkReadyRequest())
        res = self._call("network_check_success", req)
        return res.success, res.reason

    @supervised_rpc
    def get_fault_nodes(self) -> List[int]:
        return self._call("get_fault_nodes", self._fill(comm.BaseRequest()))

    @supervised_rpc
    def get_straggler_nodes(self) -> List[int]:
        return self._call(
            "get_straggler_nodes", self._fill(comm.BaseRequest())
        )

    # ------------------------------------------------------------- kv store

    @supervised_rpc
    def kv_store_set(self, key: str, value: bytes):
        return self._call(
            "kv_store_set", comm.KVStoreSetRequest(key=key, value=value)
        )

    @supervised_rpc
    def kv_store_get(self, key: str) -> bytes:
        return self._call(
            "kv_store_get", comm.KVStoreGetRequest(key=key)
        ).value

    @supervised_rpc
    def kv_store_keys(self, prefix: str = ""):
        return self._call(
            "kv_store_keys", comm.KVStoreKeysRequest(prefix=prefix)
        ).keys

    @supervised_rpc
    def kv_store_add(self, key: str, amount: int) -> int:
        return self._call(
            "kv_store_add", comm.KVStoreAddRequest(key=key, amount=amount)
        ).value

    # ---------------------------------------------------------- node status

    @supervised_rpc
    def update_node_status(self, status: str, exit_reason: str = "",
                           restart_count: int = 0):
        req = self._fill(comm.NodeStatusRequest(
            status=status, exit_reason=exit_reason,
            restart_count=restart_count,
        ))
        return self._call("update_node_status", req)

    @supervised_rpc
    def update_node_address(self, address: str):
        req = self._fill(comm.NodeAddressRequest(address=address))
        return self._call("update_node_address", req)

    @supervised_rpc
    def report_heartbeat(self) -> str:
        req = self._fill(comm.HeartBeat(timestamp=time.time()))
        return self._call("report_heartbeat", req).action

    @supervised_rpc
    def report_node_status(self, report: comm.NodeStatusReport):
        """The coalesced fan-in rpc (agent/status_reporter.py builds
        the delta payload): heartbeat + changed sections in one call.
        Returns the :class:`~dlrover_tpu_torch.common.comm.NodeStatusAck`."""
        return self._call("report_node_status", self._fill(report))

    @supervised_rpc
    def report_failure(self, error_data: str, level: str,
                       restart_count: int = 0):
        req = self._fill(comm.NodeFailure(
            error_data=error_data, level=level, restart_count=restart_count,
        ))
        try:
            return self._call("report_failure", req)
        except Exception as e:
            if is_connection_error(e):
                raise
            logger.warning("report_failure failed: %s", e)

    @supervised_rpc
    def relinquish_shards(self, dataset_name: str = "") -> int:
        """Drain step 3: return this node's in-flight shards to the
        todo queue immediately (empty name = every dataset). Returns
        the number requeued."""
        req = self._fill(
            comm.RelinquishShardsRequest(dataset_name=dataset_name)
        )
        return int(self._call("relinquish_shards", req).requeued)

    @supervised_rpc
    def report_preemption(self, reason: str = "",
                          notice_budget_s: float = 0.0,
                          deadline_ts: float = 0.0,
                          restart_count: int = 0):
        """Drain step 1 (fault_tolerance/drain.py): announce the
        reclaim notice so the master marks this node PREEMPTED, evicts
        it from rendezvous. The master ships with this client, so an
        error reaches the caller (the drain records it)."""
        req = self._fill(comm.PreemptionNotice(
            reason=reason, notice_budget_s=notice_budget_s,
            deadline_ts=deadline_ts, restart_count=restart_count,
        ))
        return self._call("report_preemption", req)

    @supervised_rpc
    def report_anomaly(self, kind: str, step: int, value: float = 0.0,
                       zscore: float = 0.0, host: str = "",
                       last_good_step: int = -1,
                       restart_count: int = 0):
        """Sentinel trip (fault_tolerance/sentinel.py): report a
        silent-corruption signal and receive the master's verdict — a
        coordinated rollback order, "none" (no clean checkpoint yet),
        or "job_failed" once the rollback budget is spent. An error
        reaches the caller: a failing master is never a silent "no
        order"."""
        req = self._fill(comm.AnomalyReport(
            kind=kind, step=step, value=value, zscore=zscore,
            host=host or socket.gethostname(),
            last_good_step=last_good_step, restart_count=restart_count,
        ))
        return self._call("report_anomaly", req)

    @supervised_rpc
    def report_reshard(self, order_id: int, phase: str,
                       detail: str = ""):
        """Mesh-transition progress (reshard/transition.py): this
        survivor reached ``phase`` of transition order ``order_id``.
        The coordinator answers ok/stale/abort. A master predating the
        RPC rejects the unknown message with an application error —
        the worker then treats the transition as unsupervised and
        falls back to restart-the-world (None return)."""
        req = self._fill(comm.ReshardReport(
            order_id=order_id, phase=phase, detail=detail,
        ))
        try:
            return self._call("report_reshard", req)
        except Exception as e:
            if is_connection_error(e):
                raise
            logger.warning("report_reshard unsupported: %s", e)
            record("anomaly.rpc_fallback", rpc="report_reshard",
                   error=str(e)[:200])
            return None

    @supervised_rpc
    def report_used_resource(self, cpu_percent: float, memory_mb: int,
                             tpu_stats: Optional[List[Dict]] = None):
        req = self._fill(comm.ResourceStats(
            cpu_percent=cpu_percent, memory_mb=memory_mb,
            tpu_stats=tpu_stats or [],
        ))
        return self._call("report_used_resource", req)

    @supervised_rpc
    def query_running_nodes(self) -> List[Dict]:
        req = self._fill(comm.RunningNodesRequest())
        return self._call("query_running_nodes", req).nodes

    @supervised_rpc
    def request_scale(self, node_num: int) -> bool:
        """Operator-requested manual scaling (parity: manualScaling)."""
        req = self._fill(comm.ScaleRequest(node_num=node_num))
        resp = self._call("request_scale", req)
        return bool(getattr(resp, "success", False))

    # -------------------------------------------------------------- metrics

    @supervised_rpc
    def report_global_step(self, step: int,
                           timestamp: Optional[float] = None):
        # piggyback the goodput ledger when this process armed one
        # (telemetry/goodput.py) — empty fields otherwise, so the wire
        # message is unchanged for ledger-less processes
        req = self._fill(comm.GlobalStep(
            timestamp=timestamp or time.time(), step=step,
            pid=os.getpid(), **goodput.report_fields(),
        ))
        return self._call("report_global_step", req)

    @supervised_rpc
    def report_goodput(self, final: bool = False):
        """Push the full ledger snapshot outside the step cadence
        (once with ``final=True`` at a drain's end so the master closes
        the incarnation). No-op without an armed ledger."""
        fields = goodput.report_fields()
        if not fields:
            return None
        req = self._fill(comm.GoodputReport(
            pid=os.getpid(), host=socket.gethostname(),
            final=final, **fields,
        ))
        return self._call("report_goodput", req)

    @supervised_rpc
    def report_custom_data(self, data: Dict):
        """Free-form metrics into the stats pipeline (evaluator
        results; parity: report_customized_data)."""
        req = self._fill(comm.CustomData(data=dict(data)))
        return self._call("report_custom_data", req)

    @supervised_rpc
    def report_model_info(self, param_count: int, flops_per_step: float,
                          batch_size: int, seq_len: int = 0,
                          extra: Optional[Dict] = None):
        req = self._fill(comm.ModelInfo(
            param_count=param_count, flops_per_step=flops_per_step,
            batch_size=batch_size, seq_len=seq_len, extra=extra or {},
        ))
        return self._call("report_model_info", req)

    # ----------------------------------------------------------------- sync

    @supervised_rpc
    def join_sync(self, sync_name: str) -> bool:
        req = self._fill(comm.SyncJoin(sync_name=sync_name))
        return self._call("join_sync", req).success

    @supervised_rpc
    def sync_finished(self, sync_name: str) -> bool:
        req = self._fill(comm.SyncFinish(sync_name=sync_name))
        return self._call("sync_finished", req).success

    @supervised_rpc
    def barrier(self, barrier_name: str, notify: bool = False) -> bool:
        req = self._fill(comm.SyncBarrier(
            barrier_name=barrier_name, notify=notify,
        ))
        return self._call("barrier", req).success

    @supervised_rpc
    def get_elastic_run_config(self) -> Dict[str, str]:
        req = self._fill(comm.ElasticRunConfigRequest())
        return self._call("get_elastic_run_config", req).configs

    def ping(self) -> bool:
        try:
            return self._call("ping", comm.BaseRequest()).success
        except Exception:
            return False

    def close(self):
        self._client.close()



def _as_comm_task(task) -> comm.Task:
    return comm.Task(
        task_id=task.task_id, task_type=task.task_type,
        shard=comm.Shard(
            name=task.shard.name, start=task.shard.start,
            end=task.shard.end, record_indices=task.shard.record_indices,
        ),
    )


class LocalMasterClient:
    """Masterless client serving the sharding protocol in process
    (parity: ``LocalMasterClient`` of ``dlrover_tpu/agent/master_client.py``)."""

    def __init__(self, node_id: int = 0, node_type: str = "worker"):
        self._node_id = node_id
        self._node_type = node_type
        self._task_manager = TaskManager()
        self._kv: Dict[str, bytes] = {}

    def report_dataset_shard_params(self, batch_size, num_epochs,
                                    dataset_size, shuffle,
                                    num_minibatches_per_shard, dataset_name,
                                    task_type=TaskType.TRAINING,
                                    storage_type="table"):
        splitter = new_dataset_splitter(
            shuffle=shuffle,
            shard_size=batch_size * num_minibatches_per_shard,
            dataset_size=dataset_size, num_epochs=num_epochs,
            dataset_name=dataset_name, storage_type=storage_type,
        )
        self._task_manager.new_dataset(
            batch_size, dataset_size, dataset_name, splitter, task_type
        )

    # the rpc.* spans mirror the remote servicer's, so a trace reads the
    # same whether the master is local or remote
    def get_task(self, dataset_name: str,
                 incarnation: int = -1) -> comm.Task:
        with tracing.span("rpc.get_task"):
            task = self._task_manager.get_dataset_task(
                self._node_type, self._node_id, dataset_name,
                incarnation=incarnation,
            )
        return _as_comm_task(task)

    def get_tasks(self, dataset_name: str, max_tasks: int = 1,
                  incarnation: int = -1) -> List[comm.Task]:
        with tracing.span("rpc.get_tasks"):
            tasks = self._task_manager.get_dataset_tasks(
                self._node_type, self._node_id, dataset_name,
                max_tasks=max_tasks, incarnation=incarnation,
            )
        return [_as_comm_task(t) for t in tasks]

    def report_task_result(self, dataset_name, task_id, err_message=""):
        with tracing.span("rpc.report_task_result"):
            accepted = self._task_manager.report_dataset_task(
                dataset_name, task_id, not err_message
            )
        return comm.Response(success=bool(accepted))

    def get_dataset_epoch(self, dataset_name: str) -> int:
        return self._task_manager.get_dataset_epoch(dataset_name)

    def get_shard_checkpoint(self, dataset_name: str) -> str:
        ckpt = self._task_manager.get_dataset_checkpoint(dataset_name)
        return ckpt.to_json() if ckpt else ""

    def report_shard_checkpoint(self, content: str) -> bool:
        """Restore the dataset's shard ledger; False when the checkpoint
        was refused (the JAX client returns nothing)."""
        return self._task_manager.restore_dataset_from_checkpoint(content)

    def report_global_step(self, step, timestamp=None):
        pass

    def report_goodput(self, final=False):
        pass

    def report_custom_data(self, data):
        pass

    def report_model_info(self, param_count, flops_per_step, batch_size,
                          seq_len=0, extra=None):
        pass

    # the agent's calls: an in-process master has no agent to answer,
    # so they keep what they are given and report nothing
    def kv_store_set(self, key, value):
        self._kv[key] = value

    def kv_store_get(self, key):
        return self._kv.get(key, b"")

    def kv_store_keys(self, prefix=""):
        return sorted(k for k in self._kv if k.startswith(prefix))

    def kv_store_delete(self, key):
        self._kv.pop(key, None)

    def report_heartbeat(self):
        return ""

    def report_node_status(self, report):
        # masterless: ack everything so the reporter idles quietly
        return comm.NodeStatusAck(accepted=True, acked_seq=report.seq)

    def relinquish_shards(self, dataset_name=""):
        self._task_manager.recover_tasks(self._node_type, self._node_id)
        return 0

    def report_preemption(self, reason="", notice_budget_s=0.0,
                          deadline_ts=0.0, restart_count=0):
        pass

    def report_anomaly(self, kind, step, value=0.0, zscore=0.0,
                       host="", last_good_step=-1, restart_count=0):
        # masterless: no one to coordinate a rollback with; the
        # sentinel's local anomaly window is the whole story
        return None

    def report_reshard(self, order_id, phase, detail=""):
        # masterless: a single process has no mesh to transition
        return None


_master_client = None


def build_master_client(master_addr: Optional[str] = None,
                        node_id: Optional[int] = None,
                        node_type: Optional[str] = None,
                        timeout: float = 30.0):
    """Build a (cached) master client from args or env
    (parity: master_client.py:466): the RPC :class:`MasterClient` for a
    master address, else the in-process :class:`LocalMasterClient`."""
    global _master_client
    master_addr = master_addr or os.getenv(NodeEnv.MASTER_ADDR, "")
    if node_id is None:
        node_id = int(os.getenv(NodeEnv.NODE_ID, "0"))
    if node_type is None:
        node_type = os.getenv(NodeEnv.NODE_TYPE, "worker")
    if master_addr:
        _master_client = MasterClient(
            master_addr, node_id, node_type, timeout
        )
    else:
        _master_client = LocalMasterClient(node_id, node_type)
    return _master_client


def get_master_client():
    global _master_client
    if _master_client is None:
        _master_client = build_master_client()
    return _master_client
