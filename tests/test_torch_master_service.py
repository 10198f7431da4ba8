"""The port's master service -- servicer, rendezvous, KV store, node
status -- and its RPC transport, against the JAX package's.

Three kinds of test:

* the same message sequence through both packages' in-process
  ``MasterServicer.handle`` gives the same replies under
  ``comm.serialize`` (wall-clock fields masked), and the same join order
  through both rendezvous managers the same rounds, worlds, process ids
  and groups;
* cases of the JAX package's ``tests/test_master_service.py``,
  ``test_rdzv_regressions.py`` and ``test_elastic_agent.py`` run once
  for each package, the port's with its imports re-pointed at the port
  (``test_torch_control_plane.load_repointed``), over real loopback RPC;
* the transport: every message type the launcher sends makes a round
  trip byte-equal to ``comm.serialize`` and packs to the JAX package's
  bytes, handler errors reach the client as the two error kinds, a
  refused connection and a timeout are connection errors, and the
  supervisor reconnects after the server restarts on the same port.
"""

import importlib
import inspect
import json
import socket
import threading
import time

import pytest

from dlrover_tpu.common import comm as jax_comm
from dlrover_tpu.common import grpc_utils as jax_grpc_utils
from dlrover_tpu_torch.agent.master_client import (
    MasterClient,
    build_master_client,
    get_master_client,
    is_connection_error,
)
from dlrover_tpu_torch.common import comm, grpc_utils
from dlrover_tpu_torch.common.constants import (
    GRPC,
    NodeAction,
    NodeEnv,
    NodeStatus,
    NodeType,
    RendezvousName,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common.grpc_utils import (
    GenericRpcClient,
    GenericRpcServer,
    RpcError,
    StatusCode,
)
from dlrover_tpu_torch.master.servicer import MasterServicer

from tests.test_torch_control_plane import (
    PACKAGES,
    load_repointed,
    stop_background_loops,
)

# ------------------------------------------------ servicer, both packages


def _servicer(pkg: str):
    """A master's components wired into ``pkg``'s MasterServicer, as the
    local master wires them, with no server around it."""

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    rdzv = mod("master.elastic_training.rdzv_manager")
    speed = mod("master.monitor.speed_monitor").SpeedMonitor()
    jobs = mod("master.node.local_job_manager").LocalJobManager(
        speed_monitor=speed)
    jobs.start()
    servicer = mod("master.servicer").MasterServicer(
        task_manager=mod("master.shard.task_manager").TaskManager(
            speed_monitor=speed),
        job_manager=jobs,
        speed_monitor=speed,
        rdzv_managers={
            RendezvousName.TRAINING:
                rdzv.ElasticTrainingRendezvousManager(),
            RendezvousName.NETWORK_CHECK:
                rdzv.NetworkCheckRendezvousManager(),
        },
        sync_service=mod("master.elastic_training.sync_service")
        .SyncService(jobs),
        error_monitor=mod("master.monitor.error_monitor").ErrorMonitor(),
    )
    return servicer, mod("common.comm")


W0 = dict(node_id=0, node_type=NodeType.WORKER)
W1 = dict(node_id=1, node_type=NodeType.WORKER)

#: (method, message type, fields): the launcher's RPCs in the order a
#: two-node job sends them, each reply compared across packages
SEQUENCE = [
    ("ping", "BaseRequest", {}),
    ("report_dataset_shard_params", "DatasetShardParams", dict(
        batch_size=4, num_epochs=2, dataset_size=40, shuffle=False,
        num_minibatches_per_shard=2, dataset_name="ds", **W0)),
    ("report_dataset_shard_params", "DatasetShardParams", dict(
        batch_size=4, num_epochs=2, dataset_size=40, shuffle=False,
        num_minibatches_per_shard=2, dataset_name="ds", **W1)),
    ("get_task", "TaskRequest", dict(dataset_name="ds", **W0)),
    ("get_task", "TaskRequest", dict(dataset_name="ds", **W1)),
    ("get_tasks", "TaskBatchRequest", dict(dataset_name="ds", max_tasks=2,
                                           **W0)),
    ("report_task_result", "TaskResult", dict(dataset_name="ds",
                                              task_id=0, **W0)),
    ("report_task_result", "TaskResult", dict(
        dataset_name="ds", task_id=1, err_message="worker died", **W1)),
    ("report_task_result", "TaskResult", dict(dataset_name="ds",
                                              task_id=99, **W0)),
    ("get_dataset_epoch", "DatasetEpochRequest", dict(dataset_name="ds",
                                                      **W0)),
    ("get_shard_checkpoint", "ShardCheckpointRequest",
     dict(dataset_name="ds", **W0)),
    ("report_rdzv_params", "RendezvousParams", dict(
        min_nodes=2, max_nodes=2, waiting_timeout=30.0, node_unit=1,
        joint_timeout=600.0, **W0)),
    ("join_rendezvous", "JoinRendezvousRequest", dict(
        local_world_size=1, rdzv_name=RendezvousName.TRAINING, **W1)),
    ("get_comm_world", "CommWorldRequest", dict(
        node_id=1, rdzv_name=RendezvousName.TRAINING)),
    ("join_rendezvous", "JoinRendezvousRequest", dict(
        local_world_size=1, rdzv_name=RendezvousName.TRAINING, **W0)),
    ("get_comm_world", "CommWorldRequest", dict(
        node_id=0, rdzv_name=RendezvousName.TRAINING)),
    ("get_comm_world", "CommWorldRequest", dict(
        node_id=1, rdzv_name=RendezvousName.TRAINING)),
    ("num_nodes_waiting", "WaitingNodeNumRequest", dict(
        rdzv_name=RendezvousName.TRAINING, **W0)),
    ("kv_store_set", "KVStoreSetRequest", dict(
        key="training/coordinator/1/0", value=b"10.0.0.1:29500")),
    ("kv_store_get", "KVStoreGetRequest", dict(
        key="training/coordinator/1/0")),
    ("kv_store_get", "KVStoreGetRequest", dict(key="missing")),
    ("kv_store_add", "KVStoreAddRequest", dict(key="n", amount=3)),
    ("kv_store_add", "KVStoreAddRequest", dict(key="n", amount=-1)),
    ("kv_store_keys", "KVStoreKeysRequest", dict(prefix="training/")),
    ("update_node_status", "NodeStatusRequest", dict(
        status=NodeStatus.RUNNING, **W0)),
    ("update_node_status", "NodeStatusRequest", dict(
        status=NodeStatus.RUNNING, **W1)),
    ("update_node_address", "NodeAddressRequest", dict(
        address="10.0.0.2:1234", **W1)),
    ("report_heartbeat", "HeartBeat", dict(timestamp=1000.0, **W0)),
    ("report_node_status", "NodeStatusReport", dict(
        timestamp=1000.5, incarnation=0, seq=1, full=True, has_step=True,
        step=3, step_ts=1000.4, pid=7, host="h0", **W0)),
    ("report_node_status", "NodeStatusReport", dict(
        timestamp=1001.0, incarnation=0, seq=2, has_resource=True,
        cpu_percent=50.0, memory_mb=2048, **W0)),
    ("report_node_status", "NodeStatusReport", dict(
        timestamp=1001.0, incarnation=1, seq=1, **W1)),
    ("report_global_step", "GlobalStep", dict(
        timestamp=1002.0, step=10, pid=7, **W0)),
    ("report_used_resource", "ResourceStats", dict(
        cpu_percent=55.0, memory_mb=1024, **W1)),
    ("report_failure", "NodeFailure", dict(
        error_data="no step progress for 3.5s", restart_count=0,
        level=TrainingExceptionLevel.HANG, **W0)),
    ("report_heartbeat", "HeartBeat", dict(timestamp=1003.0, **W0)),
    ("report_heartbeat", "HeartBeat", dict(timestamp=1004.0, **W0)),
    ("report_failure", "NodeFailure", dict(
        error_data="training process exited rc=17", restart_count=1,
        level=TrainingExceptionLevel.PROCESS_ERROR, **W1)),
    ("relinquish_shards", "RelinquishShardsRequest", dict(
        dataset_name="ds", **W0)),
    ("query_running_nodes", "RunningNodesRequest", dict(**W0)),
    ("join_sync", "SyncJoin", dict(sync_name="epoch", **W0)),
    ("sync_finished", "SyncFinish", dict(sync_name="epoch", **W0)),
    ("join_sync", "SyncJoin", dict(sync_name="epoch", **W1)),
    ("sync_finished", "SyncFinish", dict(sync_name="epoch", **W0)),
    ("barrier", "SyncBarrier", dict(barrier_name="b", **W0)),
    ("barrier", "SyncBarrier", dict(barrier_name="b", notify=True, **W0)),
    ("barrier", "SyncBarrier", dict(barrier_name="b", **W1)),
    ("report_node_check_status", "NodeCheckStatus", dict(
        rdzv_round=1, normal=True, elapsed_time=1.0, **W0)),
    ("network_check_success", "NetworkReadyRequest", dict(**W0)),
    ("get_fault_nodes", "BaseRequest", dict(**W0)),
    ("get_straggler_nodes", "BaseRequest", dict(**W0)),
    ("request_scale", "ScaleRequest", dict(node_num=4, **W0)),
    ("get_elastic_run_config", "ElasticRunConfigRequest", dict(**W0)),
    ("update_node_status", "NodeStatusRequest", dict(
        status=NodeStatus.SUCCEEDED, **W1)),
    ("update_node_status", "NodeStatusRequest", dict(
        status=NodeStatus.FAILED, exit_reason="oom", **W0)),
    ("query_running_nodes", "RunningNodesRequest", dict(**W0)),
]


def _wall_clock(key) -> bool:
    return isinstance(key, str) and ("time" in key or key.endswith("_ts"))


def _masked(doc):
    """A decoded reply with its wall-clock fields (times and timestamps
    the servicer takes itself) set to None, in the codec's dataclass
    fields and in its ``__map__`` pairs alike."""
    if isinstance(doc, dict) and "__map__" in doc:
        return {"__map__": [[k, None if _wall_clock(k) else _masked(v)]
                            for k, v in doc["__map__"]]}
    if isinstance(doc, dict):
        return {k: None if _wall_clock(k) else _masked(v)
                for k, v in doc.items()}
    if isinstance(doc, list):
        return [_masked(v) for v in doc]
    return doc


def _replies(pkg: str):
    servicer, comm_mod = _servicer(pkg)
    out = []
    for method, msg_type, fields in SEQUENCE:
        reply = servicer.handle(method, getattr(comm_mod, msg_type)(**fields))
        out.append((method, _masked(json.loads(comm_mod.serialize(reply)))))
    return out


def test_servicer_replies_match_jax():
    want = _replies("dlrover_tpu")
    got = _replies("dlrover_tpu_torch")
    assert len(got) == len(SEQUENCE)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, f"reply {i} ({SEQUENCE[i][0]}) differs"
    by_method = dict(got)
    # the sequence reaches what the launcher relies on: a world of two,
    # the coordinator key, the hang's restart action on a heartbeat
    # (the codec leaves fields at their defaults out)
    worlds = [r for m, r in got if m == "get_comm_world"]
    assert worlds[-1]["f"]["world"] == {"__map__": [[0, 1], [1, 1]]}
    actions = [r["f"].get("action", "") for m, r in got
               if m == "report_heartbeat"]
    assert actions == ["", NodeAction.RESTART_WORKER, ""]
    assert by_method["kv_store_add"]["f"]["value"] == 2


@pytest.mark.parametrize("method", [
    "serve_submit", "report_relay_batch", "report_goodput",
    "report_reshard", "report_model_info", "report_custom_data",
    "no_such_rpc",
])
def test_rpcs_left_out_are_unknown(method):
    servicer = MasterServicer()
    with pytest.raises(ValueError, match=f"unknown RPC method {method}"):
        servicer.handle(method, comm.BaseRequest())


#: join orders through both rendezvous managers: (min, max, node_unit,
#: joins as (rank, local world size), network check?)
JOIN_ORDERS = [
    (2, 2, 1, [(1, 1), (0, 1)], False),
    (2, 4, 2, [(2, 1), (0, 1), (1, 1)], False),
    (1, 3, 1, [(0, 4), (2, 4), (1, 4)], False),
    (4, 4, 1, [(3, 1), (1, 1), (0, 1), (2, 1)], True),
    (3, 3, 1, [(2, 1), (0, 1), (1, 1)], True),
]


def _rdzv_results(pkg, min_nodes, max_nodes, unit, joins, network):
    rdzv = importlib.import_module(
        f"{pkg}.master.elastic_training.rdzv_manager")
    cls = (rdzv.NetworkCheckRendezvousManager if network
           else rdzv.ElasticTrainingRendezvousManager)
    mgr = cls()
    mgr.update_rdzv_params(min_nodes, max_nodes, 0.0, unit)
    out = []
    for _ in range(2):  # a second round: every node re-joins
        out.append([mgr.join_rendezvous(r, n) for r, n in joins])
        time.sleep(0.01)  # past the waiting timeout of 0
        worlds = {}
        for rank, _ in joins:
            rdzv_round, group, world = mgr.get_comm_world(rank)
            ranks = sorted(world)
            pid = (sum(world[r] for r in ranks[:ranks.index(rank)])
                   if rank in world else None)
            worlds[rank] = (rdzv_round, group, dict(world), pid)
        out.append(worlds)
        out.append(mgr.num_nodes_waiting())
    return out


@pytest.mark.parametrize("case", JOIN_ORDERS, ids=lambda c: (
    f"{'check' if c[4] else 'train'}-{c[0]}to{c[1]}-unit{c[2]}"))
def test_rendezvous_results_match_jax(case):
    want = _rdzv_results("dlrover_tpu", *case)
    got = _rdzv_results("dlrover_tpu_torch", *case)
    assert got == want
    assert any(w[2] for w in got[1].values()), "no world formed"


# ------------------------------------------- re-pointed JAX test cases


def _fixture_fn(obj):
    return getattr(obj, "_get_wrapped_function", lambda: None)()


def run_case_with_module_fixtures(test_file: str, pkg: str, name: str,
                                  request) -> None:
    """Run one test of ``test_file`` in ``pkg``'s version, resolving the
    fixtures its module defines (``master``, ``client``) from that
    module, and pytest's own (``tmp_path``) from ``request``."""
    mod = load_repointed(test_file, pkg)
    finalizers = []
    cache = {}

    def resolve(arg):
        if arg in cache:
            return cache[arg]
        fn = _fixture_fn(getattr(mod, arg, None))
        if fn is None:
            value = request.getfixturevalue(arg)
        else:
            kwargs = {a: resolve(a) for a in inspect.signature(fn).parameters}
            value = fn(**kwargs)
            if inspect.isgenerator(value):
                gen = value
                value = next(gen)
                finalizers.append(gen)
        cache[arg] = value
        return value

    test = getattr(mod, name)
    before = set(threading.enumerate())
    try:
        test(**{a: resolve(a) for a in inspect.signature(test).parameters})
    finally:
        # the loops the case's agents left running stop while their
        # master still answers, then the fixtures stop the master
        started = {t for t in threading.enumerate()
                   if t not in before
                   and t.name in ("status-reporter", "telemetry-http")}
        if started:
            stop_background_loops(started)
            for thread in started:
                thread.join(timeout=2.0)
        for gen in reversed(finalizers):
            next(gen, None)


#: cases of the JAX tests the port re-points: every case that needs no
#: module this slice leaves out (CHANGES.md lists the one that does)
REPOINTED = {
    "test_master_service.py": [
        "test_ping",
        "test_sharding_protocol_over_grpc",
        "test_rendezvous_over_grpc",
        "test_node_unit_truncation",
        "test_kv_store_over_grpc",
        "test_node_status_and_heartbeat",
        "test_global_step_and_speed",
        "test_sync_and_barrier",
        "test_network_check_flow",
        "test_local_master_client_fallback",
    ],
    "test_rdzv_regressions.py": [
        "test_rerendezvous_same_membership_advances_round",
        "test_waiting_node_signals_membership_change",
        "test_truncated_node_stays_waiting_for_next_round",
        "test_spare_replaces_dead_member",
        "test_member_rejoin_always_signals_membership_change",
        "test_lazy_splitter_serves_full_final_epoch",
        "test_network_check_rounds_regroup",
        "test_singleton_probe_cannot_clear_abnormal_status",
        "test_dead_member_signals_shrink_without_waiters",
        "test_dead_member_no_signal_below_min_nodes",
        "test_succeeded_member_does_not_signal_shrink",
        "test_straggler_localized_across_two_paired_rounds",
        "test_no_straggler_when_all_groups_uniform",
        "test_no_world_before_params_reported",
        "test_ha_master_restart_relearns_params_from_rejoin",
        "test_subset_check_rounds_do_not_clear_straggler_verdicts",
    ],
    "test_elastic_agent.py": [
        "test_sharding_client_batch_done",
        "test_index_sharding_client",
        "test_rendezvous_handler_two_nodes",
        "test_agent_runs_process_to_success",
        "test_agent_restarts_failed_process",
        "test_agent_gives_up_after_max_restarts",
        "test_agent_restarts_on_membership_change",
    ],
}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", [
    (f, t) for f, names in REPOINTED.items() for t in names
], ids=lambda c: f"{c[0][:-3]}::{c[1]}")
def test_jax_case_in_both_packages(case, pkg, request):
    run_case_with_module_fixtures(case[0], pkg, case[1], request)


def test_repointed_cases_reach_the_port():
    for test_file in REPOINTED:
        mod = load_repointed(test_file, "dlrover_tpu_torch")
        for name in ("MasterClient", "LocalJobMaster",
                     "ElasticTrainingRendezvousManager",
                     "ElasticTrainingAgent"):
            if hasattr(mod, name):
                assert getattr(mod, name).__module__.startswith(
                    "dlrover_tpu_torch."), (test_file, name)


# ------------------------------------------------------------ transport


def _echo_server(handler=None):
    server = GenericRpcServer(handler or (lambda method, msg: msg), port=0)
    server.start()
    return server


#: every message type the launcher's RPCs carry, requests and replies,
#: with fields set away from their defaults
MESSAGES = [m for _, m, _ in SEQUENCE] + [
    "Response", "Task", "TaskBatch", "DatasetEpoch", "ShardCheckpoint",
    "RendezvousRound", "CommWorld", "WaitingNodeNum", "KVStoreValue",
    "KVStoreKeys", "KVStoreAddResult", "HeartbeatResponse",
    "NodeStatusAck", "RunningNodes", "ElasticRunConfig",
    "NetworkCheckResult", "RelinquishShardsResponse",
]
SAMPLES = {
    "Response": dict(success=True, reason="ok"),
    "Task": dict(task_id=3, task_type="training", shard=None),
    "TaskBatch": dict(tasks=[]),
    "DatasetEpoch": dict(epoch=2),
    "ShardCheckpoint": dict(content='{"todo": [[0, 8]]}'),
    "RendezvousRound": dict(round=4),
    "CommWorld": dict(rdzv_round=2, group=1, world={0: 1, 3: 1}),
    "WaitingNodeNum": dict(waiting_num=1),
    "KVStoreValue": dict(value=b"\x00\xffaddr"),
    "KVStoreKeys": dict(keys=["a", "b/c"]),
    "KVStoreAddResult": dict(value=-5),
    "HeartbeatResponse": dict(action=NodeAction.RESTART_WORKER),
    "NodeStatusAck": dict(accepted=True, action="stop", resync=True,
                          acked_seq=9),
    "RunningNodes": dict(nodes=[{"id": 0, "status": "running"}]),
    "ElasticRunConfig": dict(configs={"k": "v"}),
    "NetworkCheckResult": dict(success=False, reason="node 1"),
    "RelinquishShardsResponse": dict(requeued=2),
}


def _sample(comm_mod, msg_type):
    fields = SAMPLES.get(msg_type)
    if fields is None:
        fields = next(f for _, m, f in SEQUENCE if m == msg_type)
    if msg_type == "Task":
        fields = dict(fields, shard=comm_mod.Shard(
            name="ds", start=8, end=16, record_indices=[8, 9]))
    if msg_type == "TaskBatch":
        fields = dict(tasks=[_sample(comm_mod, "Task")])
    return getattr(comm_mod, msg_type)(**fields)


@pytest.fixture(scope="module")
def echo():
    server = _echo_server()
    client = GenericRpcClient(f"localhost:{server.port}", timeout=10)
    yield client
    client.close()
    server.stop()


@pytest.mark.parametrize("msg_type", sorted(set(MESSAGES)))
def test_message_round_trip_is_byte_equal(msg_type, echo):
    msg = _sample(comm, msg_type)
    back = echo.call("echo", msg)
    assert back == msg
    assert comm.serialize(back) == comm.serialize(msg)
    # the request payload is the JAX transport's, byte for byte
    assert grpc_utils._pack_call("echo", msg) == jax_grpc_utils._pack_call(
        "echo", _sample(jax_comm, msg_type))


def test_handler_errors_reach_the_client_as_two_kinds():
    def handler(method, msg):
        if method == "bad":
            raise ValueError("bad argument")
        raise RuntimeError("handler broke")

    server = _echo_server(handler)
    client = GenericRpcClient(f"localhost:{server.port}", timeout=10)
    try:
        with pytest.raises(RpcError) as bad:
            client.call("bad", comm.BaseRequest())
        with pytest.raises(RpcError) as broke:
            client.call("other", comm.BaseRequest())
    finally:
        client.close()
        server.stop()
    assert bad.value.code() == StatusCode.INVALID_ARGUMENT
    assert "bad argument" in bad.value.details
    assert broke.value.code() == StatusCode.INTERNAL
    assert "handler broke" in broke.value.details
    assert not is_connection_error(bad.value)
    assert not is_connection_error(broke.value)


def _raw_call(port: int, payload: bytes, trace: bytes = b""):
    with socket.create_connection(("localhost", port), timeout=10) as s:
        s.sendall(grpc_utils._frame(trace) + grpc_utils._frame(payload))
        return grpc_utils._recv_frame(s, 1 << 20)


def test_malformed_payload_rejected_without_executing():
    calls = []
    server = _echo_server(lambda m, msg: calls.append(m))
    try:
        import pickle

        reply = _raw_call(server.port, pickle.dumps(("ping", None)))
        assert reply[0] == StatusCode.INVALID_ARGUMENT
        reply = _raw_call(server.port, json.dumps(
            {"v": 2, "m": "ping", "d": None}).encode())
        assert reply[0] == StatusCode.INVALID_ARGUMENT
        # a garbled trace context degrades to none; the call still runs
        reply = _raw_call(server.port, grpc_utils._pack_call(
            "ping", comm.BaseRequest()), trace=b"\xff-")
        assert reply[0] == StatusCode.OK
    finally:
        server.stop()
    assert calls == ["ping"]


def test_frames_over_the_size_limits_are_refused(monkeypatch):
    server = _echo_server()
    client = GenericRpcClient(f"localhost:{server.port}", timeout=10)
    try:
        big = comm.KVStoreSetRequest(key="k", value=b"x" * 4096)
        monkeypatch.setattr(GRPC, "MAX_SEND_MESSAGE_LENGTH", 1024)
        with pytest.raises(RpcError) as sent:
            client.call("echo", big)
        monkeypatch.setattr(GRPC, "MAX_SEND_MESSAGE_LENGTH", 1 << 20)
        monkeypatch.setattr(GRPC, "MAX_RECEIVE_MESSAGE_LENGTH", 1024)
        with pytest.raises(RpcError) as received:
            client.call("echo", big)
    finally:
        client.close()
        server.stop()
    assert sent.value.code() == StatusCode.RESOURCE_EXHAUSTED
    assert received.value.code() == StatusCode.RESOURCE_EXHAUSTED


def test_trace_context_rides_with_the_call():
    from dlrover_tpu_torch.telemetry import tracing

    seen = []
    server = _echo_server(lambda m, msg: seen.append(
        tracing.traceparent()) or msg)
    client = GenericRpcClient(f"localhost:{server.port}", timeout=10)
    was = tracing.enabled()
    tracing.enable()
    try:
        with tracing.span("caller") as sp:
            client.call("echo", comm.BaseRequest())
        client.call("echo", comm.BaseRequest())
    finally:
        if not was:
            tracing.disable()
        client.close()
        server.stop()
    assert seen[0] is not None and seen[0].startswith(sp.trace_id + "-")
    assert seen[1] is None


def test_refused_connection_and_timeout_are_connection_errors():
    port = grpc_utils.find_free_port()
    client = GenericRpcClient(f"localhost:{port}", timeout=2)
    with pytest.raises(OSError) as refused:
        client.call("ping", comm.BaseRequest())
    assert is_connection_error(refused.value)

    release = threading.Event()
    server = _echo_server(lambda m, msg: release.wait(10) and msg)
    client = GenericRpcClient(f"localhost:{server.port}", timeout=0.3)
    try:
        with pytest.raises(OSError) as slow:
            client.call("echo", comm.BaseRequest())
    finally:
        release.set()
        client.close()
        server.stop()
    assert isinstance(slow.value, TimeoutError)
    assert is_connection_error(slow.value)


def test_concurrent_calls_each_get_their_own_reply():
    server = _echo_server()
    client = GenericRpcClient(f"localhost:{server.port}", timeout=10)
    errors = []

    def worker(i):
        try:
            for j in range(20):
                msg = comm.KVStoreAddResult(value=i * 100 + j)
                assert client.call("echo", msg) == msg
        except Exception as e:  # collected, asserted below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    client.close()
    server.stop()
    assert not errors and not any(t.is_alive() for t in threads)


def test_supervisor_reconnects_after_the_master_restarts_on_its_port():
    """A supervised call made while the master is down waits for it to
    come back on the same port, runs the re-hello hooks, then retries
    -- on a fresh connection, the old one having died with the server."""
    store = {}

    def handler(method, msg):
        if method == "ping":
            return comm.Response(success=True)
        if method == "kv_store_set":
            store[msg.key] = msg.value
            return comm.Response(success=True)
        return comm.KVStoreValue(value=store.get(msg.key, b""))

    server = GenericRpcServer(handler, port=0)
    server.start()
    port = server.port
    client = MasterClient(f"localhost:{port}", node_id=0,
                          node_type=NodeType.WORKER, timeout=5,
                          reconnect_timeout=20)
    hellos = []
    client.add_reconnect_hook("hello", lambda: hellos.append(
        client.kv_store_set("hello", b"again")))
    client.kv_store_set("k", b"v")
    assert client.kv_store_get("k") == b"v"
    server.stop()
    assert not client.ping()
    restarted = []

    def restart():
        time.sleep(0.5)
        store.clear()
        restarted.append(GenericRpcServer(handler, port=port))
        restarted[0].start()

    t = threading.Thread(target=restart)
    t.start()
    try:
        assert client.kv_store_get("k") == b""  # the new master's store
        assert hellos and client.kv_store_get("hello") == b"again"
        assert client.ping()
    finally:
        t.join(timeout=10)
        client.close()
        for s in restarted:
            s.stop()


def test_build_master_client_returns_the_rpc_client(monkeypatch):
    """A master address, given or from the env (the agent exports it to
    its worker), builds the RPC client; it no longer raises."""
    server = _echo_server(lambda m, msg: comm.Response(success=True))
    addr = f"localhost:{server.port}"
    monkeypatch.delenv(NodeEnv.MASTER_ADDR, raising=False)
    try:
        client = build_master_client(addr)
        assert isinstance(client, MasterClient)
        assert client.ping()
        client.close()
        monkeypatch.setenv(NodeEnv.MASTER_ADDR, addr)
        client = build_master_client()
        assert isinstance(client, MasterClient)
        assert client.master_addr == addr and client.ping()
        assert get_master_client() is client
        client.close()
    finally:
        server.stop()


def test_every_public_rpc_is_supervised_but_ping():
    """The JAX client's contract (its ``test_reconnect_supervisor.py``
    lint): each public MasterClient method rides the reconnect
    supervisor, except the ones it names."""
    from dlrover_tpu_torch.agent import master_client

    skip = {"add_reconnect_hook", "remove_reconnect_hook", "close"}
    public = {n for n, f in vars(MasterClient).items()
              if callable(f) and not n.startswith("_") and n not in skip}
    unsupervised = {n for n in public
                    if not getattr(vars(MasterClient)[n],
                                   "_supervised_rpc", False)}
    assert unsupervised == set(master_client.UNSUPERVISED_RPCS)
    assert len(public) > 30


def test_report_ledger_resyncs_and_evicts_on_the_final_report():
    class Jobs:
        beats = []

        def collect_node_heartbeat(self, node_type, node_id, timestamp):
            self.beats.append((node_id, timestamp))
            return NodeAction.RESTART_WORKER if timestamp == 3.0 else ""

    servicer = MasterServicer(job_manager=Jobs())

    def report(node_id, seq, **kw):
        return servicer.rpc_report_node_status(comm.NodeStatusReport(
            node_id=node_id, node_type=NodeType.WORKER, incarnation=0,
            seq=seq, timestamp=float(seq), **kw))

    assert report(0, 1).resync  # unknown reporter: resend everything
    assert not report(0, 2, full=True).resync
    ack = report(0, 3)
    assert not ack.resync and ack.action == NodeAction.RESTART_WORKER
    ack = report(0, 4, final=True)
    assert ack.accepted and ack.acked_seq == 4
    assert report(0, 5).resync  # the final report closed its baseline
    assert Jobs.beats == [(0, float(t)) for t in range(1, 6)]


def test_report_ledger_evicts_the_stalest_reporter_at_its_cap():
    from dlrover_tpu_torch.master.servicer import ReporterLedger

    ledger = ReporterLedger(cap=2)
    for node_id, ts in ((0, 5.0), (1, 1.0), (2, 9.0)):
        ledger.observe((NodeType.WORKER, node_id), 0, 1, True, ts)
    assert ledger.evictions == 1
    # node 1 was the stalest: its next delta report finds no baseline
    assert ledger.observe((NodeType.WORKER, 1), 0, 2, False, 10.0)
    assert not ledger.observe((NodeType.WORKER, 2), 0, 2, False, 10.0)
