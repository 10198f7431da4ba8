"""The port's distributed master (``master/dist_master.py``) against the
JAX package's.

* The failover unit tests of ``tests/test_master_failover.py`` that
  ``test_torch_state_journal.py`` does not hold run once per package
  (re-pointed at the port as ``test_torch_control_plane.load_repointed``
  does), and one master's journaled state -- a dataset with shards in
  flight, the KV store, a rendezvous round, the global step, the goodput
  account -- is restored by a second master of each package through
  ``DistributedJobMaster._restore_state``, with the same
  ``master.restored`` record.
* A lean mirror of ``test_master_kill_drill``: two ``--platform
  process`` masters of the port on one state dir, the first killed by
  ``master_crash@4``, two shard-consuming workers of the port's client
  (``tests/_torch_master_failover_worker.py``) riding out the restart.
  Shards are delivered exactly once, rendezvous rounds stay monotonic,
  and the journal holds ``master.restored``, ``agent.master_lost`` and
  ``agent.master_reconnected``. The same run with the second master
  started ``--fresh`` (its state thrown away) fails those gates.
* A reshard coordinator's fallback at the job-manager level (the
  fallback drill of ``tests/test_reshard_drill.py``): the shed rank is
  not relaunched by its loss, and the aborted order's fallback gives it
  a relaunch plan, in both packages alike.
* The knobs of the planes the port's master leaves out raise, naming
  their queues.
"""

import importlib
import json
import os
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import pytest

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import (
    NodeEventType,
    NodeExitReason,
    NodeStatus,
    NodeType,
    RendezvousName,
)
from dlrover_tpu_torch.fault_tolerance.injection import (
    MASTER_CRASH_EXIT_CODE,
)
from dlrover_tpu_torch.master import main as master_main
from dlrover_tpu_torch.master.dist_master import DistributedJobMaster
from dlrover_tpu_torch.master.resource.local_optimizer import (
    TPULocalOptimizer,
)
from dlrover_tpu_torch.scheduler import factory
from dlrover_tpu_torch.scheduler.job_spec import JobArgs
from dlrover_tpu_torch.telemetry.journal import read_journal

from tests.test_torch_control_plane import PACKAGES, run_repointed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the unit cases of tests/test_master_failover.py this module holds
#: (test_torch_state_journal.py holds the journal's own round trips)
FAILOVER_CASES = [
    "test_checkpoint_detail_roundtrip",
    "test_checkpoint_legacy_json_still_loads",
    "test_ledger_roundtrip_exactly_once",
    "test_keep_doing_false_requeues_in_flight",
    "test_rdzv_round_restore_is_monotonic",
    "test_speed_monitor_restore",
]


@pytest.fixture(autouse=True)
def quiet(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_METRICS_PORT", "off")
    for name in ("DLROVER_TPU_BRAIN", "DLROVER_TPU_SERVE_AUTOSCALE",
                 "DLROVER_TPU_RESHARD", "DLROVER_TPU_MASTER_STATE_DIR",
                 "DLROVER_FAULT_INJECT"):
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("name", FAILOVER_CASES)
def test_jax_failover_case_in_both_packages(name, pkg, request):
    run_repointed("test_master_failover.py", pkg, name, request)


# ------------------------------------------- _restore_state, in process


def _journaled_master(pkg, state_dir):
    """A master of ``pkg`` that journals a dataset with two shards in
    flight, a KV key, a completed rendezvous round, the global step and
    a goodput report; then a second master restores from the same dir.
    Returns what the second one holds."""
    dm = importlib.import_module(f"{pkg}.master.dist_master")
    cm = importlib.import_module(f"{pkg}.common.comm")
    tel = importlib.import_module(f"{pkg}.telemetry")
    journal = importlib.import_module(f"{pkg}.telemetry.journal")
    tel.set_default_journal(journal.EventJournal(None))
    args = SimpleNamespace(job_name="restore-job", node_num=0)
    first = dm.DistributedJobMaster(port=0, job_args=args,
                                    state_dir=state_dir)
    h = first.servicer.handle
    h("report_dataset_shard_params", cm.DatasetShardParams(
        batch_size=4, num_epochs=1, dataset_size=32, shuffle=False,
        num_minibatches_per_shard=1, dataset_name="ds",
        task_type="training", storage_type="table"))
    inflight = [h("get_task", cm.TaskRequest(
        node_type="worker", node_id=i, dataset_name="ds")) for i in (0, 1)]
    done = h("get_task", cm.TaskRequest(
        node_type="worker", node_id=0, dataset_name="ds"))
    h("report_task_result", cm.TaskResult(
        dataset_name="ds", task_id=done.task_id))
    h("kv_store_set", cm.KVStoreSetRequest(key="k", value=b"v"))
    h("report_rdzv_params", cm.RendezvousParams(
        min_nodes=2, max_nodes=2, waiting_timeout=0.0, node_unit=1))
    for i in (0, 1):
        h("join_rendezvous", cm.JoinRendezvousRequest(
            node_id=i, node_type="worker", local_world_size=1,
            rdzv_name=RendezvousName.TRAINING))
    time.sleep(0.01)
    round1 = h("get_comm_world", cm.CommWorldRequest(
        node_id=0, rdzv_name=RendezvousName.TRAINING)).rdzv_round
    h("report_global_step", cm.GlobalStep(
        node_id=0, step=7, timestamp=time.time()))
    first.goodput_aggregator.observe_report(
        node_id=0, pid=1, start_ts=time.time() - 5, elapsed_s=5.0,
        phases={"training": 5.0})
    first.state_journal.close()  # the crash: nothing else is flushed
    second = dm.DistributedJobMaster(port=0, job_args=args,
                                     state_dir=state_dir)
    h2 = second.servicer.handle
    accepted = [h2("report_task_result", cm.TaskResult(
        dataset_name="ds", task_id=t.task_id)).success for t in inflight]
    restored = tel.default_journal().events("master.restored")
    out = {
        "restored": [e["data"] for e in restored],
        "round1": round1,
        "round": second.rdzv_managers[RendezvousName.TRAINING]._rdzv_round,
        "kv": second.kv_store.get("k"),
        "step": second.speed_monitor.completed_global_step,
        "accepted": accepted,
        "faults": [f["cause"] for f in
                   second.goodput_aggregator.summary()["faults"]],
    }
    for master in (first, second):
        master.stop()
    return out


def test_restore_state_matches_jax(tmp_path):
    got = {pkg: _journaled_master(pkg, str(tmp_path / pkg))
           for pkg in PACKAGES}
    assert got["dlrover_tpu_torch"] == got["dlrover_tpu"]
    port = got["dlrover_tpu_torch"]
    assert port["restored"] == [{
        "datasets": ["ds"], "kv_keys": 1,
        "rdzv_rounds": {RendezvousName.TRAINING: port["round1"]},
        "global_step": 7}]
    assert port["round"] >= port["round1"] >= 1
    assert port["kv"] == b"v" and port["step"] >= 7
    assert port["accepted"] == [True, True]
    assert port["faults"] == ["master_restart"]


# --------------------------------------------- the reshard fallback path


def _fallback(pkg, monkeypatch):
    """Three workers under a reshard-armed master of ``pkg``: rank 2
    dies, the coordinator sheds it, a survivor aborts the order, and the
    fallback relaunches rank 2. Returns the scale plans, the order kinds
    broadcast and the journaled reshard events."""
    monkeypatch.setenv("DLROVER_TPU_RESHARD", "1")
    mod = {n: importlib.import_module(f"{pkg}.{n}") for n in (
        "master.dist_master", "master.scaler.base_scaler",
        "master.watcher.base_watcher", "common.node", "common.comm",
        "telemetry", "telemetry.journal")}
    mod["telemetry"].set_default_journal(
        mod["telemetry.journal"].EventJournal(None))
    plans = []

    class RecordingScaler(mod["master.scaler.base_scaler"].Scaler):
        def __init__(self):
            super().__init__("fallback")

        def scale(self, plan):
            plans.append((sorted((n.id, n.rank_index, n.relaunch_count)
                                 for n in plan.launch_nodes),
                          sorted(n.id for n in plan.remove_nodes)))

    args = SimpleNamespace(job_name="fallback", node_num=3,
                           node_resource=mod["common.node"].NodeResource())
    master = mod["master.dist_master"].DistributedJobMaster(
        port=0, job_args=args, scaler=RecordingScaler(),
        autoscale_interval=3600)
    jm, h, cm = master.job_manager, master.servicer.handle, mod["common.comm"]
    try:
        jm.start()
        for i in range(3):
            h("update_node_status", cm.NodeStatusRequest(
                node_type="worker", node_id=i, status="running"))
        master.transition_coordinator.seal_world()
        dead = mod["common.node"].Node(NodeType.WORKER, 2,
                                       status=NodeStatus.FAILED)
        dead.set_exit_reason(NodeExitReason.KILLED)
        jm.process_event(mod["master.watcher.base_watcher"].NodeEvent(
            NodeEventType.MODIFIED, dead))
        shed = list(plans)
        order = master.transition_coordinator.active_order
        action = h("report_reshard", cm.ReshardReport(
            node_type="worker", node_id=0, order_id=order.id,
            phase="aborted"))
    finally:
        jm.stop()
        master.stop()
    events = [e["kind"] for e in mod["telemetry"].default_journal().events()
              if e["kind"].startswith("reshard.")]
    return {"shed": shed, "plans": plans, "order": order.kind,
            "action": getattr(action, "action", action), "events": events}


def test_reshard_fallback_relaunches_the_shed_rank(monkeypatch):
    got = {pkg: _fallback(pkg, monkeypatch) for pkg in PACKAGES}
    assert got["dlrover_tpu_torch"] == got["dlrover_tpu"]
    port = got["dlrover_tpu_torch"]
    launch = [(0, 0, 0), (1, 1, 0), (2, 2, 0)]
    assert port["shed"] == [(launch, [])]  # the loss relaunched nothing
    assert port["order"] == "shrink"
    # the fallback: rank 2 back as a fresh incarnation, the dead id gone
    assert port["plans"] == [(launch, []), ([(3, 2, 1)], [2])]
    assert "reshard.aborted" in port["events"]
    assert "reshard.completed" not in port["events"]


# ---------------------------------------------- the planes left out


@pytest.mark.parametrize("knob", [
    "brain_client", "brain_addr", "brain_store_path", "DLROVER_TPU_BRAIN",
    "DLROVER_TPU_SERVE_AUTOSCALE"])
def test_left_out_knobs_raise_naming_their_queue(knob, monkeypatch):
    kwargs, args = {}, JobArgs(job_name="knob", node_num=0)
    queue = "A.3" if knob == "DLROVER_TPU_SERVE_AUTOSCALE" else "A.2.4"
    if knob == "brain_client":
        kwargs["brain_client"] = object()
    elif knob.startswith("brain_"):
        setattr(args, knob, "somewhere")
    else:
        monkeypatch.setenv(knob, "observe" if "BRAIN" in knob else "1")
    with pytest.raises(NotImplementedError, match=queue):
        DistributedJobMaster(port=0, job_args=args, **kwargs)


def test_off_knobs_and_the_left_out_surfaces(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_BRAIN", "off")
    monkeypatch.setenv("DLROVER_TPU_SERVE_AUTOSCALE", "0")
    master = DistributedJobMaster(port=0, job_args=JobArgs(node_num=0))
    try:
        for rpc in ("serve_submit", "serve_lease", "report_fleet_digest"):
            with pytest.raises(ValueError, match="unknown RPC method"):
                master.servicer.handle(rpc, comm.BaseRequest())
    finally:
        master.stop()
    with pytest.raises(NotImplementedError, match="A.2.4"):
        TPULocalOptimizer(brain_client=object())
    with pytest.raises(NotImplementedError, match="A.2.4"):
        factory.fetch_avoid_hosts(object())
    assert factory.fetch_avoid_hosts(None) is None
    for platform in ("tpu_vm", "gke"):
        with pytest.raises(NotImplementedError,
                           match="No counterpart this round"):
            factory.build_platform(JobArgs(platform=platform), "h:1")
    with pytest.raises(NotImplementedError,
                       match="No counterpart this round"):
        master_main.main(["--platform", "tpu_vm", "--node_num", "0"])


def test_a_failed_job_exits_with_the_job_failed_code(tmp_path):
    """``--platform process`` end to end in this process: the spec's one
    worker exits 1 with no relaunch budget, its node is critical (rank
    0 by default), and the master's ``main`` returns 3."""
    spec = tmp_path / "job.json"
    spec.write_text(json.dumps({"metadata": {"name": "failing"}, "spec": {
        "platform": "process", "worker": {
            "replicas": 1, "maxRelaunchCount": 0,
            "command": [sys.executable, "-c", "import sys; sys.exit(1)"]}}}))
    assert master_main.main(["--job_spec", str(spec), "--check_interval",
                             "0.1"]) == master_main.JOB_FAILED_EXIT_CODE


# --------------------------------------------- master_crash's injector


@pytest.mark.parametrize("role", ["worker", "master"])
@pytest.mark.parametrize("spec", [
    "master_crash@4", "master_crash@5:2,crash@3:host=1",
    "node_lost@3:host=1,master_crash@6", "crash@2,hang@3"])
def test_each_role_keeps_the_kinds_jax_keeps(spec, role):
    from dlrover_tpu.fault_tolerance import injection as jax_injection
    from dlrover_tpu_torch.fault_tolerance import injection

    def kept(mod):
        inj = mod.FaultInjector(spec, node_rank=1, role=role)
        return [(f.kind, f.step, f.arg) for f in inj._faults]

    assert kept(injection) == kept(jax_injection)
    assert (injection.MASTER_CRASH_EXIT_CODE
            == jax_injection.MASTER_CRASH_EXIT_CODE == 28)
    assert sorted(injection.WAITS_FOR) == ["serve_kill"]


# ------------------------------------------------- the master-kill drill


def _spawn(cmd, tmp, tag, env):
    return subprocess.Popen(
        cmd, cwd=REPO, env=env, start_new_session=True,
        stdout=open(os.path.join(tmp, f"{tag}.out"), "w"),
        stderr=open(os.path.join(tmp, f"{tag}.err"), "w"))


def _master_cmd(state_dir, port, *extra):
    return [sys.executable, "-m", "dlrover_tpu_torch.master.main",
            "--platform", "process", "--node_num", "0",
            "--job_name", "failover-drill", "--port", str(port),
            "--state_dir", state_dir, "--autoscale_interval", "600",
            "--check_interval", "0.2", *extra]


def _port_of(tmp, tag, proc, timeout=30):
    path = os.path.join(tmp, f"{tag}.out")
    deadline = time.time() + timeout
    while time.time() < deadline:
        for line in open(path):
            if line.startswith("DLROVER_TPU_MASTER_PORT="):
                return int(line.strip().split("=", 1)[1])
        assert proc.poll() is None, open(
            os.path.join(tmp, f"{tag}.err")).read()[-2000:]
        time.sleep(0.1)
    raise AssertionError(f"{tag} never printed its port")


def _drill(tmp, fresh):
    """One drill: master #1 with master_crash@4, two workers, then master
    #2 on the same state dir and port (``--fresh`` for the plant); the
    exit codes."""
    os.makedirs(tmp, exist_ok=True)
    state = os.path.join(tmp, "state")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DLROVER_TPU_", "DLROVER_FAULT"))}
    env.update(PYTHONPATH=REPO, DLROVER_TPU_METRICS_PORT="off",
               DLROVER_TPU_JOURNAL=os.path.join(tmp, "journal.jsonl"))
    procs = {"m1": _spawn(_master_cmd(state, 0), tmp, "m1", dict(
        env, DLROVER_FAULT_INJECT="master_crash@4",
        DLROVER_TPU_CTX_TASK_PROCESS_TIMEOUT="20"))}
    try:
        port = _port_of(tmp, "m1", procs["m1"])
        for i in (0, 1):
            procs[i] = _spawn(
                [sys.executable,
                 os.path.join(REPO, "tests", "_torch_master_failover_worker.py"),
                 "--master_addr", f"localhost:{port}", "--node_id", str(i),
                 "--out", os.path.join(tmp, f"worker-{i}.txt"),
                 "--rdzv_timeout", "3"], tmp, f"w{i}",
                # reconnect probes at most 0.5 s apart: both workers are
                # back within the rendezvous timeout of each other
                dict(env, DLROVER_TPU_MASTER_RECONNECT_TIMEOUT="60",
                     DLROVER_TPU_MASTER_RECONNECT_BACKOFF_MAX="0.5"))
        rcs = {"m1": procs["m1"].wait(timeout=60)}
        procs["m2"] = _spawn(
            _master_cmd(state, port, *(["--fresh"] if fresh else [])),
            tmp, "m2", dict(env, DLROVER_TPU_CTX_TASK_PROCESS_TIMEOUT="20"))
        for i in (0, 1):
            rcs[i] = procs[i].wait(timeout=90)
        try:
            # the restored master ends with the dataset, within its
            # 2 s completion grace of the workers
            rcs["m2"] = procs["m2"].wait(timeout=3)
        except subprocess.TimeoutExpired:
            rcs["m2"] = None
        return rcs
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()


def _gates(tmp, rcs) -> list:
    """The kill drill's gates; the failed ones."""
    failed = []
    if rcs != {"m1": MASTER_CRASH_EXIT_CODE, 0: 0, 1: 0, "m2": 0}:
        failed.append(f"exit codes {rcs}")
    ranges, rounds = [], {}
    for i in (0, 1):
        for line in open(os.path.join(tmp, f"worker-{i}.txt")):
            parts = line.split()
            if parts[0] == "SHARD":
                ranges.append((int(parts[1]), int(parts[2])))
            elif parts[0] in ("ROUND1", "ROUND2"):
                rounds[(i, parts[0])] = int(parts[1])
    ranges.sort()
    if (not ranges or ranges[0][0] != 0 or ranges[-1][1] != 96
            or any(a[1] != b[0] for a, b in zip(ranges, ranges[1:]))
            or len(ranges) != 96 // 4):
        failed.append(f"shards not exactly once: {ranges}")
    if any(rounds.get((i, "ROUND2"), -1) <= rounds.get((i, "ROUND1"), 0)
           for i in (0, 1)):
        failed.append(f"rounds not monotonic: {rounds}")
    events = read_journal(os.path.join(tmp, "journal.jsonl"))
    kinds = [e["kind"] for e in events]
    restored = [e["data"] for e in events if e["kind"] == "master.restored"]
    if (kinds.count("agent.master_lost") < 2
            or kinds.count("agent.master_reconnected") < 2
            or "fault.injected" not in kinds):
        failed.append("journal: lost/reconnected/injected missing")
    if not restored or restored[0]["datasets"] != ["failover-drill"] \
            or restored[0]["global_step"] < 1:
        failed.append(f"master.restored {restored}")
    return failed


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The drill and its --fresh plant, started side by side in threads
    at the module's first test: the tests before the drill's run
    meanwhile. {name: (its directory, its future)}."""
    root = tmp_path_factory.mktemp("master_kill")
    with ThreadPoolExecutor(2) as pool:
        yield {name: (str(root / name), pool.submit(
            _drill, str(root / name), fresh=name == "fresh"))
            for name in ("drill", "fresh")}


@pytest.fixture(scope="module")
def drills(started):
    """Each run's failed gates."""
    return {name: _gates(tmp, future.result())
            for name, (tmp, future) in started.items()}


def test_master_kill_drill_keeps_shards_exactly_once(drills):
    assert drills["drill"] == []


def test_a_fresh_second_master_fails_the_drill_gates(drills):
    failed = " | ".join(drills["fresh"])
    assert "master.restored" in failed
    assert "rounds not monotonic" in failed or "exit codes" in failed
