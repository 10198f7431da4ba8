"""The port's distributed job manager against the JAX package's.

* Every case of ``tests/test_job_manager.py`` and
  ``tests/test_critical_nodes.py``, and the three job-manager cases of
  ``tests/test_drain.py``, run once per package (re-pointed at the port
  as ``test_torch_control_plane.load_repointed`` does).
* One sequence of node events -- RUNNING, an OOM exit, a FATAL exit, an
  announced preemption, a maintenance flag, a shed rank's reshard
  fallback -- goes to both packages' ``DistributedJobManager`` over
  recording scalers: the node tables, relaunch counts, exit reasons,
  scale plans, heartbeat actions and callback order are equal. The
  maintenance DRAIN goes to the named node alone in both (ROADMAP.md
  C.1 is the reference's behaviour, mirrored).
* A fault of the reference repaired in the port: a node the master
  learns of from its own report keeps its id when the manager scales
  up or relaunches (JAX hands the id out again).
"""

import importlib
import time
from types import SimpleNamespace

import pytest

from dlrover_tpu_torch.common.constants import NodeStatus, NodeType
from dlrover_tpu_torch.master.node.training_node import TrainingNodeManager

from tests.test_torch_control_plane import PACKAGES, run_repointed

#: (test file, cases) of the JAX package's job-manager tests
CASES = [
    ("test_job_manager.py", name) for name in (
        "test_start_launches_initial_workers",
        "test_failed_worker_relaunches_with_new_id",
        "test_oom_relaunch_grows_memory",
        "test_fatal_error_never_relaunches",
        "test_relaunch_count_exhaustion",
        "test_heartbeat_watchdog_only_arms_after_first_report",
        "test_watcher_event_stream_drives_manager",
        "test_auto_scaler_executes_plan_diff",
        "test_local_optimizer_restores_lost_capacity",
        "test_dist_master_lifecycle_with_fake_platform",
    )
] + [
    ("test_critical_nodes.py", name) for name in (
        "test_parse_critical_worker_index",
        "test_spec_parses_critical_index",
        "test_critical_node_fatal_error_fails_job",
        "test_non_critical_node_loss_does_not_fail_job",
        "test_critical_node_relaunchable_failure_relaunches_not_fails",
        "test_parse_critical_worker_index_yaml_booleans",
    )
] + [
    ("test_drain.py", name) for name in (
        "test_announced_preemption_relaunches_without_charging_budget",
        "test_unannounced_preemption_still_charges_budget",
        "test_maintenance_event_queues_drain_heartbeat_action",
    )
]


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][:-3]}::{c[1]}")
def test_jax_case_in_both_packages(case, pkg, request,
                                   monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_METRICS_PORT", "off")
    run_repointed(case[0], pkg, case[1], request)


# ------------------------------------------------ one event sequence


def _modules(pkg):
    names = ("common.constants", "common.node",
             "master.node.dist_job_manager", "master.scaler.base_scaler",
             "master.watcher.base_watcher",
             "master.resource.local_optimizer",
             "master.monitor.speed_monitor", "telemetry")
    return SimpleNamespace(**{
        n.split(".")[-1]: importlib.import_module(f"{pkg}.{n}")
        for n in names})


def _node(n):
    return {k: getattr(n, k) for k in (
        "id", "rank_index", "status", "relaunch_count",
        "max_relaunch_count", "exit_reason", "relaunchable", "is_released",
        "critical", "preempt_announced")} | {
        "memory": n.config_resource.memory if n.config_resource else None}


def _sequence(pkg):
    """Drive one package's DistributedJobManager through the sequence;
    returns what the comparison reads."""
    m = _modules(pkg)
    c = m.constants
    m.telemetry.set_default_journal(m.telemetry.EventJournal(None))
    calls, plans = [], []

    class RecordingScaler(m.base_scaler.Scaler):
        def __init__(self):
            super().__init__("seq")

        def scale(self, plan):
            plans.append({
                "launch": [_node(n) for n in plan.launch_nodes],
                "remove": [n.id for n in plan.remove_nodes]})

    args = SimpleNamespace(
        node_num=3, node_resource=m.node.NodeResource(memory=1000),
        max_relaunch_count=2, critical_worker_index={0: 2})
    mgr = m.dist_job_manager.create_job_manager(
        args, m.speed_monitor.SpeedMonitor(), scaler=RecordingScaler(),
        job_optimizer=m.local_optimizer.TPULocalOptimizer(job_args=args))
    for kind in ("on_node_started", "on_node_succeeded", "on_node_failed",
                 "on_node_deleted"):
        mgr.add_callback(kind, lambda n, k=kind: calls.append((k, n.id)))

    def shed(node):
        # a reshard coordinator's shrink order sheds rank 2's second
        # incarnation: the master pins it un-relaunchable
        if node.rank_index == 2 and node.relaunch_count == 0 \
                and node.id != 2:
            node.relaunchable = False
    mgr.add_callback("on_node_failed", shed)

    def event(node_id, status, reason="", maintenance=False):
        n = m.node.Node(c.NodeType.WORKER, node_id, status=status)
        if reason:
            n.set_exit_reason(reason)
        n.maintenance_pending = maintenance
        mgr.process_event(m.base_watcher.NodeEvent(
            c.NodeEventType.MODIFIED, n))

    mgr.start()
    try:
        for i in range(3):
            event(i, c.NodeStatus.RUNNING)
        event(0, c.NodeStatus.FAILED, c.NodeExitReason.OOM)
        event(1, c.NodeStatus.FAILED, c.NodeExitReason.FATAL_ERROR)
        mgr.handle_preemption_notice(c.NodeType.WORKER, 2, "sigterm")
        event(2, c.NodeStatus.FAILED, c.NodeExitReason.PREEMPTED)
        for i in (3, 4):
            event(i, c.NodeStatus.RUNNING)
        event(3, c.NodeStatus.RUNNING, maintenance=True)
        actions = {i: mgr.collect_node_heartbeat(
            c.NodeType.WORKER, i, 1.0) for i in range(5)}
        event(4, c.NodeStatus.FAILED, c.NodeExitReason.KILLED)
        shed_plans = len(plans)
        mgr.handle_reshard_fallback([2])
    finally:
        mgr.stop()
    journal = m.telemetry.default_journal()
    return {
        "nodes": sorted((_node(n) for n in mgr.get_all_nodes()),
                        key=lambda d: d["id"]),
        "plans": plans, "calls": calls, "actions": actions,
        "shed_plans": shed_plans, "failed": mgr.is_job_failed(),
        "events": [e["kind"] for e in journal.events()
                   if e["kind"].startswith("preempt.")],
    }


def test_event_sequence_matches_jax():
    want = _sequence("dlrover_tpu")
    got = _sequence("dlrover_tpu_torch")
    assert got == want
    nodes = {n["id"]: n for n in got["nodes"]}
    # the OOM relaunch grew the memory, the FATAL exit stayed down, the
    # announced preemption came back without charging the budget
    assert nodes[3]["rank_index"] == 0 and nodes[3]["memory"] == 1500
    assert nodes[3]["relaunch_count"] == 1
    assert not any(p["launch"] and p["launch"][0]["rank_index"] == 1
                   for p in got["plans"])
    assert nodes[4]["rank_index"] == 2 and nodes[4]["relaunch_count"] == 0
    # the shed rank came back only through the fallback
    assert got["shed_plans"] == 3 and len(got["plans"]) == 4
    assert got["plans"][-1]["launch"][0]["rank_index"] == 2
    assert got["plans"][-1]["remove"] == [4]
    assert ("on_node_failed", 4) in got["calls"]
    # ROADMAP C.1: the maintenance DRAIN reaches the named node only
    assert got["actions"] == {0: None, 1: None, 2: None, 3: "drain",
                              4: None}
    assert got["events"] == ["preempt.relaunched",
                             "preempt.drain_requested"]
    assert not got["failed"]


# ------------------------------------------ a repaired fault of the JAX


def _learned_then_scaled(pkg):
    tn = importlib.import_module(f"{pkg}.master.node.training_node")
    node = importlib.import_module(f"{pkg}.common.node")
    mgr = tn.TrainingNodeManager(NodeType.WORKER)
    # two workers started outside the scaler report RUNNING
    for i in (0, 1):
        mgr.add_node(node.Node(NodeType.WORKER, i,
                               status=NodeStatus.RUNNING))
    new = mgr.scale_up_nodes(1, node.NodeResource())
    return new[0].id, sorted(mgr.nodes), mgr.nodes[0].status


def test_a_reported_node_keeps_its_id_on_scale_up():
    # JAX: the scale-up reuses id 0 and overwrites the running node
    assert _learned_then_scaled("dlrover_tpu") == (
        0, [0, 1], NodeStatus.INITIAL)
    assert _learned_then_scaled("dlrover_tpu_torch") == (
        2, [0, 1, 2], NodeStatus.RUNNING)
    mgr = TrainingNodeManager(NodeType.WORKER)
    assert [mgr.next_node_id() for _ in range(2)] == [0, 1]


def test_heartbeat_watchdog_declares_a_silent_node_lost():
    """The port's watchdog: a node silent past the timeout is FAILED
    with exit reason KILLED within a third of the timeout more, and a
    node that keeps reporting stays RUNNING."""
    from dlrover_tpu_torch.common.constants import NodeExitReason
    from dlrover_tpu_torch.master.node.dist_job_manager import (
        DistributedJobManager,
    )

    mgr = DistributedJobManager(heartbeat_timeout=0.6)
    for i in (0, 1):
        mgr.update_node_status(NodeType.WORKER, i, NodeStatus.RUNNING)
        mgr.collect_node_heartbeat(NodeType.WORKER, i, time.time())
    lost = []
    mgr.add_callback("on_node_failed", lambda n: lost.append(
        (n.id, time.time())))
    mgr.start()
    try:
        t0 = time.time()
        while time.time() - t0 < 1.2:
            mgr.collect_node_heartbeat(NodeType.WORKER, 0, time.time())
            time.sleep(0.05)
    finally:
        mgr.stop()
    assert [i for i, _ in lost] == [1]
    assert lost[0][1] - t0 < 0.6 + 0.2 + 0.3
    assert mgr.get_node(NodeType.WORKER, 0).status == NodeStatus.RUNNING
    assert (mgr.get_node(NodeType.WORKER, 1).exit_reason
            == NodeExitReason.KILLED)
