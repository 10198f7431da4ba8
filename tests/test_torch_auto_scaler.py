"""The port's auto-scaler and job spec against the JAX package's.

* ``manual_scale`` and the straggler shrink of both packages'
  ``AllreduceTrainingAutoScaler``, over the same node tables and inputs,
  give the same scale plans and speed-monitor targets; each executed
  plan journals ``scale.plan`` and counts in
  ``dlrover_scale_plans_total``.
* ``test_master_service.py::test_manual_scale_rpc_retargets_and_reconciles``
  runs once per package, and again over the port's transport: a
  ``MasterClient.request_scale`` to a servicer built with the
  auto-scaler, which journals ``scale.request``.
* ``JobArgs.from_dict`` of both packages reads the same spec into the
  same fields, and ``from_file`` reads JSON (and YAML where ``yaml``
  imports) as JAX does.
"""

import dataclasses
import importlib
import json
from types import SimpleNamespace

import pytest

from dlrover_tpu.scheduler.job_spec import JobArgs as JaxJobArgs
from dlrover_tpu_torch import telemetry
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.constants import NodeStatus, NodeType
from dlrover_tpu_torch.master.servicer import create_master_service
from dlrover_tpu_torch.scheduler.job_spec import JobArgs
from dlrover_tpu_torch.telemetry.journal import EventJournal

from tests.test_torch_control_plane import PACKAGES, run_repointed


def _setup(pkg, nodes=4, node_unit=2, min_nodes=2, max_nodes=6,
           stragglers=()):
    """One package's job manager with ``nodes`` RUNNING workers it
    launched, its auto-scaler over a recording scaler, and what they
    record."""
    mod = {n: importlib.import_module(f"{pkg}.{n}") for n in (
        "common.node", "master.node.dist_job_manager",
        "master.node.job_auto_scaler", "master.scaler.base_scaler",
        "master.resource.local_optimizer", "master.monitor.speed_monitor",
        "telemetry")}
    mod["telemetry"].set_default_journal(
        mod["telemetry"].EventJournal(None))
    mod["telemetry"].set_default_registry(None)
    plans = []

    class RecordingScaler(mod["master.scaler.base_scaler"].Scaler):
        def __init__(self):
            super().__init__("auto")

        def scale(self, plan):
            plans.append((sorted((n.id, n.rank_index)
                                 for n in plan.launch_nodes),
                          sorted(n.id for n in plan.remove_nodes)))

    monitor = mod["master.monitor.speed_monitor"].SpeedMonitor()
    monitor.set_target_worker_num(nodes)
    args = SimpleNamespace(node_num=nodes, min_node_num=min_nodes,
                           node_resource=mod["common.node"].NodeResource())
    scaler = RecordingScaler()
    mgr = mod["master.node.dist_job_manager"].DistributedJobManager(
        job_args=args, speed_monitor=monitor, scaler=scaler)
    # the fleet the manager launched itself (ids from its own counter)
    for node in mgr._node_managers[NodeType.WORKER].scale_up_nodes(
            nodes, args.node_resource):
        mgr.update_node_status(NodeType.WORKER, node.id,
                               NodeStatus.RUNNING)
    optimizer = mod["master.resource.local_optimizer"].TPULocalOptimizer(
        job_args=args, speed_monitor=monitor, node_unit=node_unit)
    auto = mod["master.node.job_auto_scaler"].new_job_auto_scaler(
        mgr, optimizer, scaler, interval=3600,
        straggler_fn=lambda: list(stragglers), min_nodes=min_nodes,
        max_nodes=max_nodes)
    return SimpleNamespace(auto=auto, mgr=mgr, monitor=monitor,
                           plans=plans, telemetry=mod["telemetry"])


def _after(run):
    journal = run.telemetry.default_journal()
    total = run.telemetry.default_registry().counter(
        "dlrover_scale_plans_total", "Executed scale plans", ["direction"])
    return {
        "plans": run.plans,
        "target": run.monitor._target_worker_num,
        "nodes": sorted((n.id, n.status, n.is_released, n.relaunchable)
                        for n in run.mgr.get_all_nodes()),
        "events": [{k: v for k, v in e["data"].items()}
                   for e in journal.events("scale.plan")],
        "counted": {d: total.labels(direction=d).value
                    for d in ("up", "down")},
    }


@pytest.mark.parametrize("requests", [[5], [1], [6, 9, 3], [0, 8]])
def test_manual_scale_matches_jax(requests):
    got = {}
    for pkg in PACKAGES:
        run = _setup(pkg)
        for n in requests:
            assert run.auto.manual_scale(n)
        got[pkg] = _after(run)
    assert got["dlrover_tpu_torch"] == got["dlrover_tpu"]
    port = got["dlrover_tpu_torch"]
    # node_unit 2, min 2, max 6: the last request decides the target
    want = min(max(requests[-1] // 2 * 2, 2), 6)
    assert port["target"] == want
    assert len(port["events"]) == len(port["plans"])
    assert sum(port["counted"].values()) == len(port["plans"])


@pytest.mark.parametrize("stragglers,step", [
    ([1], 5), ([1, 3], 5), ([1, 2, 3], 5), ([7], 5), ([1], 0)])
def test_straggler_shrink_matches_jax(stragglers, step):
    got = {}
    for pkg in PACKAGES:
        run = _setup(pkg, stragglers=stragglers)
        if step:
            run.monitor.collect_global_step(step, 1.0)
        run.auto._maybe_shrink_stragglers()
        got[pkg] = _after(run)
    assert got["dlrover_tpu_torch"] == got["dlrover_tpu"]
    port = got["dlrover_tpu_torch"]
    if stragglers == [1] and step:
        # 4 - 1 aligns down to 2 workers: exactly the straggler goes,
        # then the newest healthy node
        assert port["plans"] == [([], [1, 3])]
        assert port["target"] == 2


@pytest.mark.parametrize("pkg", PACKAGES)
def test_manual_scale_rpc_case_in_both_packages(pkg, request):
    run_repointed("test_master_service.py", pkg,
                  "test_manual_scale_rpc_retargets_and_reconciles",
                  request)


def test_manual_scale_over_the_transport():
    """The JAX case over the port's RPC transport: the request reaches
    the auto-scaler, which retargets and reconciles; without one the
    servicer refuses, as the local master does."""
    telemetry.set_default_journal(EventJournal(None))
    run = _setup("dlrover_tpu_torch", nodes=2)
    server, _ = create_master_service(0, job_manager=run.mgr,
                                      auto_scaler=run.auto)
    bare, _ = create_master_service(0)
    server.start()
    bare.start()
    try:
        client = MasterClient(f"localhost:{server.port}", 0, "worker")
        assert client.request_scale(4)
        client.close()
        refused = MasterClient(f"localhost:{bare.port}", 0, "worker")
        assert not refused.request_scale(4)
        refused.close()
    finally:
        server.stop(grace=0.2)
        bare.stop(grace=0.2)
    assert run.monitor._target_worker_num == 4
    assert run.plans == [([(2, 2), (3, 3)], [])]
    assert [e["data"] for e in telemetry.default_journal().events(
        "scale.request")] == [
        {"source": "rpc", "node_num": 4, "accepted": True}]


SPEC = {
    "apiVersion": "dlrover-tpu/v1", "kind": "ElasticTpuJob",
    "metadata": {"name": "llama-pretrain", "namespace": "ml"},
    "spec": {
        "platform": "process", "distributionStrategy": "allreduce",
        "nodeUnit": 2, "relaunchStrategy": "always",
        "heartbeatTimeout": 30,
        "worker": {
            "replicas": 4, "minReplicas": 2, "maxReplicas": 8,
            "maxRelaunchCount": 2, "criticalWorkerIndex": "0:1,3",
            "resource": {"cpu": 96, "memory": "180Gi"},
            "env": {"WANDB_MODE": "offline"},
            "command": ["python", "-m", "train"],
        },
        "evaluator": {"replicas": 1, "command": ["python", "eval.py"],
                      "resource": {"memory": "512Mi"}},
    },
}


@pytest.mark.parametrize("spec", [
    SPEC, {"spec": {"worker": {"replicas": 2}}},
    {"spec": {"worker": {"replicas": 3, "criticalWorkerIndex": "all"}}},
    {"jobName": "flat", "worker": {"replicas": 0, "command": ["x"]}},
], ids=["full", "defaults", "all-critical", "flat"])
@pytest.mark.parametrize("platform", [None, "local"])
def test_job_args_from_dict_match_jax(spec, platform):
    got = dataclasses.asdict(JobArgs.from_dict(spec, platform=platform))
    want = dataclasses.asdict(JaxJobArgs.from_dict(spec, platform=platform))
    assert got == want
    if spec is SPEC:
        assert got["critical_worker_index"] == {0: 1, 3: 2}
        assert got["node_resource"]["memory"] == 180 * 1024


def test_job_args_from_file_reads_json_and_yaml(tmp_path):
    path = tmp_path / "job.json"
    path.write_text(json.dumps(SPEC))
    assert JobArgs.from_file(str(path)) == JobArgs.from_dict(SPEC)
    yaml = pytest.importorskip("yaml")
    ypath = tmp_path / "job.yaml"
    ypath.write_text(yaml.safe_dump(SPEC))
    assert (dataclasses.asdict(JobArgs.from_file(str(ypath)))
            == dataclasses.asdict(JaxJobArgs.from_file(str(ypath))))
