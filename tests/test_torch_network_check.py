"""The port's pre-flight network check: two nodes' NetworkCheckElasticAgents
against one master service run both rounds of the torch probe (a matmul
and a gloo all-gather in each group) and pass; of four nodes, the one
whose probe ``DLROVER_TPU_PROBE_DELAY`` holds back is localized as the
straggler by the master's two-round intersection (their probe is the
script's drill hook alone, so that the rounds take the delay and not
four torch imports); a probe that cannot use its device fails, and a
node whose probe fails reports BREAKDOWN and its launch ends with rc 1;
a replacement node skips the check."""

import contextlib
import os
import re
import subprocess
import sys
import threading

import pytest

from dlrover_tpu_torch import telemetry as T
from dlrover_tpu_torch.agent.elastic import network_check
from dlrover_tpu_torch.agent.elastic.training import (
    ElasticLaunchConfig,
    WorkerState,
    launch_agent,
)
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.constants import NodeStatus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the held-back node of four and its delay: many times the hook-only
#: probe's start (well under a second here), so that its groups read
#: slow in both rounds
SLOW, DELAY_S = 3, 1.5
#: a probe that is the drill hook alone
HOOK_ONLY = network_check._DELAY_HOOK + 'print("NETWORK_CHECK_OK")\n'


@contextlib.contextmanager
def _master(nodes):
    proc = subprocess.Popen(
        [sys.executable, "-m", "dlrover_tpu_torch.master.main", "--port",
         "0", "--node_num", str(nodes)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, env={**os.environ, "PYTHONPATH": REPO})
    try:
        port = None
        for _ in range(50):
            m = re.match(r"DLROVER_TPU_MASTER_PORT=(\d+)",
                         proc.stdout.readline())
            if m:
                port = int(m.group(1))
                break
        assert port, "the master did not report its port"
        yield f"localhost:{port}"
    finally:
        proc.kill()
        proc.wait(timeout=30)


@pytest.fixture(autouse=True)
def fresh_telemetry():
    T.set_default_journal(T.EventJournal(None))
    yield
    T.set_default_journal(T.EventJournal(None))


def _run_agents(master, nodes):
    """Every node's check in a thread of its own: {node: passed}."""
    ok = {}

    def run(rank):
        client = MasterClient(master, node_id=rank, node_type="worker")
        config = ElasticLaunchConfig(min_nodes=nodes, max_nodes=nodes,
                                     node_rank=rank, rdzv_timeout=30)
        ok[rank] = network_check.NetworkCheckElasticAgent(
            config, client, probe_timeout=60).run()

    threads = [threading.Thread(target=run, args=(r,))
               for r in range(nodes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return ok


def _rounds():
    return [e["data"] for e in T.default_journal().events(
        "network_check.round")]


def test_two_nodes_pass_both_rounds_of_the_torch_probe(monkeypatch):
    monkeypatch.setenv(network_check.ENV_PROBE_DEVICE, "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the probes run together
    with _master(2) as master:
        assert _run_agents(master, 2) == {0: True, 1: True}
        client = MasterClient(master, node_id=0, node_type="worker")
        assert client.network_check_success() == (True, "")
        assert client.get_fault_nodes() == []
    rounds = _rounds()
    assert sorted((d["node_rank"], d["round"]) for d in rounds) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(d["normal"] and d["success"] and d["group"] == [0, 1]
               for d in rounds)


def test_four_nodes_pass_and_the_delayed_one_is_the_straggler(monkeypatch):
    monkeypatch.setattr(network_check, "_PROBE_SCRIPT", HOOK_ONLY)
    monkeypatch.setenv("DLROVER_TPU_PROBE_DELAY", f"{SLOW}:{DELAY_S}")
    with _master(4) as master:
        assert _run_agents(master, 4) == {r: True for r in range(4)}
        client = MasterClient(master, node_id=0, node_type="worker")
        assert client.network_check_success() == (True, "")
        assert client.get_fault_nodes() == []
        assert client.get_straggler_nodes() == [SLOW]
    rounds = _rounds()
    assert sorted((d["node_rank"], d["round"]) for d in rounds) == [
        (r, i) for r in range(4) for i in range(2)]
    assert all(d["normal"] and d["success"] for d in rounds)
    # round 0 pairs neighbours; round 1 re-pairs the slow group's members
    # with known-good partners
    assert {tuple(d["group"]) for d in rounds if d["round"] == 0} == {
        (0, 1), (2, 3)}
    assert {tuple(d["group"]) for d in rounds if d["round"] == 1} == {
        (0, 2), (1, 3)}


def test_the_probe_fails_on_a_device_it_cannot_use(monkeypatch):
    """No card here, and none asked for the CPU: the torch probe's
    matmul cannot run, so its round fails."""
    monkeypatch.setenv(network_check.ENV_PROBE_DEVICE, "cuda:7")
    agent = network_check.NetworkCheckElasticAgent(
        ElasticLaunchConfig(), None, probe_timeout=60)
    assert agent._run_probe("localhost:1", 0, 1) is False


def test_a_failing_probe_reports_breakdown(monkeypatch):
    """One node whose probe fails (exits 1): both rounds fail, the node
    reports BREAKDOWN and the launch returns rc 1 without starting a
    worker."""
    monkeypatch.setattr(network_check, "_PROBE_SCRIPT",
                        network_check._DELAY_HOOK + "raise SystemExit(1)\n")
    monkeypatch.delenv("DLROVER_TPU_RESTART_COUNT", raising=False)
    from dlrover_tpu_torch.agent.master_client import LocalMasterClient

    class Master(LocalMasterClient):
        statuses = []

        def report_rdzv_params(self, *a):
            pass

        def join_rendezvous(self, node_rank, local_world_size, name):
            return 1

        def get_comm_world(self, name, node_rank):
            return 1, 0, {0: 1}

        def report_node_check_status(self, rdzv_round, normal, elapsed):
            self.normal = normal

        def network_check_success(self):
            return False, "node_failure"

        def get_fault_nodes(self):
            return [0] if not self.normal else []

        def update_node_status(self, status, reason="", restart_count=0):
            self.statuses.append((status, reason))

    master = Master()
    config = ElasticLaunchConfig(network_check=True, entrypoint="true")
    result = launch_agent(config, master)
    assert (result.state, result.return_code) == (WorkerState.FAILED, 1)
    assert master.statuses == [(NodeStatus.BREAKDOWN, "network check failed")]


def test_a_replacement_node_skips_the_check(monkeypatch):
    """A relaunched node (restart count above 0) joining a running job
    starts its agent without the check: the survivors, who passed it,
    never join a check rendezvous again."""
    from dlrover_tpu_torch.agent.elastic import training
    from dlrover_tpu_torch.agent.master_client import LocalMasterClient

    monkeypatch.setenv("DLROVER_TPU_RESTART_COUNT", "1")
    monkeypatch.setattr(
        network_check.NetworkCheckElasticAgent, "run",
        lambda self: pytest.fail("a replacement node ran the check"))
    started = []

    class Agent:
        def __init__(self, config, client):
            started.append(config.node_rank)

        def run(self):
            return training.RunResult(WorkerState.SUCCEEDED)

    monkeypatch.setattr(training, "ElasticTrainingAgent", Agent)
    result = launch_agent(ElasticLaunchConfig(network_check=True),
                          LocalMasterClient())
    assert result.state == WorkerState.SUCCEEDED and started == [0]
