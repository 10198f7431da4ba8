"""The port's ``ProcessScaler`` with real child processes: the three
cases of ``tests/test_process_scaler.py`` (launch -> succeed, crash ->
relaunch until the budget is spent, SIGTERM -> KILLED -> relaunch),
re-pointed at the port as ``test_torch_control_plane.load_repointed``
does, with tiny ``python -c`` workers; and the env contract a launched
worker sees."""

import json
import os
import sys
import time

import pytest

from dlrover_tpu_torch.common.constants import NodeEnv, NodeType
from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.master.scaler.base_scaler import ScalePlan
from dlrover_tpu_torch.master.scaler.process_scaler import ProcessScaler

from tests.test_torch_control_plane import run_repointed


@pytest.mark.parametrize("name", [
    "test_successful_job_lifecycle",
    "test_crash_relaunch_until_exhausted",
    "test_sigterm_maps_to_killed_and_relaunches",
])
def test_jax_case_in_the_port(name, request):
    run_repointed("test_process_scaler.py", "dlrover_tpu_torch", name,
                  request)


def test_a_launched_worker_gets_the_env_contract(tmp_path):
    out = tmp_path / "env.json"
    keys = [NodeEnv.MASTER_ADDR, NodeEnv.NODE_TYPE, NodeEnv.NODE_ID,
            NodeEnv.NODE_RANK, NodeEnv.RESTART_COUNT, "SPEC_ENV"]
    code = (f"import json, os; json.dump({{k: os.environ.get(k) for k in "
            f"{keys!r}}}, open({str(out)!r}, 'w'))")
    scaler = ProcessScaler("env-job", "localhost:1234",
                           command=[sys.executable, "-c", code],
                           env={"SPEC_ENV": "x"})
    try:
        node = Node(NodeType.WORKER, 5, rank_index=2, relaunch_count=1)
        scaler.scale(ScalePlan(launch_nodes=[node]))
        events = []
        deadline = time.time() + 30
        while time.time() < deadline and len(events) < 2:
            events.append(next(scaler.watcher.watch()))
    finally:
        scaler.stop()
    assert [e.node.status for e in events] == ["running", "succeeded"]
    assert json.loads(out.read_text()) == {
        NodeEnv.MASTER_ADDR: "localhost:1234", NodeEnv.NODE_TYPE: "worker",
        NodeEnv.NODE_ID: "5", NodeEnv.NODE_RANK: "2",
        NodeEnv.RESTART_COUNT: "1", "SPEC_ENV": "x"}
