"""The launcher's drain under the shm feed, on the CPU, and the agent's
repaired group kill on its own (the crash drill is in
``test_torch_shm_drill.py``): a drained worker's coworkers and ring do
not outlive it, and a worker's children in its session group end when
the agent sees the worker exit, even though the worker is gone."""

import os
import signal
import subprocess
import sys
import time

from dlrover_tpu_torch.agent.elastic.training import (
    ElasticLaunchConfig,
    ElasticTrainingAgent,
)
from dlrover_tpu_torch.agent.master_client import LocalMasterClient
from dlrover_tpu_torch.data import shm_ring

from tests.test_torch_shm_drill import (
    _alive,
    _assert_no_coworker_or_ring_left,
    crash_drill,
    shm_launch,
)


def test_preempt_under_the_shm_feed(tmp_path, tmp_path_factory):
    """``preempt@6``: the worker drains (rc 21) and the launcher exits
    21; no coworker and no ring of the worker outlives it. The crash
    drill of test_torch_shm_drill.py runs beside it."""
    crash_drill(tmp_path_factory)
    proc, text, events, _ = shm_launch(
        str(tmp_path), {"DLROVER_FAULT_INJECT": "preempt@6:notice=10",
                        "DLROVER_TPU_PREEMPT_NOTICE_BUDGET": "8"},
        dataset_rows=0)
    assert proc.returncode == 21, text[-4000:]
    assert "INJECTED PREEMPTION at step 6" in proc.stdout
    assert "Worker drained gracefully (rc=21)" in text
    drained = [e for e in events if e["kind"] == "preempt.emergency_ckpt"]
    assert drained and drained[0]["data"]["ok"]
    assert drained[0]["data"]["step"] == 6
    _assert_no_coworker_or_ring_left(events)


def test_kill_workers_ends_the_group_after_its_leader_exited():
    """A worker that forks a child and exits: the agent's monitor sees
    the exit and the child, left in the worker's session group, is gone
    after it reacts; a ring the worker left is unlinked."""
    script = (
        "import os, sys, time\n"
        "fd = os.open('/dev/shm/' + sys.argv[1] + format(os.getpid(), 'x')"
        " + '_test', os.O_CREAT | os.O_RDWR)\n"
        "pid = os.fork()\n"
        "if pid == 0:\n"
        "    time.sleep(120)\n"
        "    os._exit(0)\n"
        "print(pid, flush=True)\n"
        "os._exit(17)\n"
    )
    agent = ElasticTrainingAgent(
        ElasticLaunchConfig(monitor_interval=0.05), LocalMasterClient())
    proc = subprocess.Popen(
        [sys.executable, "-c", script, shm_ring.SEGMENT_PREFIX],
        stdout=subprocess.PIPE, text=True, start_new_session=True)
    agent._procs = [proc]
    child = int(proc.stdout.readline())
    proc.wait(timeout=30)
    leader = proc.pid
    assert _alive(child) and os.getpgid(child) == leader
    assert shm_ring.segments_of(leader)
    t0 = time.monotonic()
    result = agent._monitor_workers()
    assert result.return_code == 17
    assert not _alive(child)
    assert not shm_ring.segments_of(leader)
    assert time.monotonic() - t0 < 10
    try:
        os.kill(child, signal.SIGKILL)
    except ProcessLookupError:
        pass
