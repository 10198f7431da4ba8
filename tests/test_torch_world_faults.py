"""The sentinel's rollback and the preemption drain at world 2: two
launchers (``--nnodes 2:2``) against one master, each supervising one
worker of the Llama example (ddp, replicated state, gloo). Run A trips
the sentinel on node 0 only (``sdc@5:flip=6,host=0``) and preempts node
1 at step 7; run B is the replacement world, with no faults.

* The rollback is agreed (ROADMAP C.1): both ranks restore the same
  step at the same step boundary, run the same steps after it, and hold
  bitwise-equal states at every save after it.
* The drain at world > 1 (ROADMAP C.2): node 1 drains alone; its
  emergency save of step 7 is its owned subset and never commits, node
  0 leaves within the notice window (its next collective fails), and
  with node 1's RAM tier gone with its host the replacement restores
  step 6, the newest step both ranks hold: step 7 is lost. (Were node
  1's RAM tier kept, its whole replicated step 7 would reach node 0
  over the peer tier.)"""

import os
import shutil
import subprocess
import sys
import time

import pytest

from dlrover_tpu_torch.telemetry import read_journal
from dlrover_tpu_torch.trainer.elastic_run import launch_local_master

from tests.test_torch_launcher import EXAMPLE, REPO

NOTICE_S = 20
HEARTBEAT_S = 4


def _run(tmp, journal, faults, steps):
    """Two launchers of one job; returns ([rc], [stdout], [exit time]).
    The sentinel's spike check starts after 4 clean steps: step 5's
    flip has a baseline, and after the rollback (its window cleared) no
    step of run A checks again."""
    master, addr = launch_local_master(node_num=2)
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("DLROVER_TPU_", "DLROVER_FAULT"))}
    base.update({"DLROVER_TPU_JOURNAL": journal,
                 "DLROVER_TPU_DIST_HEARTBEAT_TIMEOUT": str(HEARTBEAT_S),
                 "DLROVER_TPU_SENTINEL_MIN_STEPS": "4",
                 "DLROVER_TPU_PREEMPT_NOTICE_BUDGET": str(NOTICE_S - 5),
                 "OMP_NUM_THREADS": "1"})
    procs = []
    try:
        for rank in range(2):
            env = dict(base)
            if faults[rank]:
                env["DLROVER_FAULT_INJECT"] = faults[rank]
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "dlrover_tpu_torch.trainer.elastic_run",
                 "--master_addr", addr, "--nnodes", "2:2",
                 "--node_rank", str(rank), "--monitor_interval", "0.3",
                 "--max_restarts", "0", EXAMPLE, "--",
                 "--steps", str(steps), "--save-interval", "3",
                 "--persist-interval", "3", "--batch-size", "4",
                 "--seq-len", "32", "--device", "cpu",
                 "--strategy", "ddp", "--dist-backend", "gloo",
                 "--ckpt-dir", os.path.join(tmp, "ckpt"),
                 "--ram-dir", os.path.join(tmp, f"ram{rank}"),
                 "--checksums"],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs, ended = [], []
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
            ended.append(time.time())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        master.terminate()
        master.wait(timeout=30)
    return [p.returncode for p in procs], outs, ended


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("world_faults"))
    journal = os.path.join(tmp, "journal.jsonl")
    a = _run(tmp, journal, ["sdc@5:flip=6,host=0",
                            f"preempt@7:notice={NOTICE_S}"], steps=9)
    events_a = read_journal(journal)
    # the preempted host is reclaimed: its RAM tier goes with it
    shutil.rmtree(os.path.join(tmp, "ram1"))
    b = _run(tmp, journal, [None, None], steps=9)
    events_b = read_journal(journal)[len(events_a):]
    return a, events_a, b, events_b


def _by_rank(events, kind):
    ranks = {e["pid"]: e["data"]["rank"] for e in events
             if e["kind"] == "distributed.init"}
    out = {}
    for e in events:
        if e["kind"] == kind:
            out.setdefault(ranks[e["pid"]], []).append(e["data"])
    return out


def test_rollback_is_agreed_across_ranks(world):
    (rcs, outs, _), events, _, _ = world
    assert "SENTINEL TRIP" in outs[0] and "SENTINEL TRIP" not in outs[1]
    restored = _by_rank(events, "rollback.restored")
    assert [d["step"] for d in restored[0]] == [3], outs[0][-3000:]
    assert [d["step"] for d in restored[1]] == [3], outs[1][-3000:]
    # the same steps on both ranks, in the same order, after the rollback
    steps = {r: [d["step"] for d in v]
             for r, v in _by_rank(events, "train.step").items()}
    assert steps[0][:5] == steps[1][:5] == [1, 2, 3, 4, 5]
    after = {r: s[5:] for r, s in steps.items()}
    assert after[0][:3] == after[1][:3] == [4, 5, 6]
    losses = {r: {d["step"]: d["loss"] for d in v[5:]}
              for r, v in _by_rank(events, "train.step").items()}
    assert {k: losses[0][k] for k in (4, 5, 6)} == {
        k: losses[1][k] for k in (4, 5, 6)}
    # bitwise-equal replicated states at the save after the rollback
    sums = _by_rank(events, "train.checksums")
    at6 = [[d["sums"] for d in sums[r] if d["step"] == 6] for r in (0, 1)]
    assert len(at6[0]) == len(at6[1]) == 1 and at6[0] == at6[1]


def test_drain_of_one_rank_loses_its_emergency_step(world):
    (rcs, outs, ended), events, (rcs_b, outs_b, _), events_b = world
    assert rcs[1] == 21, outs[1][-3000:]  # drained gracefully
    assert rcs[0] != 0  # its peer gone, the survivor's collective failed
    drained = [e for e in events if e["kind"] == "preempt.emergency_ckpt"]
    assert [e["data"]["step"] for e in drained] == [7]
    assert not any(e["kind"] == "ckpt.manifest_committed"
                   and e["data"]["step"] == 7 for e in events)
    notice = next(e["ts"] for e in events if e["kind"] == "preempt.notice")
    # no rank waits past the notice window
    assert max(ended) - notice < NOTICE_S, (max(ended) - notice)
    # the replacement restores the newest step both ranks hold
    assert rcs_b == [0, 0], outs_b[0][-3000:]
    for out in outs_b:
        assert "RESTORED from step 6" in out and "FINAL step=9" in out
