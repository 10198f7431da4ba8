"""The port's elastic launcher on the CPU, continued: the hang drill
(the step-progress detector reports a stall, the master answers the
agent's heartbeat with a restart) and two agents of one job over one
master, whose workers form a two-rank ``torch.distributed`` group."""

import os
import subprocess
import sys

from dlrover_tpu_torch.trainer.elastic_run import launch_local_master

from tests.test_torch_launcher import REPO, launch, step_losses

PROBE = """\
import torch
import torch.distributed as dist

from dlrover_tpu_torch.trainer.distributed import init_from_env

env = init_from_env(device="cpu")
total = torch.tensor([env.rank])
dist.all_reduce(total)
print(f"PROBE rank {env.rank} world {dist.get_world_size()} "
      f"sum {int(total)}", flush=True)
dist.destroy_process_group()
"""


def test_hang_drill_restarts_on_the_masters_action(tmp_path):
    """``hang@8``: step 8 never finishes its report; after 3 s without a
    step the detector reports a HANG, the master's next heartbeat reply
    is a restart, the agent recycles the worker (no restart budget
    spent) and the new one resumes from step 5 and finishes."""
    proc, text, fields = launch(
        str(tmp_path), flags=("--heartbeat_interval", "0.5"),
        env={"DLROVER_FAULT_INJECT": "hang@8",
             "DLROVER_HANG_MIN_TIMEOUT": "3"})
    assert proc.returncode == 0, text[-3000:]
    assert "INJECTED HANG at step 8" in proc.stdout
    assert "Training hang: no step since step 8" in text
    assert "Restarting workers on master action" in text
    assert "RESTORED from step 5" in proc.stdout
    assert "FINAL step=12" in proc.stdout
    assert int(fields[0]) == 12 and int(fields[2]) == 5
    first, second = step_losses(proc.stdout)
    assert max(first) == 7 and sorted(second) == list(range(6, 13))
    assert {k: second[k] for k in (6, 7)} == {k: first[k] for k in (6, 7)}


def test_two_agents_form_one_process_group(tmp_path):
    """``--nnodes 2:2``: two launchers (node ranks 0 and 1) against one
    master rendezvous, elect a coordinator over the KV store and start
    one worker each; the workers meet in a gloo group of two and
    all-reduce their ranks."""
    probe = tmp_path / "probe.py"
    probe.write_text(PROBE)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DLROVER_TPU_")}
    master, addr = launch_local_master(node_num=2)
    agents = []
    try:
        agents += [
            subprocess.Popen(
                [sys.executable, "-m",
                 "dlrover_tpu_torch.trainer.elastic_run",
                 "--nnodes", "2:2", "--node_rank", str(rank),
                 "--master_addr", addr, "--monitor_interval", "0.3",
                 "--max_restarts", "0", str(probe)],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            for rank in (0, 1)
        ]
        outs = [a.communicate(timeout=120)[0] for a in agents]
    finally:
        for a in agents:
            if a.poll() is None:
                a.kill()
        master.terminate()
        master.wait(timeout=30)
    for rank, (agent, out) in enumerate(zip(agents, outs)):
        assert agent.returncode == 0, out[-3000:]
        assert f"PROBE rank {rank} world 2 sum 1" in out, out[-3000:]
        assert "world={0: 1, 1: 1}" in out
