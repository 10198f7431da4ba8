"""Several workers per node under the port's launcher: ``--nproc_per_node 2``
starts two workers with ``LOCAL_RANK`` 0 and 1 that form one gloo world
of 2, and when one of them crashes the agent ends both and restarts the
pair; and a rank whose ``LOCAL_RANK`` has no card raises instead of
sharing a card."""

import os
import re
import subprocess
import sys

import pytest
import torch

from dlrover_tpu_torch.trainer import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = """
import os, sys, time
import torch, torch.distributed as dist
from dlrover_tpu_torch.trainer.distributed import init_from_env
env = init_from_env(timeout_s=60, device="cpu")
total = torch.ones(1)
dist.all_reduce(total)
# one write, so that the two workers' lines never interleave (print
# writes the text and its newline apart)
os.write(1, (f"RANK {env.rank} LOCAL {env.local_rank} "
             f"WORLD {env.world_size} RESTART {env.restart_count} "
             f"PID {os.getpid()} SUM {int(total.item())}\\n").encode())
if env.restart_count == 0:
    if env.local_rank == 1:
        os._exit(17)  # the first incarnation's LOCAL_RANK 1 crashes
    time.sleep(60)  # its peer lives on until the agent ends it
dist.destroy_process_group()
"""


def test_two_workers_per_node_form_a_world_and_restart_together(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    journal = tmp_path / "journal.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.trainer.elastic_run",
         "--standalone", "--nnodes", "1:1", "--nproc_per_node", "2",
         "--monitor_interval", "0.2", str(script)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
             "DLROVER_TPU_JOURNAL": str(journal)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = re.findall(
        r"^RANK (\d) LOCAL (\d) WORLD (\d) RESTART (\d) PID (\d+) SUM (\d)$",
        proc.stdout, re.M)
    by_restart = {}
    for rank, local, world, restart, pid, total in lines:
        assert (rank, world, total) == (local, "2", "2")
        by_restart.setdefault(int(restart), {})[int(local)] = int(pid)
    # two incarnations of the pair: the crash of LOCAL_RANK 1 ended its
    # peer too, and both came back
    assert sorted(by_restart) == [0, 1], proc.stdout
    assert all(sorted(pids) == [0, 1] for pids in by_restart.values())
    survivor = by_restart[0][0]
    assert not os.path.exists(f"/proc/{survivor}") or open(
        f"/proc/{survivor}/stat").read().split(") ")[1][0] in "ZX"
    events = [line for line in journal.read_text().splitlines()
              if '"scale.restart"' in line]
    assert len(events) == 1 and '"process_failure"' in events[0]


def test_a_local_rank_without_a_card_raises(monkeypatch):
    """On a host with one card, LOCAL_RANK 1 raises: a second process of
    the host never shares the card unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: pytest.fail(
        f"set_device({i}) on a host with one card"))
    monkeypatch.setenv("DLROVER_TPU_COORDINATOR_ADDR", "localhost:1")
    monkeypatch.setenv("DLROVER_TPU_PROCESS_ID", "0")
    monkeypatch.setenv("DLROVER_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    for backend in (None, "gloo"):
        with pytest.raises(RuntimeError, match="LOCAL_RANK 1 but 1 card"):
            distributed.init_from_env(backend=backend)


def test_collectives_time_out_after_the_heartbeat(monkeypatch):
    monkeypatch.setenv(distributed.ENV_HEARTBEAT_TIMEOUT, "12.5")
    assert distributed.heartbeat_timeout_s() == 12.5
    monkeypatch.delenv(distributed.ENV_HEARTBEAT_TIMEOUT)
    assert distributed.heartbeat_timeout_s() == 45.0  # the JAX default
