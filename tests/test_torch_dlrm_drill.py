"""The DLRM example under the port's launcher on the CPU: ``crash@12``
kills the worker after step 12, the agent restarts it, it restores the
durable step-10 save (model and Adagrad state) and trains to step 14.
At ``--nproc_per_node 2`` the two workers train "rowwise" on ``(data 1,
fsdp 2)``: both step the same batches (the lowest rank fetches the
master's shards and hands their indices on), each saves its own half of
the tables, both crash and restore step 10. The module's two launches
run together."""

import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from dlrover_tpu_torch.models import dlrm
from dlrover_tpu_torch.trainer import ckpt_store

from tests.test_torch_launcher import REPO, step_losses

EXAMPLE = os.path.join(REPO, "dlrover_tpu_torch", "examples", "dlrm_train.py")


def _launch(tmp, nproc):
    out = str(tmp / "out.txt")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DLROVER_TPU_", "DLROVER_FAULT"))}
    env.update(DLROVER_FAULT_INJECT="crash@12", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.trainer.elastic_run",
         "--standalone", "--nnodes", "1:1", "--monitor_interval", "0.3",
         "--max_restarts", "2", "--nproc_per_node", str(nproc), EXAMPLE,
         "--", "--steps", "14", "--device", "cpu", "--ckpt-dir",
         str(tmp / "ckpt"), "--out", out],
        cwd=REPO, env=env, timeout=120, capture_output=True, text=True)
    return proc, out, tmp


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """{nproc: (the launcher's process, its out file, its directory)},
    the two launches run together."""
    dirs = {n: tmp_path_factory.mktemp(f"dlrm{n}") for n in (1, 2)}
    with ThreadPoolExecutor(2) as pool:
        return dict(zip((1, 2), pool.map(
            lambda n: _launch(dirs[n], n), (1, 2))))


def test_crash_drill_restores_step_10(launches):
    proc, out, _ = launches[1]
    text = proc.stdout + proc.stderr
    assert proc.returncode == 0, text[-3000:]
    assert "INJECTED CRASH rc=17 at step 12" in proc.stdout
    assert "RESTORED from step 10" in proc.stdout
    assert "FINAL step=14" in proc.stdout
    first, second = step_losses(proc.stdout)
    # the crash fires inside step 12's report, before its line
    assert max(first) == 11 and sorted(second) == [11, 12, 13, 14]
    step, loss, acc, start = open(out).read().split(",")
    assert (int(step), int(start)) == (14, 10)
    assert 0 < float(loss) < 1 and 0 <= float(acc) <= 1


def test_two_ranks_step_the_same_batches_and_restore_their_rows(launches):
    proc, out, tmp = launches[2]
    text = proc.stdout + proc.stderr
    assert proc.returncode == 0, text[-3000:]
    assert proc.stdout.count("INJECTED CRASH rc=17 at step 12") == 2
    assert proc.stdout.count("RESTORED from step 10") == 2
    assert proc.stdout.count("FINAL step=14") == 2
    # both ranks print each step's loss, the same to the last digit:
    # they stepped the same rows
    lines = re.findall(r"^step (\d+) loss (\S+)$", proc.stdout, re.M)
    by_step = {}
    for k, x in lines:
        by_step.setdefault(int(k), []).append(x)
    assert sorted(by_step) == list(range(1, 15))
    for k, xs in by_step.items():
        # steps 11 ran in both incarnations (the crash is after step 11)
        assert len(xs) == (4 if k == 11 else 2) and len(set(xs[:2])) == 1
    step, loss, acc, start = open(out).read().split(",")
    assert (int(step), int(start)) == (14, 10)
    # the final save: each rank persisted its own half of the tables
    cfg = dlrm.criteo_wide_deep()
    half = cfg.padded_vocab // 2
    store = ckpt_store.get_store(str(tmp / "ckpt" / "persist"))
    (saved,) = ckpt_store.committed_steps(store)
    leaves = {"/".join(str(c.get("k", c.get("i"))) for c in e["path"]): e
              for e in ckpt_store.step_manifest(store, saved)["leaves"]}
    for key in ("model/table", "model/wide",
                "optimizer/sum_of_squares/table"):
        assert [(d["idx"][0], d["replicas"]) for d in
                leaves[key]["domains"]] == [([0, half], [0]),
                                            ([half, 2 * half], [1])], key
    assert leaves["model/bottom/0/w"]["domains"][0]["replicas"] == [0, 1]
    assert leaves["model/head/b"]["shape"] == [1]
