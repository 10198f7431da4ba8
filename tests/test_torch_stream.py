"""The port's streaming source end to end through its launcher, the
mirror of ``tests/test_streaming_e2e.py``: ``examples/stream_train.py``
(``dlrover_tpu_torch/examples/stream_train.py``) consumes the master's
partition-offset shards (``StreamingDatasetSplitter``), once without a
fault and once with a crash that orphans an IN-FLIGHT shard: the
restarted worker gets the orphaned range again exactly once, and the
stream is covered with no gap and no duplicate. Both launches run
together (the module's ``runs`` fixture)."""

import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join("dlrover_tpu_torch", "examples", "stream_train.py")
TOTAL = 2000
BATCH = 100


def _run(tmp, crash_after=0, timeout=120):
    progress = os.path.join(tmp, "progress.txt")
    cmd = [
        sys.executable, "-m", "dlrover_tpu_torch.trainer.elastic_run",
        "--standalone", "--nnodes", "1:1",
        "--max_restarts", "2", "--monitor_interval", "0.3",
        EXAMPLE, "--",
        "--total", str(TOTAL), "--batch-size", str(BATCH),
        "--progress", progress,
    ] + (["--crash-after", str(crash_after)] if crash_after else [])
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DLROVER_TPU_", "DLROVER_FAULT"))}
    # the orphaned in-flight shard is recovered by the master's task
    # timeout watchdog; the default 1800 s would stall the drill
    env.update({"DLROVER_TPU_CTX_TASK_PROCESS_TIMEOUT": "5",
                "OMP_NUM_THREADS": "1"})
    proc = subprocess.run(cmd, cwd=REPO, env=env, timeout=timeout,
                          capture_output=True, text=True)
    return proc, progress


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    dirs = [str(tmp_path_factory.mktemp(f"stream{i}")) for i in range(2)]
    with ThreadPoolExecutor(2) as pool:
        plain = pool.submit(_run, dirs[0])
        crash = pool.submit(_run, dirs[1], 5)
        return {"plain": plain.result(), "crash": crash.result()}


def _rows(progress):
    rows = []
    if os.path.exists(progress):
        for line in open(progress):
            parts = line.strip().split(",")
            if len(parts) == 5:
                rows.append((parts[0], int(parts[1]), int(parts[2]),
                             int(parts[3])))
    return rows


def _assert_exactly_once(rows):
    ranges = sorted((r[1], r[2]) for r in rows)
    prev_end = 0
    for start, end in ranges:
        assert start == prev_end, (
            f"gap/overlap at {start} (prev end {prev_end})")
        prev_end = end
    assert prev_end == TOTAL, (prev_end, TOTAL)


def test_streaming_source_completes(runs):
    proc, progress = runs["plain"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    _assert_exactly_once(_rows(progress))


def test_streaming_crash_resumes_at_right_offset(runs):
    proc, progress = runs["crash"]
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    # the crash really happened with a shard in flight
    m = re.search(r"CRASH holding (\S+):(\d+)-(\d+)", out)
    assert m, out[-3000:]
    orphan = (int(m.group(2)), int(m.group(3)))
    # the master's shard checkpoint (snapshotted by the dying worker
    # over the RPC) tracked that range as doing/todo
    ck = re.search(r"SHARD_CKPT (\{.*\})", out)
    assert ck, out[-3000:]
    doc = json.loads(ck.group(1))
    tracked = [list(x) for x in doc.get("doing", [])] + [
        list(x) for x in doc.get("todo", [])]
    assert list(orphan) in tracked, (orphan, tracked)
    rows = _rows(progress)
    # the restarted incarnation completed the orphaned range -- exactly
    # once, at the right offset
    redelivered = [r for r in rows if (r[1], r[2]) == orphan and r[3] >= 1]
    assert len(redelivered) == 1, (orphan, rows[-8:])
    assert not [r for r in rows if (r[1], r[2]) == orphan and r[3] == 0]
    _assert_exactly_once(rows)
