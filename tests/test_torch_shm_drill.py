"""The launcher's crash drill under the shm feed, on the CPU: the Llama
example with ``--num-workers 2`` (two coworker processes per worker)
through ``python -m dlrover_tpu_torch.trainer.elastic_run --standalone``
(the drain and the agent's group kill alone are in
``test_torch_shm_drain_drill.py``).

Under a crash the dead worker's coworkers must be gone before its
successor starts, and its ring must not stay in ``/dev/shm``; the
samples the crash skips are counted (a producer acks a shard once it is
in the ring, so what was in flight is not trained again) and held to
their bound; no sample is trained twice."""

import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from dlrover_tpu_torch.data import shm_ring
from dlrover_tpu_torch.telemetry import read_journal

from tests.test_torch_launcher import EXAMPLE, REPO, step_losses

BATCH, WORKERS = 4, 2
#: the ring's slots (ShmDataLoader's default), DevicePrefetch's depth
#: and the producers' shard lookahead (ShardingClient's default 0), as
#: the example runs them
NUM_SLOTS, DEPTH, LOOKAHEAD = 8, 2, 0
#: batches a crash can skip: the one of the step the crash ended (its
#: update ran, but the step never reported), those in the ring, in the
#: prefetch queue and in the fill thread's hands (acked at push, never
#: trained), and per coworker the shards it has fetched but not pushed,
#: which the master requeues to the successor's coworkers and which may
#: come back after a later shard
SKIP_BOUND = (1 + NUM_SLOTS + DEPTH + 1 + WORKERS * (1 + LOOKAHEAD)) * BATCH


class _ProcWatch:
    """Samples, every 20 ms, the processes whose environment names
    ``journal``: pid -> [first seen, last seen] (``time.time``)."""

    def __init__(self, journal: str):
        self._tag = f"DLROVER_TPU_JOURNAL={journal}".encode()
        self.seen = {}
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._done.is_set():
            now = time.time()
            for entry in os.listdir("/proc"):
                if not entry.isdigit():
                    continue
                try:
                    with open(f"/proc/{entry}/environ", "rb") as f:
                        if self._tag not in f.read().split(b"\0"):
                            continue
                    with open(f"/proc/{entry}/stat") as f:
                        if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                            continue
                except OSError:
                    continue
                span = self.seen.setdefault(int(entry), [now, now])
                span[1] = now
            self._done.wait(0.02)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._done.set()
        self._thread.join(timeout=10)


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def shm_launch(tmp, env, steps=12, save_interval=5, dataset_rows=256):
    """The launcher around the example on the shm feed, the journal on;
    returns (process, stdout + stderr, journal events, the watch)."""
    journal = os.path.join(tmp, "journal.jsonl")
    cmd = [
        sys.executable, "-m", "dlrover_tpu_torch.trainer.elastic_run",
        "--standalone", "--nnodes", "1:1", "--monitor_interval", "0.3",
        "--max_restarts", "2", EXAMPLE, "--",
        "--steps", str(steps), "--save-interval", str(save_interval),
        "--batch-size", str(BATCH), "--seq-len", "32", "--device", "cpu",
        "--num-workers", str(WORKERS), "--dataset-rows", str(dataset_rows),
        "--ckpt-dir", os.path.join(tmp, "ckpt"),
    ]
    full_env = {k: v for k, v in os.environ.items()
                if not k.startswith(("DLROVER_TPU_", "DLROVER_FAULT"))}
    full_env.update(env, DLROVER_TPU_JOURNAL=journal, OMP_NUM_THREADS="1")
    with _ProcWatch(journal) as watch:
        proc = subprocess.run(cmd, cwd=REPO, env=full_env, timeout=150,
                              capture_output=True, text=True)
    events = read_journal(journal) if os.path.exists(journal) else []
    return proc, proc.stdout + proc.stderr, events, watch


def _by_worker(events, kind):
    out = {}
    for e in events:
        if e["kind"] == kind:
            out.setdefault(e["pid"], []).append(e["data"])
    return out


def _assert_no_coworker_or_ring_left(events):
    coworkers = [p for d in _by_worker(events, "data.coworkers").values()
                 for p in d[0]["pids"]]
    assert coworkers and not [p for p in coworkers if _alive(p)]
    workers = _by_worker(events, "train.model_ready")
    assert not [n for w in workers for n in shm_ring.segments_of(w)]


#: the crash drill's launch: started by whichever of this module and
#: test_torch_shm_drain_drill.py runs first, so that it runs beside the
#: drain drill's launch
_CRASH = {}


def crash_drill(tmp_path_factory):
    """The crash drill's launch, started in the background once: its
    future of (directory, shm_launch's result)."""
    if "future" not in _CRASH:
        tmp = tmp_path_factory.mktemp("shm_crash")
        pool = ThreadPoolExecutor(1)
        _CRASH["future"] = pool.submit(lambda: (tmp, shm_launch(
            str(tmp), {"DLROVER_FAULT_INJECT": "crash@8"})))
        pool.shutdown(wait=False)
    return _CRASH["future"]


def test_crash_under_the_shm_feed(tmp_path_factory):
    """``crash@8`` with two coworkers: the agent ends the dead worker's
    coworkers and unlinks its ring before the successor spawns; the
    successor restores step 5 (model and optimizer; the ledger is not
    rewound) and trains to step 12 on shards it had not been given."""
    _, (proc, text, events, watch) = crash_drill(tmp_path_factory).result(
        timeout=300)
    assert proc.returncode == 0, text[-4000:]
    assert "INJECTED CRASH rc=17 at step 8" in proc.stdout
    assert "RESTORED from step 5" in proc.stdout
    assert "FINAL step=12" in proc.stdout
    first, second = step_losses(proc.stdout)
    # step 8 trained, then crashed in its report, before its print
    assert sorted(first) == list(range(1, 8))
    assert sorted(second) == list(range(6, 13))

    # the coworkers of the first worker, gone before the second started
    ready = _by_worker(events, "train.model_ready")
    coworkers = _by_worker(events, "data.coworkers")
    assert len(ready) == len(coworkers) == 2
    (w1, w2) = sorted(ready, key=lambda pid: watch.seen[pid][0])
    assert watch.seen[w2][0] > max(watch.seen[w1][1], *[
        watch.seen[p][1] for p in coworkers[w1][0]["pids"]])
    assert all(p in watch.seen for p in coworkers[w1][0]["pids"])
    _assert_no_coworker_or_ring_left(events)

    # the samples: none trained twice, and the skipped ones bounded
    steps = _by_worker(events, "train.step")
    rows = [(d["step"], tuple(d["rows"])) for w in (w1, w2)
            for d in steps[w]]
    trained = [r for _, (a, b) in rows for r in range(a, b)]
    assert len(trained) == len(set(trained)) == 14 * BATCH
    top = max(trained) + 1
    skipped = sorted(set(range(top)) - set(trained))
    assert 0 < len(skipped) <= SKIP_BOUND, (skipped, rows)
    # and the steps after the restored one that the first worker
    # reported (6-7) count in the model no more: the restore voided them
    voided = [r for s, (a, b) in rows[:7] if s > 5 for r in range(a, b)]
    assert len(voided) == 2 * BATCH
    print(f"SHM CRASH skipped {len(skipped)} samples in flight "
          f"(bound {SKIP_BOUND}), voided {len(voided)} by the restore")
