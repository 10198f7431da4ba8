"""The card's constants of the strategy search, measured on the card.

    python -m dlrover_tpu_torch.auto.probe [--seqs 16384 32768 65536]

Prints one JSON line with the card's name and power limit and:

* ``envelope``: one llama_1b train step (batch 1, remat "dots", AdamW,
  the flash kernels) at each sequence of ``--seqs``, in turn, stopping
  at the first that does not fit: its peak ``max_memory_allocated``, or
  the out-of-memory error. ``max_seq`` is the longest whose peak stays
  under 0.9 x the card's memory, ``auto/strategy.py``'s
  ``SINGLE_CHIP_MAX_SEQ``;
* ``collective_latency_s``: the median seconds of one small all-reduce
  (4 bytes, on the card) between two gloo ranks on ``cuda:0`` -- the
  collective path the port takes with two ranks on one card --
  ``auto/planner.py``'s ``_COLLECTIVE_LATENCY``; the p10 and p90 beside
  it, and a 1 MiB all-reduce's median for scale.
"""

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time

#: all-reduces timed after the warm-up ones, per size
LATENCY_REPS = 200
LATENCY_WARMUP = 20


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except OSError:
        return ""


def envelope(seqs) -> dict:
    """One llama_1b step at each sequence of ``seqs`` until one does not
    fit under 0.9 x the card's memory."""
    import dataclasses

    import numpy as np
    import torch

    from dlrover_tpu_torch.auto.device_context import hbm_bytes_per_chip
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.trainer.sharded import (
        adamw, make_trainer_for_llama)

    hbm = hbm_bytes_per_chip()
    runs, best = [], None
    for seq in seqs:
        cfg = dataclasses.replace(llama.llama_1b(remat="dots"),
                                  max_seq_len=seq)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run = {"seq": seq}
        t0 = time.perf_counter()
        try:
            t = make_trainer_for_llama(cfg, optimizer=adamw(1e-4))
            t.init(seed=0)
            x = np.random.default_rng(0).integers(
                0, cfg.vocab_size, (1, seq + 1))
            loss = t.train_step(t.shard_batch(t.microbatch(
                (x[:, :-1], x[:, 1:])))).item()
            torch.cuda.synchronize()
            run.update(loss=loss,
                       peak_bytes=torch.cuda.max_memory_allocated(),
                       step_s=time.perf_counter() - t0)
            run["fits"] = run["peak_bytes"] < 0.9 * hbm
        except torch.cuda.OutOfMemoryError as e:
            run.update(fits=False, error=str(e).splitlines()[0][:200])
        t = None
        torch.cuda.empty_cache()
        runs.append(run)
        if not run["fits"]:
            break
        best = seq
    return {"runs": runs, "max_seq": best, "hbm_bytes": hbm}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def latency_rank(port: int, rank: int) -> None:
    """One of the two ranks of :func:`latency` (``--rank``)."""
    import datetime

    import torch
    import torch.distributed as dist

    store = dist.TCPStore("localhost", port, 2, is_master=rank == 0,
                          timeout=datetime.timedelta(seconds=60))
    dist.init_process_group("gloo", store=store, world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    out = {}
    for label, n in (("4B", 1), ("1MiB", 2 ** 18)):
        x = torch.ones(n, dtype=torch.float32, device="cuda:0")
        times = []
        for i in range(LATENCY_WARMUP + LATENCY_REPS):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            dist.all_reduce(x)
            torch.cuda.synchronize()
            if i >= LATENCY_WARMUP:
                times.append(time.perf_counter() - t0)
        times.sort()
        out[label] = {"median_s": statistics.median(times),
                      "p10_s": times[len(times) // 10],
                      "p90_s": times[9 * len(times) // 10]}
    if rank == 0:
        print("LATENCY " + json.dumps(out), flush=True)
    dist.destroy_process_group()


def latency() -> dict:
    """Two gloo ranks on ``cuda:0``: the all-reduce's seconds."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dlrover_tpu_torch.auto.probe", "--rank",
         str(r), "--port", str(port)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for line in logs[0].splitlines():
        if line.startswith("LATENCY "):
            return json.loads(line[len("LATENCY "):])
    raise RuntimeError("latency ranks failed: " + logs[0][-2000:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seqs", type=int, nargs="+",
                    default=[16384, 32768, 65536])
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    if args.rank is not None:
        latency_rank(args.port, args.rank)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    lat = latency()
    out = {"card": _smi(), "envelope": envelope(args.seqs),
           "collective_latency_s": lat["4B"]["median_s"],
           "all_reduce": lat}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
