#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``dlrover_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: the three flash-attention kernels from ``ops/cuda/csrc``, with
   each kernel's registers, spills and dynamic shared memory;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the Llama-1.1B train step's attention shape (GQA group 8), at
   GPT-2 XL's (25 heads over 25 kv heads, group 1) and at one small
   non-causal shape, element by element; planted faults that the same
   rule must reject; each kernel launched twice at the two train steps'
   shapes, which must give the same bits; times there beside the
   kernel's bound and PyTorch's own ``scaled_dot_product_attention`` as
   a yardstick;
4. slice: the Llama-1.1B (TinyLlama shape, 22 layers) train step,
   batch 3 x 2048, through ``make_trainer_for_llama`` on the card --
   launch counts, step time, tokens/s, MFU, peak memory -- and the
   model's hidden states and loss through the kernels against
   ``mha_reference``, with a wrong attention that must fail the gate;
   the step profile (``trainer/profiler.py``: its FLOPs, a floor that
   leaves out the flash kernels, give HFU beside MFU), which must leave
   the training state, the generators and the launch counts bitwise as
   they were, and one sample of the resource monitor's device probe,
   which must equal ``torch.cuda``'s own counters;
5. profile: torch.profiler over two more train steps -- device time by
   kernel group, the top kernels and the device's idle share;
6. data: the shm data plane feeding the same trainer. Block A is
   ``bench.py --data shm``'s path: ``ShmDataLoader`` with two coworker
   processes making seeded batches, ``DevicePrefetch(depth=2)`` on a
   copy stream whose transform reshapes into microbatches and casts the
   int32 tokens to int64; 2 warm-up steps, then steps in turns of 4 fed
   in memory and from the ring, with their step times, the train
   thread's wait in ``next()`` and the fill thread's ``data.fetch`` and
   ``data.stage`` spans, and the producers' start; then a transform
   that raises at the third batch, which must raise in the loop. Block
   B is ``ElasticShmDataLoader`` on a local master service: two
   coworkers, 24 rows in shards of 3, 8 steps. Gates: every batch a
   step used, copied on the card before and after the step, equals the
   tokens its producer made; each batch once (block B's rows cover
   range(24) once); finite losses and 22 launches of each kernel per
   step; no coworker loads libcuda or torch and no second process holds
   a CUDA context; no ring left in ``/dev/shm``;
7. elastic: the elastic loop at the same width -- the master's data
   shards through a ShardingClient, ElasticTrainer steps, flash
   checkpoints at steps 4 and 8 -- then a crash, a fresh trainer
   restored from step 4 on the RAM tier (model, optimizer and data
   position), steps 5-8 again, and a restore from the persist tier:
   state checksums, shards and losses against the uninterrupted run,
   stall, staging, serialize, persist and restore times;
8. eval: the checkpoint evaluator -- a llama_1b state trains 4 steps; at
   steps 2 and 4 its held-out loss (a 3 x 2048 batch from seed 9999) is
   computed directly and the state saved durably; a
   ``CheckpointEvaluator`` restores each step into a fresh model,
   evaluates it through the flash forward and reports it over RPC, as
   an evaluator node, into a master service's job metric collector.
   Gates: steps [2, 4] evaluated once each, each loss bitwise the direct
   one, 22 forward launches and no backward launch per evaluation, the
   collector holding step 4 and its loss; restore seconds, forward ms
   and save-to-report seconds are printed;
9. families: the other model families. GPT-2 XL (48 layers, hidden
   1600, 25 heads, vocab 50257, tied head) trains at batch 8 x 1024
   through ``make_trainer_for`` under AdamW, 2 warm-up and 5 timed
   steps: step time, tokens/s, MFU, peak memory, 48 launches of each
   kernel per step, and its hidden states and loss through the kernels
   against ``mha_reference`` (a wrong attention must fail); two more
   steps profiled as in phase 5. ``bench.py
   --model dlrm``'s path: criteo_wide_deep (a 734,208-row table) at
   batch 4096 under adagrad(0.05), bench.py's fields, its first 3 steps
   against the port's on the CPU. The MNIST CNN at batch 64, 5
   adam(1e-3) steps against the CPU's, under torch's TF32 defaults;
10. launch: the same llama_1b loop as a user runs it, under the elastic
   launcher (``python -m dlrover_tpu_torch.trainer.elastic_run
   --standalone``: the local master, the agent and the worker in
   processes of their own) with ``DLROVER_FAULT_INJECT=crash@10``: the
   worker dies after step 10, the agent restarts it, it restores the
   newest checkpoint committed before the crash and trains to step 12;
   the launcher's exit, the restore, the worker's card and the losses of
   the steps both incarnations ran (bitwise) are checked, and the
   journal's timestamps give the recovery and its parts. The job's
   account: the master's ``/goodput`` on a pinned port, polled while the
   launch runs, must answer and see two incarnations of node 0; the
   journal's offline replay (``telemetry.goodput.reconstruct``) must
   attribute at least 95% of each process's time, sum each process's
   phases to its elapsed time within 1%, recover the crash's fault
   window and book the gap after the crash as ``restart``; goodput %,
   badput by cause and MTTR of both are printed beside ``recovery_s``;
11. drain: two launches of the same loop on one checkpoint directory.
    Launch A is preempted (``preempt@6:notice=30``, a 25 s drain budget):
    the worker drains at the end of step 6 -- the master told, a durable
    emergency save of step 6 on the persist tier, its shards handed back
    -- and exits 21, which the agent reports as PREEMPTED without a
    restart, so the launcher exits 21. The RAM tier is deleted, as a
    reclaimed host's tmpfs would be. Launch B, the replacement, restores
    step 6 from the persist tier, trips the sentinel on ``nan@10``, rolls
    back to step 8 on the master's order, replays step 9 (bitwise) and
    ends at step 12. The drain's final goodput snapshot must be sent
    (``preempt.drained``), the SIGTERM must leave one flight record, the
    drain must fit its budget, and the replay of both launches must book
    ``preempt`` and ``rollback`` badput and recover the rollback's
    window;
12. the kernels line (one JSON object; each kernel at both train steps'
    shapes), then the card's name and power limit, then the device
    line, last.

Exits non-zero, and prints no result, when there is no CUDA device or
when the package is not beside this file.
"""

import gc
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: the slice: llama_1b's attention at the train step's batch 3 x 2048
SLICE = dict(b=3, s=2048, h=32, kvh=4, d=64, causal=True)
#: GPT-2 XL's attention at phase "families"'s batch 8 x 1024: plain
#: multi-head attention, 25 heads over 25 kv heads (GQA group 1)
GPT = dict(b=8, s=1024, h=25, kvh=25, d=64, causal=True)
#: a small extra shape: non-causal, no GQA, the 128-wide kernel instance
SMALL = dict(b=2, s=256, h=4, kvh=4, d=128, causal=False)
#: kernel vs plain version, both bf16 on the card: every element within
#: ATOL x rms(plain) + RTOL x |plain| and the whole within NORM_TOL x
#: ||plain|| (``closeness``). RTOL is two bf16 steps (one step is 2^-8 to
#: 2^-7 of the value); ATOL covers elements near zero, whose error is that
#: of the terms they sum. lse is fp32 and held to LSE_TOL per element (a
#: relative error of P). Each planted fault (``planted_faults``) must fail
#: the same rule; PERF.md has the readings.
RTOL = 2.0 ** -6
ATOL = 5e-2
NORM_TOL = 1e-2
LSE_TOL = 1e-3
#: full-width model through the kernels vs through mha_reference (bf16
#: activations over 22 layers): the final-norm hidden states within
#: HIDDEN_TOL x their norm, and the loss (about 5.4 after the run's steps
#: on one batch) within LOSS_TOL; a wrong attention (kv heads rolled by
#: one) must fail the hidden gate
HIDDEN_TOL = 5e-2
LOSS_TOL = 2e-2
WARMUP_STEPS, TIMED_STEPS = 2, 5
PALLAS = "dlrover_tpu/ops/pallas/flash_attention.py"
REPLACES = {"fwd": f"{PALLAS}:75", "dq": f"{PALLAS}:205",
            "dkv": f"{PALLAS}:253"}
SOURCES = {name: f"dlrover_tpu_torch/ops/cuda/csrc/flash_{name}.cu"
           for name in REPLACES}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup_s: float = 0.2) -> float:
    """Device time of one call of ``fn``, in ms: the median over ``reps``
    CUDA-event timings of a batch of back-to-back calls, divided by the
    batch. Before each batch the card spins for longer than the host
    takes to queue the batch, so the calls run back to back on the
    device whatever the host's per-call cost -- checks, allocation, the
    launch itself -- as in a train step, where the host runs ahead.
    Without the spin, a function's first timing in a process read up to
    20% above its later ones (PERF.md). ``fn`` runs for ``warmup_s``
    seconds first: the card raises its clocks under load."""
    import torch

    t0 = time.perf_counter()
    n = 0
    while n < 3 or time.perf_counter() - t0 < warmup_s:
        fn()
        n += 1
        torch.cuda.synchronize()  # keep the host clock on the device's
    per_call_ms = (time.perf_counter() - t0) * 1e3 / n  # an upper bound
    batch = max(1, min(100, int(10.0 / per_call_ms)))
    # cycles for the host to queue the batch: its per-call time at most,
    # at the H100's top clock of 1.98 GHz, twice over
    spin = int(2 * per_call_ms * batch * 1.98e6)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(batch):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / batch)
    return statistics.median(times)


def phase_env() -> None:
    import torch

    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "nvidia_smi": nvidia_smi_line()})


def ptxas_summary(log: str, lib) -> list:
    """One entry per kernel in nvcc's ``-Xptxas -v`` output: its name
    (template argument = head_dim), registers, spills, and the dynamic
    shared memory the library launches it with, where the library
    reports it (the summing pass takes none)."""
    smem = {"fwd_kernel": lib.flash_fwd_smem,
            "dq_kernel": lib.flash_dq_smem,
            "dkv_kernel": lib.flash_dkv_smem,
            "dkv_sum_parts": lambda d: 0}
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN5flash\d+(\w+?)"
                      r"(?:ILi(\d+)E)?E", line)
        if m:
            name, d = m.group(1), m.group(2)
            cur = {"kernel": f"{name}<{d}>" if d else name,
                   "dynamic_smem": (smem[name](int(d or 0)) if name in smem
                                    else None)}
            out.append(cur)
        elif cur is not None and "spill" in line:
            cur["spill"] = line.strip()
        elif cur is not None and "registers" in line:
            cur["ptxas"] = line.split(":", 1)[1].strip()
    return out


def phase_build() -> None:
    from dlrover_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    lib = build.load_library()
    seconds = time.perf_counter() - t0
    emit({"phase": "build", "seconds": round(seconds, 3),
          "nvcc_seconds": round(build.last_build_seconds, 3),
          "kernels": ptxas_summary(build.build_log(), lib)})


def _inputs(b, s, h, kvh, d, seed=0):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    return (rand(b, s, h, d), rand(b, s, kvh, d), rand(b, s, kvh, d),
            rand(b, s, h, d))


def closeness(label, got, want) -> dict:
    """How far ``got`` lies from ``want``: max |err|, and for all but lse
    |err| / |want| over the whole tensor and the least ATOL (a fraction
    of rms(want)) that would let every element pass; ``ok`` under the
    rule above."""
    import torch

    g, w = got.float(), want.float()
    err = (g - w).abs()
    out = {"max_abs_err": err.max().item()}
    finite = bool(torch.isfinite(g).all())
    if label == "lse":
        out["ok"] = finite and out["max_abs_err"] <= LSE_TOL
        return out
    rms = w.pow(2).mean().sqrt().clamp_min(1e-30)
    out["rel_norm_err"] = (err.norm() / w.norm().clamp_min(1e-30)).item()
    out["atol_needed"] = ((err - RTOL * w.abs()).max() / rms).item()
    out["ok"] = (finite and out["atol_needed"] <= ATOL
                 and out["rel_norm_err"] <= NORM_TOL)
    return out


def _short_k_loop(s, tile, causal, device):
    """[s, s] keep-mask of a k loop that stops one ``tile``-key tile
    short: before the diagonal tile (causal) or the last tile."""
    import torch

    idx = torch.arange(s, device=device) // tile
    last = idx if causal else torch.full_like(idx, idx[-1])
    return idx[None, :] < last[:, None]


def _dq_masked(q, k, v, do, lse, delta, keep, scale):
    """dQ by the equations of ``dq_plain`` with query i seeing key j where
    ``keep[i, j]``."""
    import torch

    from dlrover_tpu_torch.ops.cuda import flash_attention as fa

    b, s, h, d = q.shape
    kvh = k.shape[2]
    rows = (b, kvh, h // kvh, s, 1)
    grouped = (b, s, kvh, h // kvh, d)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", q.float().reshape(grouped),
                      k.float()) * scale
    p = torch.exp(sc.masked_fill(~keep, fa.NEG_INF) - lse.reshape(rows))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do.float().reshape(grouped),
                      v.float())
    ds = (p * (dp - delta.reshape(rows))).to(k.dtype).float()
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    return dq.reshape(q.shape).to(q.dtype)


def planted_faults(q, k, v, do, lse, delta, causal, scale):
    """What a kernel with one of five bugs would return, written with the
    plain versions: {kernel: [(fault, output label, tensor)]}. Each must
    fail ``closeness`` against the sound plain output. Needs 2 kv heads.
    dK/dV's fault sums a GQA group over its first head only; at group 1,
    where that is the sound sum, it reads the next query head instead."""
    from dlrover_tpu_torch.ops.attention import mha_reference
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa

    b, s, h, d = q.shape
    kvh = k.shape[2]
    # the forward's k loop stops one 64-row tile short
    keep = _short_k_loop(s, 64, causal, q.device)
    o_short, lse_short = mha_reference(q, k, v, causal=False, scale=scale,
                                       mask=keep, return_lse=True)
    # dQ's k loop stops one 128-key tile short
    dq_short = _dq_masked(q, k, v, do, lse, delta,
                          _short_k_loop(s, 128, causal, q.device), scale)
    # query head i reads kv head i // G - 1 (mod kv heads)
    k_rolled, v_rolled = k.roll(1, dims=2), v.roll(1, dims=2)
    o_head, lse_head = fa.fwd_plain(q, k_rolled, v_rolled, causal, scale)
    dq_head = fa.dq_plain(q, k_rolled, v_rolled, do, lse, delta, causal,
                          scale)

    # the dK/dV group loop stops after the first query head of a group
    def first_head(x):
        return x.reshape(b, s, kvh, h // kvh, d)[:, :, :, 0].contiguous()

    def first_row(x):
        return x.reshape(b, kvh, h // kvh, s)[:, :, 0].contiguous()

    if h == kvh:
        dkv_fault = "wrong query head"
        dk_bad, dv_bad = fa.dkv_plain(
            q.roll(1, dims=2), k, v, do.roll(1, dims=2), lse.roll(1, dims=1),
            delta.roll(1, dims=1), causal, scale)
    else:
        dkv_fault = "group sum of one head"
        dk_bad, dv_bad = fa.dkv_plain(
            first_head(q), k, v, first_head(do), first_row(lse),
            first_row(delta), causal, scale)
    return {
        "fwd": [("k loop one tile short", "o", o_short),
                ("k loop one tile short", "lse", lse_short),
                ("wrong kv head", "o", o_head),
                ("wrong kv head", "lse", lse_head)],
        "dq": [("k loop one tile short", "dq", dq_short),
               ("wrong kv head", "dq", dq_head)],
        "dkv": [(dkv_fault, "dk", dk_bad), (dkv_fault, "dv", dv_bad)],
    }


def _work(b, s, h, kvh, d, causal):
    """(FLOP per product, bytes of one [b, s, h, d] bf16 tensor, of one
    [b, s, kvh, d] tensor, of one fp32 [b, h, s] row vector)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return (2.0 * b * h * d * pairs, 2.0 * b * s * h * d,
            2.0 * b * s * kvh * d, 4.0 * b * h * s)


def check_kernels(shape, timed: bool):
    """Hold each kernel against its plain version at ``shape``; with
    ``timed`` also time kernel, plain version and library call. One dict
    per kernel."""
    import torch
    import torch.nn.functional as F

    from dlrover_tpu_torch.auto.device_context import (
        hbm_bytes_per_second,
        peak_flops_per_chip,
    )
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa

    causal = shape["causal"]
    q, k, v, do = _inputs(*(shape[x] for x in ("b", "s", "h", "kvh", "d")))
    scale = shape["d"] ** -0.5
    o, lse = fa.fwd(q, k, v, causal, scale)
    o_ref, lse_ref = fa.fwd_plain(q, k, v, causal, scale)
    delta = fa.attention_delta(o, do)
    args = (q, k, v, do, lse, delta, causal, scale)
    dq = fa.dq(*args)
    dq_ref = fa.dq_plain(*args)
    dk, dv = fa.dkv(*args)
    dk_ref, dv_ref = fa.dkv_plain(*args)
    torch.cuda.synchronize()

    checks = {
        "fwd": [("o", o, o_ref), ("lse", lse, lse_ref)],
        "dq": [("dq", dq, dq_ref)],
        "dkv": [("dk", dk, dk_ref), ("dv", dv, dv_ref)],
    }
    want = {label: ref for items in checks.values()
            for label, _, ref in items}
    out, failed = {}, []
    for name, items in checks.items():
        errs = {label: closeness(label, got, ref)
                for label, got, ref in items}
        failed += [f"{name} {label}: {e}" for label, e in errs.items()
                   if not e["ok"]]
        out[name] = {"name": name, "errors": errs, "max_abs_err": max(
            e["max_abs_err"] for e in errs.values())}
    if timed:
        # every kernel gives the same bits on a second launch
        o2, lse2 = fa.fwd(q, k, v, causal, scale)
        dq2 = fa.dq(*args)
        dk2, dv2 = fa.dkv(*args)
        torch.cuda.synchronize()
        bitwise = {"fwd": torch.equal(o, o2) and torch.equal(lse, lse2),
                   "dq": torch.equal(dq, dq2),
                   "dkv": torch.equal(dk, dk2) and torch.equal(dv, dv2)}
        for name, same in bitwise.items():
            out[name]["bitwise_repeat"] = same
            if not same:
                failed.append(f"{name}: two launches differ")
        # the rule must reject each planted fault
        for name, faults in planted_faults(*args).items():
            readings = []
            for fault, label, bad in faults:
                e = closeness(label, bad, want[label])
                readings.append({"fault": fault, "output": label, **e})
                if e["ok"]:
                    failed.append(f"planted fault '{fault}' passes on "
                                  f"{label}: {e}")
            out[name]["planted_faults"] = readings
    for r in out.values():
        emit({"phase": "kernels", "shape": shape, **r})
    if failed:
        raise AssertionError(f"kernels at {shape}: " + "; ".join(failed))
    if not timed:
        return out

    flop, qbytes, kvbytes, rowbytes = _work(
        *(shape[x] for x in ("b", "s", "h", "kvh", "d", "causal")))
    peak, rate = peak_flops_per_chip(), hbm_bytes_per_second()
    # products per kernel, and bytes: each input read once, each output
    # written once
    work = {
        "fwd": (2 * flop, 2 * qbytes + 2 * kvbytes + rowbytes),
        "dq": (3 * flop, 3 * qbytes + 2 * kvbytes + 2 * rowbytes),
        "dkv": (4 * flop, 2 * qbytes + 4 * kvbytes + 2 * rowbytes),
    }
    # yardstick: PyTorch's fused attention on the same inputs, in its
    # [b, h, s, d] layout (transposed outside the timed region); its
    # backward computes dQ, dK and dV in one call, timed for dq and dkv
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    qr, kr, vr = (x.detach().requires_grad_() for x in (qt, kt, vt))

    def sdpa(a, b_, c):
        return F.scaled_dot_product_attention(
            a, b_, c, is_causal=causal, enable_gqa=True)

    lib_out = sdpa(qr, kr, vr)
    calls = {
        "fwd": lambda: fa.fwd(q, k, v, causal, scale),
        "dq": lambda: fa.dq(*args),
        "dkv": lambda: fa.dkv(*args),
        "sdpa_fwd": lambda: sdpa(qt, kt, vt),
        "sdpa_bwd": lambda: torch.autograd.grad(
            lib_out, (qr, kr, vr), dot, retain_graph=True),
    }
    # kernels and yardsticks timed in turns, in order and then back: a
    # function's first timing in a process can read a few percent high
    # (PERF.md), so each keeps the lower of its two
    readings = {name: [] for name in calls}
    for name in list(calls) + list(calls)[::-1]:
        readings[name].append(time_ms(calls[name]))
    library = {"fwd": "sdpa_fwd", "dq": "sdpa_bwd", "dkv": "sdpa_bwd"}
    plains = {"fwd": lambda: fa.fwd_plain(q, k, v, causal, scale),
              "dq": lambda: fa.dq_plain(*args),
              "dkv": lambda: fa.dkv_plain(*args)}
    for name, plain in plains.items():
        flops, nbytes = work[name]
        t_ops, t_bytes = flops / peak, nbytes / rate
        out[name].update(
            kernel_ms=min(readings[name]),
            plain_ms=time_ms(plain, reps=3),
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=min(readings[library[name]]), flop=flops,
            bytes=nbytes, readings_ms=readings[name],
            library_readings_ms=readings[library[name]],
        )
    return out


def phase_kernels():
    """{shape name: check_kernels' dicts} at the Llama-1.1B step's shape
    and GPT-2 XL's, both timed."""
    import torch

    # the plain versions' fp32 products must not drop to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check_kernels(SMALL, timed=False)
    results = {}
    for name, shape in (("llama_1b", SLICE), ("gpt2_xl", GPT)):
        results[name] = check_kernels(shape, timed=True)
        for r in results[name].values():
            emit({"phase": "kernels", "shape": shape, "timing": {
                key: r[key] for key in (
                    "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "flop", "bytes", "readings_ms",
                    "library_readings_ms")}})
    return results


def timed_steps(trainer, mb, num_layers: int):
    """WARMUP_STEPS steps, then TIMED_STEPS on the host clock up to the one
    sync at their end, the launch counts reset before them: (seconds per
    timed step, the timed steps' losses, the launches, the failed gates:
    a loss that is not finite, and other than ``num_layers`` launches of
    each kernel per step)."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.ops.cuda import flash_attention as fa

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    for _ in range(WARMUP_STEPS):
        trainer.train_step(mb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [trainer.train_step(mb) for _ in range(TIMED_STEPS)]
    losses = [float(x) for x in losses]  # waits for the whole chain
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    launches = dict(fa.LAUNCHES)
    steps = WARMUP_STEPS + TIMED_STEPS
    failed = [] if all(np.isfinite(losses)) else [f"losses {losses}"]
    failed += [f"{name} launched {n} times in {steps} steps, want "
               f"{num_layers} per step" for name, n in launches.items()
               if n != num_layers * steps]
    return step_s, losses, launches, failed


def attention_gate(model, loss_fn, batch):
    """The trained model at full width through the kernels, through the
    plain reference attention, and through a wrong one (kv heads rolled
    by one): (the readings, the failed gates). The final hidden states
    through the kernels must lie within HIDDEN_TOL of the reference's
    and the loss within LOSS_TOL; the wrong attention must fail."""
    import torch

    from dlrover_tpu_torch.ops.attention import flash_attention, mha_reference

    def wrong_attention(q, k, v):
        return mha_reference(q, k.roll(1, dims=2), v.roll(1, dims=2))

    attns = {"kernel": flash_attention, "reference": mha_reference,
             "wrong": wrong_attention}
    with torch.no_grad():
        hidden = {n: model.hidden_states(batch[0], attn_fn=f)
                  for n, f in attns.items()}
        losses = {n: float(loss_fn(model, batch, attn_fn=f))
                  for n, f in attns.items()}
    ref = hidden["reference"].float()
    hidden_err = {n: ((hidden[n].float() - ref).norm() / ref.norm()).item()
                  for n in ("kernel", "wrong")}
    loss_err = {n: abs(losses[n] - losses["reference"])
                for n in ("kernel", "wrong")}
    failed = []
    if hidden_err["kernel"] > HIDDEN_TOL or loss_err["kernel"] > LOSS_TOL:
        failed.append(
            f"model through kernels vs mha_reference: hidden states "
            f"{hidden_err['kernel']} (limit {HIDDEN_TOL}), loss "
            f"{loss_err['kernel']} (limit {LOSS_TOL})")
    if hidden_err["wrong"] <= HIDDEN_TOL:
        failed.append(f"a wrong attention passes the hidden-state gate: "
                      f"{hidden_err['wrong']} <= {HIDDEN_TOL}")
    return {"loss": losses, "loss_abs_err": loss_err,
            "hidden_rel_norm_err": hidden_err, "hidden_tol": HIDDEN_TOL,
            "loss_tol": LOSS_TOL}, failed


def phase_slice():
    import numpy as np
    import torch

    from dlrover_tpu_torch.auto.device_context import peak_flops_per_chip
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.trainer.profiler import utilization
    from dlrover_tpu_torch.trainer.sharded import (
        adamw,
        make_trainer_for_llama,
    )

    cfg = llama.llama_1b(remat="dots_attn_out")
    batch, seq = SLICE["b"], SLICE["s"]
    trainer = make_trainer_for_llama(
        cfg, strategy="ddp", optimizer=adamw(1e-4, b1=0.9, b2=0.95))
    trainer.init(seed=0)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq), dtype=np.int64)
    mb = trainer.shard_batch(trainer.microbatch((tokens, tokens)))
    step_s, losses, launches, failed = timed_steps(trainer, mb,
                                                   cfg.num_layers)
    loss_val, steps = losses[-1], WARMUP_STEPS + TIMED_STEPS
    if failed:
        raise AssertionError("; ".join(failed))
    peak_mem = torch.cuda.max_memory_allocated()

    check, failed = attention_gate(trainer.model, llama.next_token_loss,
                                   tuple(x[0] for x in mb))
    emit({"phase": "slice_check", **check})
    if failed:
        raise AssertionError("; ".join(failed))
    loss_kernel, loss_ref = (check["loss"]["kernel"],
                             check["loss"]["reference"])

    step_profile = _profile_and_sample(trainer, mb)

    phase_profile(trainer, mb, step_s * 1e3)

    tokens_per_step = batch * seq
    model_flops = llama.flops_per_token(cfg, seq) * tokens_per_step
    emit({
        "phase": "slice", "model": "llama_1b", "remat": cfg.remat,
        "batch": batch, "seq": seq, "params": llama.param_count(cfg),
        "warmup_steps": WARMUP_STEPS, "timed_steps": TIMED_STEPS,
        "step_ms": step_s * 1e3,
        "tokens_per_sec": tokens_per_step / step_s,
        "model_flops_per_step": model_flops,
        "mfu_percent": utilization(model_flops, step_s,
                                   peak_flops_per_chip()),
        # the counted FLOPs leave out the flash kernels: a floor
        "hfu_floor_percent": utilization(step_profile["flops"], step_s,
                                         peak_flops_per_chip()),
        "step_profile": step_profile,
        "max_memory_allocated_bytes": peak_mem,
        "final_loss": loss_val, "loss_kernel": loss_kernel,
        "loss_reference": loss_ref,
        "launches_per_step": {n: c / steps for n, c in launches.items()},
    })
    return launches, trainer, mb


def _profile_and_sample(trainer, mb) -> dict:
    """The worker's step profile (trainer/profiler.py) on the full-width
    step, which must leave the training state, the generators and the
    kernels' launch counts bitwise as they were; then one sample of the
    resource monitor's device probe, which must read the allocator's own
    counters."""
    import torch

    from dlrover_tpu_torch.agent.monitor.resource import ResourceMonitor
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa
    from dlrover_tpu_torch.trainer import profiler

    def state():
        st = trainer.train_state()
        opt = st["optimizer"]
        tensors = [t.detach().clone() for part in (
            st["model"], opt["mu"], opt["nu"]) for t in part.values()]
        return tensors, opt["count"]

    torch.cuda.synchronize()
    before, count = state()
    launches = dict(fa.LAUNCHES)
    rng = (torch.get_rng_state(), torch.cuda.get_rng_state())
    t0 = time.perf_counter()
    prof = profiler.profile_step(trainer.forward_backward, mb,
                                 params=trainer.model)
    profile_s = time.perf_counter() - t0
    after, count_after = state()
    failed = []
    if count_after != count or not all(
            torch.equal(a, b) for a, b in zip(before, after)):
        failed.append("the profile changed the training state")
    if fa.LAUNCHES != launches:
        failed.append(f"launch counts {fa.LAUNCHES}, {launches} before")
    if not (torch.equal(torch.get_rng_state(), rng[0])
            and torch.equal(torch.cuda.get_rng_state(), rng[1])):
        failed.append("the profile moved the generators")
    if any(p.grad is not None for p in trainer.model.parameters()):
        failed.append("the profile left gradients")
    if prof.device != "cuda" or not prof.flops > 0:
        failed.append(f"profile {prof}")
    del before, after

    reports = []

    class Client:
        def report_used_resource(self, *args):
            reports.append(args)

    torch.cuda.synchronize()
    sample = ResourceMonitor(Client(), collect_device=True
                             ).report_resource()[0]
    allocated = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    if (sample["bytes_in_use"] != allocated
            or sample["peak_bytes_in_use"] != peak or len(reports) != 1):
        failed.append(f"resource sample {sample} against allocated "
                      f"{allocated}, peak {peak}")
    if failed:
        raise AssertionError("slice profile: " + "; ".join(failed))
    return {"flops": prof.flops, "device": prof.device,
            "excludes": "the flash kernels (outside ATen)",
            "seconds": profile_s, "param_count": prof.param_count,
            "state_bitwise": True, "resource_sample": sample}


def _kernel_group(name: str) -> str:
    if any(k in name for k in ("fwd_kernel", "dq_kernel", "dkv_kernel",
                                "dkv_sum_parts")):
        return "flash attention (this port's kernels)"
    low = name.lower()
    if any(t in low for t in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "matmul (cuBLAS)"
    if "multi_tensor" in low or "adam" in low:
        return "optimizer (AdamW)"
    return "other (elementwise, norms, softmax, copies)"


def phase_profile(trainer, mb, step_ms: float, steps: int = 2,
                  model: str = "llama_1b") -> None:
    """Where the step's device time goes, by kernel group and the top
    kernels, from torch.profiler over ``steps`` steps. The profiler's own
    host cost slows the wall clock here but not the kernels, so the idle
    share is taken against the unprofiled ``step_ms``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(mb)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device kernels only: a record_function range (the optimizer's
    # "Optimizer.step#AdamW.step") also carries device time, and would
    # count its kernels twice
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.self_device_time_total > 0
               and e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(t for _, t, _ in kernels)
    groups = {}
    for name, t, _ in kernels:
        key = _kernel_group(name)
        groups[key] = groups.get(key, 0.0) + t
    top = sorted(kernels, key=lambda k: -k[1])[:12]
    # this port's kernels, each by its own: device ms per launch
    flash = {re.sub(r"^(void )?flash::|\(.*$", "", n): t / c / 1e3
             for n, t, c in kernels if _kernel_group(n).startswith("flash")}
    emit({
        "phase": "profile", "model": model, "steps": steps,
        "profiled_wall_ms_per_step": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_idle_share": 1.0 - busy_us / steps / 1e3 / step_ms,
        "groups_ms_per_step": {k: v / steps / 1e3 for k, v in
                               sorted(groups.items(), key=lambda x: -x[1])},
        "top_kernels": [{"name": n[:90], "ms_per_step": t / steps / 1e3,
                         "calls_per_step": c / steps} for n, t, c in top],
        "flash_ms_per_launch": flash,
    })


#: the elastic loop: steps per run, the save cadence, the dataset rows
#: (one minibatch of SLICE["b"] rows per shard, in order)
ELASTIC_STEPS, SAVE_INTERVAL, ELASTIC_ROWS = 8, 4, 48
#: steps after the first one past the restore: their losses within this
#: relative distance of the uninterrupted run's (a backward op that
#: sums with atomics may move the last bits)
RESUME_LOSS_RTOL = 1e-3


def state_checksums(tree) -> dict:
    """Key path -> a position-weighted integer checksum of each tensor's
    bits, computed on the card (other leaves as they are): equal
    checksums mean equal bits, wherever the tensor was restored from."""
    import torch

    from dlrover_tpu_torch.trainer import ckpt_store

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    for path, leaf in ckpt_store.flatten_with_path(tree):
        key = "/".join(str(c.get("k", c.get("i"))) for c in path)
        if not isinstance(leaf, torch.Tensor):
            out[key] = leaf
            continue
        bits = leaf.detach().reshape(-1).view(
            ints[leaf.element_size()]).long()
        weight = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        out[key] = int((bits * weight).sum())
    return out


def _state_bytes(cfg) -> int:
    """The checkpointed state: bf16 parameters but the fp32 norm weights,
    and AdamW's two moments in the parameters' dtypes."""
    from dlrover_tpu_torch.models import llama

    norms = (2 * cfg.num_layers + 1) * cfg.hidden_size
    return 3 * (2 * (llama.param_count(cfg) - norms) + 4 * norms)


def _elastic_dirs(state_bytes: int):
    """(ram_dir, persist_dir, how the RAM tier was placed): the RAM tier
    on /dev/shm when it has twice the state free, else in the temporary
    directory, which also holds the persist tier."""
    tmp = tempfile.mkdtemp(prefix="dlrover_elastic_")
    shm_free = (shutil.disk_usage("/dev/shm").free
                if os.path.isdir("/dev/shm") else 0)
    if shm_free >= 2 * state_bytes:
        ram = tempfile.mkdtemp(prefix="dlrover_elastic_", dir="/dev/shm")
    else:
        ram = os.path.join(tmp, "ram")
    need = (2 if ram.startswith(tmp) else 0) * state_bytes + 2 * state_bytes
    tmp_free = shutil.disk_usage(tmp).free
    if tmp_free < need * 1.1:
        raise RuntimeError(
            f"{tmp} has {tmp_free} bytes free, the checkpoints need {need}")
    return ram, os.path.join(tmp, "persist"), {
        "ram_dir": ram, "dev_shm_free_bytes": shm_free,
        "tmp_dir": tmp, "tmp_free_bytes": tmp_free}


def _elastic_run(cfg, seed: int, ram_dir: str, persist_dir: str,
                 restore_step=None, save: bool = True):
    """One incarnation of the elastic loop on the card: a fresh master,
    trainer (initialized from ``seed``), sharding client and
    checkpointer; restore ``restore_step`` first when given. Runs to
    ELASTIC_STEPS and returns what it saw."""
    import torch

    from dlrover_tpu_torch.agent.master_client import build_master_client
    from dlrover_tpu_torch.agent.sharding.client import ShardingClient
    from dlrover_tpu_torch.examples.llama_train import (
        checkpoint_state,
        synth_batch,
    )
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa
    from dlrover_tpu_torch.trainer import ckpt_store
    from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer
    from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
    from dlrover_tpu_torch.trainer.sharded import (
        adamw,
        make_trainer_for_llama,
    )

    client = build_master_client()
    trainer = make_trainer_for_llama(
        cfg, strategy="ddp", optimizer=adamw(1e-4, b1=0.9, b2=0.95))
    trainer.init(seed=seed)
    elastic = ElasticTrainer(trainer, max_nodes=1, cur_nodes=1,
                             master_client=client)
    sharding = ShardingClient(
        "elastic", SLICE["b"], num_epochs=1, dataset_size=ELASTIC_ROWS,
        shuffle=False, num_minibatches_per_shard=1, master_client=client)
    ckpt = FlashCheckpointer(persist_dir, ram_dir=ram_dir,
                             persist_interval=SAVE_INTERVAL,
                             max_ram_keep=2, max_persist_keep=2)
    out = {"start_step": 0, "shards": {}, "losses": {}, "step_ms": {},
           "stall_ms": {}}
    if restore_step is not None:
        restored, step = ckpt.restore(
            target={**trainer.train_state(), "step": 0, "data": ""},
            step=restore_step)
        if step != restore_step:
            raise AssertionError(f"restored step {step}, want {restore_step}")
        trainer.load_train_state(restored)
        if not sharding.restore_shard_from_checkpoint(restored["data"]):
            raise AssertionError("the master refused the shard checkpoint")
        out["start_step"] = int(restored["step"])
        out["restore"] = dict(ckpt.last_restore_stats)
        out["restored_checksums"] = state_checksums(
            {**trainer.train_state(), "step": restored["step"],
             "data": restored["data"]})
        del restored
    if save:
        elastic.attach_checkpointer(ckpt, save_interval=SAVE_INTERVAL)
        # page-lock the staging block while the first steps run
        ckpt.prepare(checkpoint_state(trainer, 0, sharding))
    torch.cuda.synchronize()
    fa.reset_launches()
    step = out["start_step"]
    while step < ELASTIC_STEPS:
        shard = sharding.fetch_shard()
        if shard is None:
            raise AssertionError(f"the dataset ran out at step {step}")
        batch = trainer.shard_batch(elastic.microbatch(synth_batch(
            shard.start, shard.end, SLICE["s"], cfg.vocab_size)))
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = elastic.train_step(batch)
        stop.record()
        step += 1
        out["losses"][step] = elastic.report_step(step, loss=loss)
        sharding.report_batch_done()
        out["shards"][step] = (shard.start, shard.end)
        if save and elastic.checkpoint_due(step):
            out.setdefault("checksums", {})[step] = state_checksums(
                checkpoint_state(trainer, step, sharding))
        stall = elastic.maybe_checkpoint(
            lambda: checkpoint_state(trainer, step, sharding))
        if stall is not None:
            out["stall_ms"][step] = stall
        stop.synchronize()
        out["step_ms"][step] = start.elapsed_time(stop)
    out["launches"] = dict(fa.LAUNCHES)
    ckpt.close()
    out["saves"] = {s: {k: v for k, v in st.items() if k != "t0"}
                    for s, st in ckpt.save_stats.items()}
    out["state_bytes"] = sum(
        t.numel() * t.element_size()
        for _, t in ckpt_store.flatten_with_path(trainer.train_state())
        if isinstance(t, torch.Tensor))
    sharding.stop()
    return out


def phase_elastic() -> dict:
    """The elastic loop at full width: run A saves at steps 4 and 8;
    after a crash run B restores step 4 from the RAM tier into a trainer
    initialized from another seed and trains steps 5-8 again; then step
    4 is restored from the persist tier with the RAM tier deleted."""
    import torch

    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.trainer import ckpt_store
    from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer
    from dlrover_tpu_torch.trainer.sharded import make_trainer_for_llama

    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama.llama_1b(remat="dots_attn_out")
    state_bytes = _state_bytes(cfg)
    ram_dir, persist_dir, placed = _elastic_dirs(state_bytes)
    try:
        run_a = _elastic_run(cfg, 0, ram_dir, persist_dir)
        # the crash: every object of run A is gone, the card emptied
        gc.collect()
        torch.cuda.empty_cache()
        run_b = _elastic_run(cfg, 1, ram_dir, persist_dir,
                             restore_step=SAVE_INTERVAL, save=False)
        gc.collect()
        torch.cuda.empty_cache()
        target_trainer = make_trainer_for_llama(cfg, strategy="ddp")
        target_trainer.init(seed=2)
        target = {**target_trainer.train_state(), "step": 0, "data": ""}
        # what the digests cost: both archives read without them
        unverified = {}
        for tier, path in (
                ("ram", os.path.join(
                    ram_dir, f"step-{SAVE_INTERVAL}-proc-0")),
                ("persist", os.path.join(
                    persist_dir, ckpt_store.step_key(SAVE_INTERVAL, 0)))):
            t0 = time.perf_counter()
            with open(path, "rb") as f:
                tree, _ = ckpt_store.snapshot_from_file(
                    f, target, verify=False)
            torch.cuda.synchronize()
            unverified[tier] = time.perf_counter() - t0
            del tree
        # the persist tier alone: the RAM tier is deleted first
        shutil.rmtree(ram_dir)
        ckpt = FlashCheckpointer(persist_dir, ram_dir=ram_dir)
        restored, step = ckpt.restore(target=target, step=SAVE_INTERVAL)
        persist = dict(ckpt.last_restore_stats or {})
        persist_checksums = state_checksums(restored)
        del restored, target, target_trainer
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(placed["tmp_dir"], ignore_errors=True)
        shutil.rmtree(ram_dir, ignore_errors=True)

    failed = []
    want = run_a["checksums"][SAVE_INTERVAL]
    if run_b["restored_checksums"] != want:
        failed.append("RAM-tier restore: state checksums differ from step "
                      f"{SAVE_INTERVAL}'s")
    if step != SAVE_INTERVAL or persist.get("tier") != "persistent":
        failed.append(f"persist tier restored step {step} from {persist}")
    if persist_checksums != want:
        failed.append("persist-tier restore: state checksums differ")
    if run_a["state_bytes"] != state_bytes:
        failed.append(f"state of {run_a['state_bytes']} bytes, "
                      f"{state_bytes} expected")
    if run_b["restore"].get("tier") != "ram":
        failed.append(f"run B restored from {run_b['restore']}")
    resumed = range(SAVE_INTERVAL + 1, ELASTIC_STEPS + 1)
    if [run_b["shards"].get(s) for s in resumed] != [
            run_a["shards"][s] for s in resumed]:
        failed.append(f"shards after restore {run_b['shards']} != run A's "
                      f"{run_a['shards']}")
    first = SAVE_INTERVAL + 1
    bitwise = {s: run_b["losses"].get(s) == run_a["losses"][s]
               for s in resumed}
    rel = {s: abs(run_b["losses"][s] - run_a["losses"][s])
           / abs(run_a["losses"][s]) for s in resumed}
    if not bitwise[first]:
        failed.append(f"step {first} loss {run_b['losses'][first]!r} != "
                      f"run A's {run_a['losses'][first]!r}")
    failed += [f"step {s} loss off by {r:.2e} relative" for s, r in
               rel.items() if r > RESUME_LOSS_RTOL]
    for name, run in (("A", run_a), ("B", run_b)):
        steps = len(run["losses"])
        for kernel, n in run["launches"].items():
            if n != cfg.num_layers * steps:
                failed.append(f"run {name}: {kernel} launched {n} times in "
                              f"{steps} steps")
    overlap = run_a["step_ms"][SAVE_INTERVAL + 1]
    plain = statistics.median(run_a["step_ms"][s] for s in (2, 3, 6, 7))
    emit({
        "phase": "elastic", "model": "llama_1b", "remat": cfg.remat,
        "batch": SLICE["b"], "seq": SLICE["s"], "steps": ELASTIC_STEPS,
        "save_interval": SAVE_INTERVAL, "dataset_rows": ELASTIC_ROWS,
        "state_bytes": state_bytes, **placed,
        "shards_a": run_a["shards"], "shards_b": run_b["shards"],
        "losses_a": run_a["losses"], "losses_b": run_b["losses"],
        "loss_bitwise": bitwise, "loss_rel_err": rel,
        "stall_ms": run_a["stall_ms"], "saves": run_a["saves"],
        "step_ms_a": run_a["step_ms"], "step_ms_b": run_b["step_ms"],
        "step_ms_overlapping_copy": overlap, "step_ms_plain": plain,
        "restore_ram": run_b["restore"], "restore_persist": persist,
        "restore_s_without_digest": unverified,
        "copy_gb_per_s": {
            s: state_bytes / st["copy_s"] / 1e9
            for s, st in run_a["saves"].items() if st.get("copy_s")},
        "checksums_equal": {
            "ram": run_b["restored_checksums"] == want,
            "persist": persist_checksums == want},
        "launches_per_step": {
            "a": {k: n / len(run_a["losses"])
                  for k, n in run_a["launches"].items()},
            "b": {k: n / len(run_b["losses"])
                  for k, n in run_b["launches"].items()}},
        "nvidia_smi": nvidia_smi_line(),
    })
    if failed:
        raise AssertionError("elastic: " + "; ".join(failed))
    return run_a


#: phase "data": block A is ``bench.py --data shm``'s loader (2 coworkers
#: of seeded batches), 2 warm-up steps, then blocks of DATA_BLOCK steps
#: in turns: in memory, shm, in memory, shm; block B the elastic feed on
#: a master service, DATA_B_ROWS rows in shards of SLICE["b"], one step
#: per shard
DATA_WORKERS, DATA_WARMUP, DATA_BLOCK = 2, 2, 4
DATA_TURNS = ("inmem", "shm", "inmem", "shm")
DATA_B_ROWS = 24


class _ContextWatch:
    """Who holds a CUDA context while the coworkers run, sampled on a
    thread every 50 ms from the loader's start until every coworker has
    exited: per coworker, whether its memory ever mapped libcuda or
    torch, and the most processes ``nvidia-smi`` listed on the card at
    once (in a container their pids may be the host's, so only their
    number is gated)."""

    def __init__(self, pids):
        import threading

        self.maps = {pid: {"samples": 0, "libcuda": False, "torch": False}
                     for pid in pids}
        self.most_apps = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            alive = False
            for pid, seen in self.maps.items():
                try:
                    with open(f"/proc/{pid}/maps") as f:
                        maps = f.read()
                except OSError:
                    continue
                alive = True
                seen["samples"] += 1
                seen["libcuda"] |= "libcuda" in maps
                seen["torch"] |= "libtorch" in maps
            if not alive:
                return
            out = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid",
                 "--format=csv,noheader"],
                capture_output=True, text=True).stdout
            self.most_apps = max(self.most_apps, len(out.split()))
            self._stop.wait(0.05)

    def result(self, what: str, failed: list) -> dict:
        """Stop sampling; the readings, with what fails the gate added
        to ``failed``."""
        self._stop.set()
        self._thread.join(timeout=30)
        if self.most_apps > 1:
            failed.append(f"{what}: {self.most_apps} processes held a CUDA "
                          f"context at once")
        for pid, seen in self.maps.items():
            if seen["libcuda"] or seen["torch"]:
                failed.append(f"{what}: coworker {pid} mapped {seen}")
        if not any(seen["samples"] for seen in self.maps.values()):
            failed.append(f"{what}: no coworker was seen running")
        return {"most_compute_apps": self.most_apps,
                "coworkers": self.maps}


def phase_data(trainer, mb) -> None:
    """The shm data plane feeding the slice's llama_1b trainer. Block A:
    ``ShmDataLoader`` over seeded batches and ``DevicePrefetch(depth=2)``
    whose transform reshapes into microbatches and casts the int32
    tokens to int64 on the host, timed in turns with the in-memory batch
    ``mb``; then a transform that raises at the third batch. Block B:
    ``ElasticShmDataLoader`` on a local master service. Every batch a
    step used is copied on the card before and after its step and held
    to the tokens its producer made, recomputed here."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.data import shm_ring, synth
    from dlrover_tpu_torch.data.elastic_shm import ElasticShmDataLoader
    from dlrover_tpu_torch.data.shm_dataloader import (
        DevicePrefetch,
        ShmDataLoader,
    )
    from dlrover_tpu_torch.master.local_master import LocalJobMaster
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa
    from dlrover_tpu_torch.telemetry import tracing

    b, s = SLICE["b"], SLICE["s"]
    cfg = trainer.model.cfg
    slot_bytes = max(1 << 20, 4 * b * s * 2 + 4096)
    failed, losses = [], []

    def transform(batch):
        tokens, targets = batch[0], batch[1]
        return trainer.microbatch((tokens.astype(np.int64),
                                   targets.astype(np.int64)))

    def step(batch, seen):
        """One train step on a staged batch; its tokens copied on the
        card before and after the step."""
        before = batch[0].clone()
        losses.append(trainer.train_step(batch))
        seen.append((before, batch[0].clone()))

    def host(t):
        return t.cpu().numpy().reshape(b, s)

    # -- block A: bench.py --data shm ------------------------------------
    n_a = DATA_WARMUP + DATA_BLOCK * DATA_TURNS.count("shm")
    source = synth.SeededBatches(n_a, b, s, cfg.vocab_size, seed=0)
    made = {t.astype(np.int64).tobytes(): i
            for i, t in enumerate(source.expected())}
    torch.cuda.synchronize()
    fa.reset_launches()
    loader = ShmDataLoader(source, num_workers=DATA_WORKERS,
                           slot_bytes=slot_bytes)
    watch = _ContextWatch(loader.pids)
    while loader.in_ring == 0:
        time.sleep(0.0005)
    start_a = time.perf_counter() - loader.started_at
    prefetch = DevicePrefetch(loader, depth=2, transform=transform)
    batches = iter(prefetch)
    seen_a, stall = [], []
    for _ in range(DATA_WARMUP):
        step(next(batches), seen_a)
    torch.cuda.synchronize()
    # the coworkers wait on a full ring by now; the sampling stops
    # before the timed turns
    ctx_a = watch.result("block A", failed)
    tracing.clear()
    tracing.enable()
    turns = {"inmem": [], "shm": []}
    for feed in DATA_TURNS:
        t0 = time.perf_counter()
        for _ in range(DATA_BLOCK):
            if feed == "inmem":
                losses.append(trainer.train_step(mb))
                continue
            t1 = time.perf_counter()
            batch = next(batches)
            stall.append(time.perf_counter() - t1)
            step(batch, seen_a)
            del batch
        float(losses[-1])  # the block's one sync
        turns[feed].append((time.perf_counter() - t0) / DATA_BLOCK * 1e3)
    spans = tracing.summarize(("data.fetch", "data.stage"))
    tracing.disable()
    if next(batches, None) is not None:
        failed.append(f"block A: more than the {n_a} batches made")
    prefetch.join()
    loader.shutdown()
    left_a = shm_ring.segments_of(os.getpid())
    idx_a = []
    for before, after in seen_a:
        i, j = (made.get(host(t).tobytes()) for t in (before, after))
        if i is None or i != j:
            failed.append(f"block A: a batch on the card is no batch made "
                          f"(before the step {i}, after it {j})")
        idx_a.append(i)
    if sorted(idx_a) != list(range(n_a)):
        failed.append(f"block A: batches consumed {sorted(idx_a)}, each of "
                      f"{n_a} once expected")

    # the planted fault: a transform that raises at the third batch
    calls = []

    def planted(batch):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("planted transform fault at batch 3")
        return transform(batch)

    loader = ShmDataLoader(synth.SeededBatches(5, b, s, cfg.vocab_size),
                           num_workers=DATA_WORKERS, slot_bytes=slot_bytes)
    prefetch = DevicePrefetch(loader, depth=2, transform=planted)
    got, raised = 0, None
    try:
        for _ in prefetch:
            got += 1
    except RuntimeError as e:
        raised = str(e)
    prefetch.join()
    loader.shutdown()
    if raised is None or "planted" not in raised or got != 2:
        failed.append(f"planted transform fault: {got} batches, then "
                      f"{raised!r}")
    left_a += shm_ring.segments_of(os.getpid())

    # -- block B: ElasticShmDataLoader on a master service ---------------
    def with_rows(batch):
        return transform(batch), (int(batch[2][0]), int(batch[2][1]))

    master = LocalJobMaster(port=0)
    master.prepare()
    seen_b, rows_b, ctx_b = [], [], {}
    try:
        elastic = ElasticShmDataLoader(
            synth.ShardBatch(s, cfg.vocab_size), dataset_name="chip-data",
            batch_size=b, dataset_size=DATA_B_ROWS, num_epochs=1,
            num_workers=DATA_WORKERS, master_addr=master.addr,
            slot_bytes=slot_bytes, transform=with_rows)
        watch = _ContextWatch(elastic.producer_pids)
        try:
            batches = iter(elastic)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(DATA_B_ROWS // b):
                batch, rows = next(batches)
                if i == 0:
                    first_b = time.perf_counter() - elastic.started_at
                    t0 = time.perf_counter()
                step(batch, seen_b)
                rows_b.append(rows)
                del batch
            float(losses[-1])
            step_b = (time.perf_counter() - t0) / (DATA_B_ROWS // b - 1) * 1e3
            if next(batches, None) is not None:
                failed.append("block B: a batch past the dataset")
            ctx_b = watch.result("block B", failed)
        finally:
            elastic.shutdown()
    finally:
        master.stop()
    left_b = shm_ring.segments_of(os.getpid())
    for (before, after), (start, end) in zip(seen_b, rows_b):
        want = synth.synth_batch(start, end, s, cfg.vocab_size)[0]
        if not all(np.array_equal(host(t), want) for t in (before, after)):
            failed.append(f"block B: rows {start}-{end} on the card differ "
                          f"from the tokens made")
    covered = sorted(r for start, end in rows_b for r in range(start, end))
    if covered != list(range(DATA_B_ROWS)):
        failed.append(f"block B: rows {rows_b} do not cover "
                      f"range({DATA_B_ROWS}) once")
    if left_a or left_b:
        failed.append(f"segments left in /dev/shm: {left_a + left_b}")

    # every step's loss finite, 22 launches of each kernel per step
    steps = len(losses)
    if not bool(torch.isfinite(torch.stack(losses)).all()):
        failed.append("a non-finite loss")
    for name, n in fa.LAUNCHES.items():
        if n != cfg.num_layers * steps:
            failed.append(f"{name} launched {n} times in {steps} steps")
    step_ms = {k: statistics.mean(v) for k, v in turns.items()}
    emit({
        "phase": "data", "model": "llama_1b", "batch": b, "seq": s,
        "workers": DATA_WORKERS, "slot_bytes": slot_bytes,
        "prefetch_depth": 2,
        "token_cast": "int32 -> int64 in the transform, on the host",
        "block_a": {
            "batches": n_a, "step_ms_turns": turns, "step_ms": step_ms,
            "tokens_per_sec": {k: b * s / v * 1e3
                               for k, v in step_ms.items()},
            "shm_over_inmem": step_ms["shm"] / step_ms["inmem"],
            "data_stall_ms": statistics.mean(stall) * 1e3,
            "data_stall_ms_max": max(stall) * 1e3,
            "shard_dispatch_ms": spans.get("data.fetch", {}).get("mean_ms"),
            "data_stage_ms": spans.get("data.stage", {}).get("mean_ms"),
            "data_stage_ms_max": spans.get("data.stage", {}).get("max_ms"),
            "producer_start_s": start_a, "cuda_contexts": ctx_a,
        },
        "planted_fault": {"batches_before": got, "raised": raised},
        "block_b": {
            "rows": DATA_B_ROWS, "rows_by_step": rows_b, "step_ms": step_b,
            "tokens_per_sec": b * s / step_b * 1e3,
            "first_batch_s": first_b, "cuda_contexts": ctx_b,
        },
        "losses": [float(x) for x in losses[-3:]],
        "launches_per_step": {k: n / steps for k, n in fa.LAUNCHES.items()},
        "segments_left": left_a + left_b,
        "nvidia_smi": nvidia_smi_line(),
    })
    if failed:
        raise AssertionError("data: " + "; ".join(failed))


#: phase "eval": llama_1b trained EVAL_STEPS steps, saved at EVAL_SAVES;
#: the held-out batch's seed is the JAX eval example's
EVAL_STEPS, EVAL_SAVES, HELD_OUT_SEED = 4, (2, 4), 9999


def phase_eval() -> dict:
    """The checkpoint evaluator on the card: a llama_1b state trains
    EVAL_STEPS steps; at each step of EVAL_SAVES its held-out loss is
    computed directly and the state saved durably; then a
    ``CheckpointEvaluator`` restores the step into a fresh model,
    evaluates it through the flash forward and reports over RPC, as an
    evaluator node, into a master service's job metric collector."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.common.constants import NodeType
    from dlrover_tpu_torch.data import synth
    from dlrover_tpu_torch.master.servicer import create_master_service
    from dlrover_tpu_torch.master.stats.job_collector import (
        JobMetricCollector,
    )
    from dlrover_tpu_torch.master.stats.reporter import JobMeta
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa
    from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer
    from dlrover_tpu_torch.trainer.evaluator import (
        CheckpointEvaluator,
        report_to,
    )
    from dlrover_tpu_torch.trainer.sharded import (
        adamw,
        make_trainer_for_llama,
    )

    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama.llama_1b(remat="dots_attn_out")
    b, s = SLICE["b"], SLICE["s"]
    held = torch.from_numpy(synth.synth_batch(
        HELD_OUT_SEED, HELD_OUT_SEED + b, s, cfg.vocab_size)[0]
        .astype(np.int64)).cuda()

    def held_out_loss(model) -> float:
        with torch.no_grad():
            return float(llama.next_token_loss(model, (held, held)))

    collector = JobMetricCollector(JobMeta(name="chip-eval"))
    server, _ = create_master_service(0, job_metric_collector=collector)
    server.start()
    ram_dir, persist_dir, placed = _elastic_dirs(_state_bytes(cfg))
    failed, direct, evals, saved_at, reported_at = [], {}, [], {}, {}
    try:
        trainer = make_trainer_for_llama(
            cfg, strategy="ddp", optimizer=adamw(1e-4, b1=0.9, b2=0.95))
        trainer.init(seed=0)
        fresh = make_trainer_for_llama(cfg, strategy="ddp")
        fresh.init(seed=1)
        ckpt = FlashCheckpointer(persist_dir, ram_dir=ram_dir,
                                 persist_interval=0)
        reader = FlashCheckpointer(persist_dir, ram_dir=ram_dir,
                                   persist_interval=0)
        client = MasterClient(f"localhost:{server.port}", 0,
                              NodeType.EVALUATOR)
        send = report_to(client)

        def report(step, results):
            send(step, results)
            reported_at[step] = time.perf_counter()

        def eval_fn(state, step):
            fresh.load_train_state(state)
            torch.cuda.synchronize()
            fa.reset_launches()
            t0 = time.perf_counter()
            loss = held_out_loss(fresh.model)  # the sync
            ms = (time.perf_counter() - t0) * 1e3
            evals.append({"step": step, "loss": loss, "forward_ms": ms,
                          "launches": dict(fa.LAUNCHES),
                          "restore": dict(reader.last_restore_stats)})
            return {"loss": loss}

        evaluator = CheckpointEvaluator(
            reader, eval_fn,
            target={**fresh.train_state(), "step": 0}, report_fn=report,
            poll_interval=0.0)
        for k in range(1, EVAL_STEPS + 1):
            batch = trainer.shard_batch(trainer.microbatch(
                synth.synth_batch(b * k, b * k + b, s, cfg.vocab_size)))
            trainer.train_step(tuple(x.long() for x in batch))
            if k in EVAL_SAVES:
                direct[k] = held_out_loss(trainer.model)
                ckpt.save(k, {**trainer.train_state(), "step": k},
                          durable=True)
                saved_at[k] = time.perf_counter()
                evaluator.poll_once()
        ckpt.close()
        stats = dict(collector._custom)
        del trainer, fresh, evaluator, ckpt, reader
    finally:
        server.stop()
        shutil.rmtree(placed["tmp_dir"], ignore_errors=True)
        shutil.rmtree(ram_dir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

    if [e["step"] for e in evals] != list(EVAL_SAVES):
        failed.append(f"evaluated steps {[e['step'] for e in evals]}, "
                      f"{list(EVAL_SAVES)} expected")
    for e in evals:
        if e["loss"] != direct.get(e["step"]):
            failed.append(f"step {e['step']}: eval loss {e['loss']!r} != "
                          f"the direct {direct.get(e['step'])!r}")
        if e["launches"] != {"fwd": cfg.num_layers, "dq": 0, "dkv": 0}:
            failed.append(f"step {e['step']}: launches {e['launches']}")
    last = EVAL_SAVES[-1]
    if (stats.get("eval_step") != last
            or stats.get("eval_loss") != direct.get(last)):
        failed.append(f"the collector holds {stats}")
    if not all(math.isfinite(v) for v in direct.values()):
        failed.append(f"held-out losses {direct}")
    emit({
        "phase": "eval", "model": "llama_1b", "batch": b, "seq": s,
        "steps": EVAL_STEPS, "saves": list(EVAL_SAVES),
        "held_out_seed": HELD_OUT_SEED, "direct_loss": direct,
        "evals": evals, "collector": stats,
        "save_to_report_s": {k: reported_at[k] - saved_at[k]
                             for k in reported_at if k in saved_at},
        **placed, "nvidia_smi": nvidia_smi_line(),
    })
    if failed:
        raise AssertionError("eval: " + "; ".join(failed))
    return {"evals": evals}


#: bench.py --model dlrm on the card: batch, warm-up and timed steps; the
#: card's losses of the first DLRM_CHECK_STEPS steps and the loss after
#: them within DLRM_LOSS_RTOL (relative) of the same steps of the port on
#: the CPU from the same weights and batch: fp32 throughout, the two
#: devices sum in other orders (the table gradient's scatter-add among
#: them), which on an H100 moved the loss by 8.6e-8 relative; the limit
#: leaves that a hundredfold and catches an update fault of 1e-5
DLRM_BATCH, DLRM_WARMUP, DLRM_STEPS = 4096, 5, 30
DLRM_CHECK_STEPS, DLRM_LOSS_RTOL = 3, 1e-5
#: the MNIST CNN at the example's batch and optimizer, CNN_STEPS steps,
#: under torch's defaults, as a user gets them: cuDNN runs the fp32
#: convolutions in TF32, which keeps 10 of fp32's 23 mantissa bits
#: (2^-11 relative per operand); the card's losses within CNN_LOSS_RTOL
#: of the CPU's, from the same weights and batches (Adam can turn a
#: near-zero gradient element's TF32 error into a step of the other
#: sign, +-lr)
CNN_BATCH, CNN_STEPS, CNN_LOSS_RTOL = 64, 5, 1e-2


def _gpt_step(failed: list) -> dict:
    """GPT-2 XL's train step at full width through ``make_trainer_for``:
    step time, tokens/s, MFU, peak memory, launches per step, the step's
    device profile; its hidden states and loss through the kernels
    against ``mha_reference``."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.auto.device_context import peak_flops_per_chip
    from dlrover_tpu_torch.models import gpt, make_trainer_for
    from dlrover_tpu_torch.trainer.profiler import utilization
    from dlrover_tpu_torch.trainer.sharded import adamw

    # "dots_attn_out": the matmul outputs saved, as under "dots", with the
    # attention call outside the checkpointed segments, so the backward
    # never re-runs the forward kernel (bench.py's Llama policy)
    cfg = gpt.gpt2_xl(remat="dots_attn_out")
    batch, seq = GPT["b"], GPT["s"]
    trainer = make_trainer_for(cfg, optimizer=adamw(1e-4, b1=0.9, b2=0.95))
    trainer.init(seed=0)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq), dtype=np.int64)
    mb = trainer.shard_batch(trainer.microbatch((tokens, tokens)))
    step_s, losses, launches, step_failed = timed_steps(trainer, mb,
                                                        cfg.num_layers)
    peak_mem = torch.cuda.max_memory_allocated()
    check, check_failed = attention_gate(
        trainer.model, gpt.next_token_loss, tuple(x[0] for x in mb))
    failed += [f"gpt2_xl: {f}" for f in step_failed + check_failed]
    # where the step's device time goes (two more steps, profiled)
    phase_profile(trainer, mb, step_s * 1e3, model="gpt2_xl")
    tokens_per_step = batch * seq
    model_flops = gpt.flops_per_token(cfg, seq) * tokens_per_step
    steps = WARMUP_STEPS + TIMED_STEPS
    return {
        "model": "gpt2_xl", "remat": cfg.remat, "batch": batch, "seq": seq,
        "params": gpt.param_count(cfg), "warmup_steps": WARMUP_STEPS,
        "timed_steps": TIMED_STEPS, "step_ms": step_s * 1e3,
        "tokens_per_sec": tokens_per_step / step_s,
        "model_flops_per_step": model_flops,
        "mfu_percent": utilization(model_flops, step_s,
                                   peak_flops_per_chip()),
        "max_memory_allocated_bytes": peak_mem, "losses": losses,
        "launches": launches,
        "launches_per_step": {n: c / steps for n, c in launches.items()},
        "check": check,
    }


def _steps(trainer, batches) -> list:
    return [float(trainer.train_step(trainer.shard_batch(b)))
            for b in batches]


def _dlrm_bench(failed: list) -> dict:
    """``bench.py --model dlrm``'s path on the card: criteo_wide_deep at
    batch 4096 under adagrad(0.05), its inputs made as bench.py makes
    them; the first steps held against the CPU's."""
    import copy

    import numpy as np
    import torch

    from dlrover_tpu_torch.models import dlrm, make_trainer_for
    from dlrover_tpu_torch.trainer.sharded import adagrad

    cfg = dlrm.criteo_wide_deep()
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((1, DLRM_BATCH, cfg.dense_dim),
                                dtype=np.float32)
    cat = np.stack([rng.integers(0, v, (1, DLRM_BATCH))
                    for v in cfg.vocab_sizes], -1).astype(np.int32)
    labels = rng.integers(0, 2, (1, DLRM_BATCH)).astype(np.int32)
    batch = (dense, cat, labels)
    init = dlrm.init_params(cfg, seed=0, device="cpu")

    def run(device):
        trainer = make_trainer_for(cfg, device=device,
                                   optimizer=adagrad(0.05))
        trainer.init(model=copy.deepcopy(init))
        losses = _steps(trainer, [batch] * DLRM_CHECK_STEPS)
        with torch.no_grad():
            after = float(dlrm.loss(trainer.model, tuple(
                x[0] for x in trainer.shard_batch(batch))))
        return trainer, losses + [after]

    trainer, card = run("cuda")
    _, card_again = run("cuda")
    _, cpu = run("cpu")
    rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    if not (all(np.isfinite(card)) and max(rel) <= DLRM_LOSS_RTOL):
        failed.append(f"dlrm: card losses {card} vs the CPU's {cpu} "
                      f"(relative {rel}, limit {DLRM_LOSS_RTOL})")
    mb = trainer.shard_batch(batch)
    for _ in range(DLRM_WARMUP):
        loss = trainer.train_step(mb)
    float(loss)
    t0 = time.perf_counter()
    for _ in range(DLRM_STEPS):
        loss = trainer.train_step(mb)
    loss_val = float(loss)
    dt = time.perf_counter() - t0
    if not np.isfinite(loss_val):
        failed.append(f"dlrm: final loss {loss_val}")
    step_time = dt / DLRM_STEPS
    return {
        "model": "criteo_wide_deep", "batch": DLRM_BATCH,
        "optimizer": "adagrad(0.05)", "warmup_steps": DLRM_WARMUP,
        "timed_steps": DLRM_STEPS,
        "dlrm_steps_per_sec": 1.0 / step_time,
        "examples_per_sec": DLRM_BATCH / step_time,
        "step_time_ms": step_time * 1e3, "table_rows": cfg.padded_vocab,
        "embed_dim": cfg.embed_dim, "final_loss": loss_val,
        "check": {"card": card, "cpu": cpu, "rel_err": rel,
                  "rtol": DLRM_LOSS_RTOL,
                  # printed only: the scatter-add order may differ
                  "two_card_runs_bitwise": card == card_again},
    }


def _cnn_steps(failed: list) -> dict:
    """The MNIST CNN at the example's batch under adam(1e-3), on the card
    and on the CPU from the same weights and digits."""
    import copy

    import numpy as np
    import torch

    from dlrover_tpu_torch.examples.cnn_train import make_digits
    from dlrover_tpu_torch.models import cnn, make_trainer_for
    from dlrover_tpu_torch.trainer.sharded import adam

    cfg = cnn.mnist_cnn()
    images, labels = make_digits()
    batches = [
        tuple(x[None, i * CNN_BATCH:(i + 1) * CNN_BATCH]
              for x in (images, labels))
        for i in range(CNN_STEPS)]
    init = cnn.init_params(cfg, seed=0, device="cpu")
    losses = {}
    for device in ("cuda", "cpu"):
        trainer = make_trainer_for(cfg, device=device, optimizer=adam(1e-3))
        trainer.init(model=copy.deepcopy(init))
        losses[device] = _steps(trainer, batches)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                 losses["cpu"])]
    if not (all(np.isfinite(losses["cuda"])) and max(rel) <= CNN_LOSS_RTOL):
        failed.append(f"cnn: card losses {losses['cuda']} vs the CPU's "
                      f"{losses['cpu']} (relative {rel}, limit "
                      f"{CNN_LOSS_RTOL})")
    return {"model": "mnist_cnn", "batch": CNN_BATCH,
            "optimizer": "adam(1e-3)", "steps": CNN_STEPS,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "card": losses["cuda"], "cpu": losses["cpu"], "rel_err": rel,
            "rtol": CNN_LOSS_RTOL}


def phase_families() -> dict:
    """The other model families on the card: GPT-2 XL's train step on the
    flash kernels, ``bench.py --model dlrm``'s recommender and the MNIST
    CNN. One line per family; raises after all three if any gate
    failed. Returns the GPT step's launches."""
    import torch

    failed = []
    t0 = time.perf_counter()
    gpt_line = _gpt_step(failed)
    emit({"phase": "families", **gpt_line})
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "families", **_dlrm_bench(failed)})
    # torch's defaults for the CNN, as a user gets them: phase "kernels"
    # turned TF32 off for the plain versions
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        emit({"phase": "families", **_cnn_steps(failed)})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "families", "seconds": time.perf_counter() - t0,
          "nvidia_smi": nvidia_smi_line()})
    if failed:
        raise AssertionError("families: " + "; ".join(failed))
    return gpt_line["launches"]


#: the launch phase: the example's steps, save cadence and injected crash
LAUNCH_STEPS, LAUNCH_SAVE, LAUNCH_CRASH = 12, 4, 10
#: the launch took 57-84 s on the H100, the phases before it about
#: 170 s: a hung launch is stopped, and its output read, well inside
#: a 600 s limit on the whole script
LAUNCH_TIMEOUT_S = 240


def _incarnations(stdout: str):
    """The example's ``step k loss x`` lines, one dict per incarnation
    (a new one starts where the step number does not grow)."""
    runs, last = [], None
    for k, x in re.findall(r"^step (\d+) loss (\S+)$", stdout, re.M):
        k = int(k)
        if last is None or k <= last:
            runs.append({})
        runs[-1][k] = float(x)
        last = k
    return runs


def _stop_launch(journal: str) -> None:
    """Kill whatever of the launch is still alive: every process whose
    environment names this launch's journal -- the launcher, the master,
    the agent and the workers, which run in sessions of their own."""
    tag = f"DLROVER_TPU_JOURNAL={journal}".encode()
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == os.getpid():
            continue
        try:
            with open(f"/proc/{entry}/environ", "rb") as f:
                if tag in f.read().split(b"\0"):
                    os.kill(int(entry), signal.SIGKILL)
        except (OSError, ProcessLookupError):
            pass


def _launch(ckpt_dir: str, journal: str, out_file: str, env: dict):
    """One run of the llama_1b loop under the launcher, as a user starts
    it, with the journal on and ``env`` (the fault to inject) added;
    stopped, and its output read, after LAUNCH_TIMEOUT_S. Returns the
    launcher's process, its stdout and its stderr."""
    cmd = [
        sys.executable, "-m", "dlrover_tpu_torch.trainer.elastic_run",
        "--standalone", "--nnodes", "1:1", "--monitor_interval", "0.3",
        "--max_restarts", "2", "dlrover_tpu_torch/examples/llama_train.py",
        "--", "--model", "llama_1b", "--batch-size", str(SLICE["b"]),
        "--seq-len", str(SLICE["s"]), "--steps", str(LAUNCH_STEPS),
        "--save-interval", str(LAUNCH_SAVE), "--ckpt-dir", ckpt_dir,
        "--out", out_file,
    ]
    proc = subprocess.Popen(cmd, cwd=ROOT,
                            env=dict(os.environ, DLROVER_TPU_JOURNAL=journal,
                                     **env),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        # a worker holds the pipes too: stop everything, then read
        _stop_launch(journal)
        stdout, stderr = proc.communicate(timeout=30)
    return proc, stdout, stderr


class _GoodputPoll:
    """Polls a master's ``/goodput`` on a background thread while a
    launch runs and keeps the last answer that carries a job account
    (the master stops serving when the launch ends)."""

    def __init__(self, port: int, interval: float = 0.2):
        import threading

        self.port, self.interval = port, interval
        self.last, self.answers = None, 0
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        import urllib.request

        while not self._done.is_set():
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{self.port}/goodput",
                        timeout=2) as resp:
                    answer = json.loads(resp.read())
                if answer.get("job"):
                    self.last = answer
                    self.answers += 1
            except OSError:
                pass
            self._done.wait(self.interval)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._done.set()
        self._thread.join(timeout=10)
        return False


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _replay(events, failed, what) -> dict:
    """The offline goodput replay of a launch's journal, held to its
    gates: each process's phases sum to its elapsed time within 1%, and
    at least 95% of each process's time is attributed (not idle)."""
    from dlrover_tpu_torch.telemetry import goodput

    report = goodput.reconstruct(events)
    for key, proc in report["procs"].items():
        elapsed = proc["elapsed_s"]
        if abs(sum(proc["phases"].values()) - elapsed) > 0.01 * elapsed:
            failed.append(f"{what}: {key}'s phases do not sum to its "
                          f"{elapsed} s")
        if proc["phases"]["idle"] > 0.05 * elapsed:
            failed.append(f"{what}: {key} attributes under 95% "
                          f"({proc['phases']})")
    if not report["procs"]:
        failed.append(f"{what}: the replay found no process")
    return report


def _goodput_line(report) -> dict:
    """Goodput %, badput by cause and MTTR of a summary."""
    job = report["job"]
    return {"goodput_percent": job["goodput_percent"],
            "attributed_percent": job["attributed_percent"],
            "badput_s": job["badput_s"], "mttr_s": job["mttr_s"],
            "faults": job["faults"], "procs": job["procs"],
            "wall_s": job["wall_s"]}


def _profiles(events) -> list:
    """Each worker's step profile after its first step (the example's
    ``train.profile``): FLOPs counted and the seconds it took."""
    return [e["data"] for e in events if e["kind"] == "train.profile"]


def _first(events, kind, after=-1, **data):
    """(index, event) of the first ``kind`` event after index ``after``
    whose data holds ``data``; (None, None) when there is none."""
    for i, e in enumerate(events):
        if (i > after and e["kind"] == kind
                and all(e["data"].get(k) == v for k, v in data.items())):
            return i, e
    return None, None


def _workers(events):
    """The device of each worker of a launch, and each worker's flash
    kernel launches per step it ran."""
    devices = [e["data"]["device"] for e in events
               if e["kind"] == "train.model_ready"]
    steps_by_pid = {}
    for e in events:
        if e["kind"] == "train.step":
            steps_by_pid.setdefault(e["pid"], []).append(e["data"])
    launches = [{k: n / len(steps) for k, n in steps[-1]["launches"].items()}
                for steps in steps_by_pid.values()]
    return devices, launches


def phase_launch() -> dict:
    """The elastic loop under the launcher, across a real process death:
    master, agent and worker are processes of their own, the worker is
    killed by the injected crash after step LAUNCH_CRASH, and the agent's
    new worker restores the newest checkpoint the journal saw committed
    before the crash."""
    import torch

    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.telemetry import read_journal

    # the worker needs the card's memory the earlier phases cached here
    gc.collect()
    torch.cuda.empty_cache()
    state_bytes = _state_bytes(llama.llama_1b(remat="dots_attn_out"))
    ram_dir, _, placed = _elastic_dirs(state_bytes)
    ckpt_dir = placed["tmp_dir"]
    if ram_dir != os.path.join(ckpt_dir, "ram"):
        # the example keeps its RAM tier in <ckpt-dir>/ram
        os.symlink(ram_dir, os.path.join(ckpt_dir, "ram"))
    journal = os.path.join(ckpt_dir, "journal.jsonl")
    out_file = os.path.join(ckpt_dir, "out.txt")
    # the master serves /goodput on a pinned port (the agent, started
    # after it, finds the port taken and serves none)
    metrics_port = _free_port()
    try:
        t_launch = time.time()
        with _GoodputPoll(metrics_port) as poll:
            proc, stdout, stderr = _launch(
                ckpt_dir, journal, out_file,
                {"DLROVER_FAULT_INJECT": f"crash@{LAUNCH_CRASH}",
                 "DLROVER_TPU_METRICS_PORT": str(metrics_port)})
        launch_s = time.time() - t_launch
        events = read_journal(journal) if os.path.exists(journal) else []
        out = (open(out_file).read().split(",")
               if os.path.exists(out_file) else [])
    finally:
        # none of the launch's processes outlives the phase
        _stop_launch(journal)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        shutil.rmtree(ram_dir, ignore_errors=True)

    failed = []
    if proc.returncode != 0:
        failed.append(f"launcher exit {proc.returncode}")
    if f"INJECTED CRASH rc=17 at step {LAUNCH_CRASH}" not in stdout:
        failed.append("no injected crash")
    i_crash, crash = _first(events, "fault.injected", fault="crash")
    # the newest step whose RAM-tier archive was committed before the
    # crash: what the restart must restore (never step 0)
    committed = sorted({
        e["data"]["step"] for e in events[:i_crash or 0]
        if e["kind"] == "checkpoint.save" and e["data"].get("ok")})
    want = committed[-1] if committed else None
    if not want:
        failed.append(f"no checkpoint committed before the crash "
                      f"({committed})")
    restarts = [e for e in events if e["kind"] == "scale.restart"]
    if len(restarts) != 1:
        failed.append(f"{len(restarts)} restarts, one expected")
    if f"RESTORED from step {want}" not in stdout:
        failed.append(f"no 'RESTORED from step {want}'")
    if f"FINAL step={LAUNCH_STEPS}" not in stdout:
        failed.append(f"no 'FINAL step={LAUNCH_STEPS}'")
    if out[:1] != [str(LAUNCH_STEPS)] or out[2:] != [str(want)]:
        failed.append(f"out file {out}, want step {LAUNCH_STEPS} and "
                      f"start_step={want}")
    devices, launches = _workers(events)
    if devices != ["cuda:0", "cuda:0"]:
        failed.append(f"workers ran on {devices}")
    layers = llama.llama_1b().num_layers
    if len(launches) != 2 or any(
            set(per_step.values()) != {layers} for per_step in launches):
        failed.append(f"kernel launches per step {launches}, "
                      f"{layers} of each expected")
    runs = _incarnations(stdout)
    both = sorted(set(runs[0]) & set(runs[1])) if len(runs) == 2 else []
    bitwise = {k: runs[1][k] == runs[0][k] for k in both}
    if len(runs) != 2 or not both or not all(bitwise.values()):
        failed.append(f"losses of the steps both incarnations ran: "
                      f"{bitwise} ({len(runs)} incarnations)")
    after_crash = i_crash or 0
    i_joined, joined = _first(events, "rendezvous.joined", after_crash)
    i_ready, ready = _first(events, "train.model_ready", after_crash)
    i_restore, restore = _first(events, "checkpoint.restore", after_crash)
    _, after = _first(events, "train.step", after=i_restore or 0,
                      step=(want or 0) + 1)
    _, step1 = _first(events, "train.step", step=1)
    marks = (crash, joined, ready, restore, after, step1)
    timeline = {}
    if restarts and all(marks):
        t_crash, t_restart = crash["ts"], restarts[0]["ts"]
        timeline = {
            "launch_to_first_step_s": step1["ts"] - t_launch,
            "crash_to_agent_restart_s": t_restart - t_crash,
            "agent_restart_to_process_start_s": joined["ts"] - t_restart,
            "process_start_to_model_on_card_s": ready["ts"] - joined["ts"],
            "model_on_card_to_restored_s": restore["ts"] - ready["ts"],
            "restore_s": restore["data"].get("duration_s"),
            "first_step_after_restore_s": after["ts"] - restore["ts"],
            "recovery_s": after["ts"] - t_crash,
        }
    else:
        failed.append("the journal lacks a mark of the recovery")
    # the job's account: the offline replay of the journal, and the
    # master's live /goodput
    report = _replay(events, failed, "launch")
    crash_windows = [f for f in report["faults"] if f["cause"] == "crash"]
    if len(crash_windows) != 1 or crash_windows[0]["recovered_ts"] is None:
        failed.append(f"the replay's crash windows {crash_windows}")
    gap = report["nodes"].get("0", {}).get("restart_gap_s", 0.0)
    if not gap > 0 or not report["job"]["badput_s"]["restart"] >= gap:
        failed.append(f"the replay booked the crash gap {gap} s as "
                      f"{report['job']['badput_s']}")
    live = poll.last
    if live is None:
        failed.append("the master's /goodput never answered")
    elif (live["nodes"].get("0", {}).get("procs", 0) < 2
          or not live["job"]["faults"]):
        failed.append(f"/goodput saw one incarnation of node 0 "
                      f"({live['nodes']})")
    profiles = _profiles(events)
    if len(profiles) != 2 or {p["device"] for p in profiles} != {"cuda"}:
        failed.append(f"each worker's step profile {profiles}")
    accounting = {
        "replay": {**_goodput_line(report), "restart_gap_s": gap,
                   "crash_window": crash_windows},
        "live": ({**_goodput_line(live), "answers": poll.answers,
                  "node0_procs": live["nodes"].get("0", {}).get("procs")}
                 if live else None),
        "profiles": profiles,
    }
    emit({
        "phase": "launch", "model": "llama_1b", "batch": SLICE["b"],
        "seq": SLICE["s"], "steps": LAUNCH_STEPS,
        "save_interval": LAUNCH_SAVE, "crash_step": LAUNCH_CRASH,
        "launcher_rc": proc.returncode, "launch_s": launch_s,
        "committed_before_crash": committed, "restored_step": want,
        "restarts": len(restarts), "devices": devices,
        "launches_per_step": launches,
        "steps_redone": both, "loss_bitwise": bitwise,
        "losses": runs, "state_bytes": state_bytes, **placed,
        **timeline, "goodput": accounting,
        "nvidia_smi": nvidia_smi_line(),
    })
    if failed:
        print(stdout[-4000:], stderr[-8000:], sep="\n", file=sys.stderr)
        raise AssertionError("launch: " + "; ".join(failed))
    return timeline


#: the drain phase: launch A is preempted after step DRAIN_PREEMPT with a
#: NOTICE-second window and a BUDGET-second drain; launch B's loss is
#: poisoned at step DRAIN_NAN, and the sentinel rolls it back to the
#: last clean save (step 8 at LAUNCH_SAVE = 4)
DRAIN_PREEMPT, DRAIN_NOTICE, DRAIN_BUDGET, DRAIN_NAN = 6, 30, 25, 10


def phase_drain() -> dict:
    """A preemption and a silent corruption under the launcher: launch
    A drains in the notice window and exits 21; its replacement, launch
    B on the same checkpoint directory with the RAM tier gone, restores
    the emergency save from the persist tier and rolls back a NaN."""
    import torch

    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.telemetry import read_journal

    gc.collect()
    torch.cuda.empty_cache()
    state_bytes = _state_bytes(llama.llama_1b(remat="dots_attn_out"))
    ram_dir, _, placed = _elastic_dirs(state_bytes)
    ckpt_dir = placed["tmp_dir"]
    if ram_dir != os.path.join(ckpt_dir, "ram"):
        os.symlink(ram_dir, os.path.join(ckpt_dir, "ram"))
    journals = [os.path.join(ckpt_dir, f"journal_{x}.jsonl") for x in "ab"]
    out_file = os.path.join(ckpt_dir, "out.txt")
    # the flight records of each launch (a SIGTERM writes one)
    crash_dirs = [os.path.join(ckpt_dir, f"crash_{x}") for x in "ab"]
    runs, launch_s, records = [], [], []
    try:
        for journal, crash_dir, env in zip(journals, crash_dirs, (
                {"DLROVER_FAULT_INJECT":
                 f"preempt@{DRAIN_PREEMPT}:notice={DRAIN_NOTICE}",
                 "DLROVER_TPU_PREEMPT_NOTICE_BUDGET": str(DRAIN_BUDGET)},
                {"DLROVER_FAULT_INJECT": f"nan@{DRAIN_NAN}"})):
            env = dict(env, DLROVER_TPU_CRASH_DIR=crash_dir)
            if runs:
                # a reclaimed host's tmpfs dies with it: the replacement
                # finds only the persist tier
                shutil.rmtree(ram_dir)
                os.makedirs(ram_dir)
            t_launch = time.time()
            try:
                proc, stdout, stderr = _launch(ckpt_dir, journal, out_file,
                                               env)
            finally:
                _stop_launch(journal)
            launch_s.append(time.time() - t_launch)
            events = (read_journal(journal) if os.path.exists(journal)
                      else [])
            runs.append((proc, stdout, stderr, events))
            records.append(sorted(os.listdir(crash_dir))
                           if os.path.isdir(crash_dir) else [])
    finally:
        for journal in journals:
            _stop_launch(journal)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        shutil.rmtree(ram_dir, ignore_errors=True)

    failed = []
    layers = llama.llama_1b().num_layers
    for name, (proc, _, _, events) in zip("AB", runs):
        devices, launches = _workers(events)
        if devices != ["cuda:0"]:
            failed.append(f"launch {name}: workers ran on {devices}")
        if len(launches) != 1 or set(launches[0].values()) != {layers}:
            failed.append(f"launch {name}: kernel launches per step "
                          f"{launches}, {layers} of each expected")
    (proc_a, out_a, _, ev_a), (proc_b, out_b, _, ev_b) = runs

    # launch A: drained at the end of the step, inside the budget
    if proc_a.returncode != 21:
        failed.append(f"launch A exit {proc_a.returncode}, 21 expected")
    if "INJECTED RECLAIM" in out_a:
        failed.append("launch A was reclaimed before it drained")
    i_notice, notice = _first(ev_a, "preempt.notice")
    i_rep, _ = _first(ev_a, "preempt.reported", after=i_notice or 0)
    i_ckpt, eck = _first(ev_a, "preempt.emergency_ckpt",
                         after=i_rep or 0)
    i_drained, drained = _first(ev_a, "preempt.drained",
                                after=i_ckpt or 0)
    if None in (i_notice, i_rep, i_ckpt, i_drained):
        failed.append("launch A's journal lacks preempt.notice -> "
                      "reported -> emergency_ckpt -> drained")
    elif not (eck["data"]["ok"] and eck["data"]["durable"]
              and not eck["data"]["timed_out"]
              and eck["data"]["step"] == DRAIN_PREEMPT):
        failed.append(f"emergency save {eck['data']}")
    _, relinquished = _first(ev_a, "preempt.relinquished")
    if relinquished is None:
        failed.append("the master requeued no shards of launch A")
    if _first(ev_a, "preempt.worker_exit")[1] is None:
        failed.append("the agent did not report PREEMPTED")
    if _first(ev_a, "scale.restart")[1] is not None:
        failed.append("the agent restarted the drained worker")

    # launch B: the persist tier's step, the rollback, the replay
    if proc_b.returncode != 0:
        failed.append(f"launch B exit {proc_b.returncode}")
    i_restore, restore = _first(ev_b, "checkpoint.restore")
    if (f"RESTORED from step {DRAIN_PREEMPT}" not in out_b
            or restore is None
            or restore["data"].get("tier") != "persistent"):
        failed.append(f"launch B did not restore step {DRAIN_PREEMPT} "
                      f"from the persist tier ({restore})")
    rollback_step = DRAIN_NAN - DRAIN_NAN % LAUNCH_SAVE
    _, trip = _first(ev_b, "anomaly.detected", anomaly="nonfinite_loss",
                     step=DRAIN_NAN)
    _, order = _first(ev_b, "rollback.initiated", step=rollback_step)
    i_rolled, rolled = _first(ev_b, "checkpoint.restore",
                              after=i_restore or 0)
    if trip is None or order is None or rolled is None:
        failed.append(f"no sentinel trip at step {DRAIN_NAN} rolled back "
                      f"to step {rollback_step}")
    if f"ROLLBACK to step {rollback_step}" not in out_b:
        failed.append(f"no 'ROLLBACK to step {rollback_step}'")
    b_runs = _incarnations(out_b)
    replay = rollback_step + 1
    if (len(b_runs) != 2 or b_runs[1].get(replay) is None
            or b_runs[1][replay] != b_runs[0].get(replay)
            or not math.isfinite(b_runs[1].get(DRAIN_NAN, math.nan))):
        failed.append(f"step {replay} replayed {b_runs}")
    if f"FINAL step={LAUNCH_STEPS}" not in out_b:
        failed.append(f"no 'FINAL step={LAUNCH_STEPS}'")

    # the job's account across both launches: the drain's final goodput
    # snapshot, and the replay's preempt and rollback badput
    if drained is not None and drained["data"].get("goodput") is not True:
        failed.append(f"the drain's goodput step failed {drained['data']}")
    report = _replay(ev_a + ev_b, failed, "drain")
    badput = report["job"]["badput_s"]
    if not (badput["preempt"] > 0 and badput["rollback"] > 0):
        failed.append(f"the replay's badput {badput}")
    rollback_windows = [f for f in report["faults"]
                        if f["cause"] == "rollback"]
    if not rollback_windows or any(f["recovered_ts"] is None
                                   for f in rollback_windows):
        failed.append(f"the replay's rollback windows {rollback_windows}")
    dumps = [e["data"]["reason"] for e in ev_a
             if e["kind"] == "flight.dumped"]
    if (dumps != ["signal-SIGTERM"] or len(records[0]) != 1
            or not records[0][0].endswith("signal-SIGTERM")):
        failed.append(f"launch A's flight records {dumps} {records[0]}")
    if notice is not None and drained is not None and (
            drained["ts"] - notice["ts"] > DRAIN_BUDGET):
        failed.append(f"the drain took {drained['ts'] - notice['ts']} s "
                      f"of a {DRAIN_BUDGET} s budget")
    profiles = _profiles(ev_a) + _profiles(ev_b)
    if len(profiles) != 2 or {p["device"] for p in profiles} != {"cuda"}:
        failed.append(f"each worker's step profile {profiles}")
    accounting = {"replay": {**_goodput_line(report),
                             "rollback_windows": rollback_windows},
                  "drain_goodput_step": (drained or {}).get(
                      "data", {}).get("goodput"),
                  "flight_records": records, "profiles": profiles}

    readings = {}
    if not failed:
        _, first_b = _first(ev_b, "train.step")
        readings = {
            "notice_to_drained_s": drained["ts"] - notice["ts"],
            "emergency_save_s": eck["data"]["elapsed_s"],
            "emergency_ram_tier_s": eck["data"]["ram_s"],
            "emergency_persist_s": eck["data"]["persist_s"],
            "emergency_pin_wait_s": eck["data"]["pin_wait_s"],
            "relinquish_s": relinquished["ts"] - eck["ts"],
            "replacement_restore_s": restore["data"]["duration_s"],
            "rollback_restore_s": rolled["data"]["duration_s"],
            "rollback_restore_tier": rolled["data"]["tier"],
            "notice_to_replacement_first_step_s":
                first_b["ts"] - notice["ts"],
        }
    emit({
        "phase": "drain", "model": "llama_1b", "batch": SLICE["b"],
        "seq": SLICE["s"], "steps": LAUNCH_STEPS,
        "save_interval": LAUNCH_SAVE, "preempt_step": DRAIN_PREEMPT,
        "notice_s": DRAIN_NOTICE, "budget_s": DRAIN_BUDGET,
        "nan_step": DRAIN_NAN, "rollback_step": rollback_step,
        "launcher_rc": [r[0].returncode for r in runs],
        "launch_s": launch_s, "losses_b": b_runs, **readings, **placed,
        "goodput": accounting, "nvidia_smi": nvidia_smi_line(),
    })
    if failed:
        for proc, stdout, stderr, _ in runs:
            print(stdout[-3000:], stderr[-6000:], sep="\n", file=sys.stderr)
        raise AssertionError("drain: " + "; ".join(failed))
    return readings


def main() -> int:
    if not (ROOT / "dlrover_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: dlrover_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    phase_env()
    phase_build()
    kernels = phase_kernels()
    launches, trainer, mb = phase_slice()
    phase_data(trainer, mb)
    del trainer, mb  # the card's memory goes back for the next phases
    phase_elastic()
    phase_eval()
    gpt_launches = phase_families()
    phase_launch()
    phase_drain()
    line = []
    # each shape's launches: its main path's run (the count reset just
    # before it), the Llama step of "slice" and the GPT step of "families"
    for shape, counts in (("llama_1b", launches), ("gpt2_xl", gpt_launches)):
        for name, r in kernels[shape].items():
            line.append({
                "name": name if shape == "llama_1b" else f"{name}@{shape}",
                "shape": shape, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": counts[name],
                "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            })
    emit({"kernels": line})
    print(nvidia_smi_line(), flush=True)
    # count: the cards this run used -- every phase runs on cuda:0
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
