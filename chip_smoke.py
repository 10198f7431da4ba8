#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``dlrover_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: the three flash-attention kernels from ``ops/cuda/csrc``, with
   each kernel's registers, spills and dynamic shared memory;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the Llama-1.1B train step's attention shape and at one small
   non-causal shape, element by element; planted faults that the same
   rule must reject; each kernel launched twice at the step's shape,
   which must give the same bits; times beside the
   kernel's bound and PyTorch's own ``scaled_dot_product_attention`` as
   a yardstick;
4. slice: the Llama-1.1B (TinyLlama shape, 22 layers) train step,
   batch 3 x 2048, through ``make_trainer_for_llama`` on the card --
   launch counts, step time, tokens/s, MFU, peak memory -- and the
   model's hidden states and loss through the kernels against
   ``mha_reference``, with a wrong attention that must fail the gate;
5. profile: torch.profiler over two more train steps -- device time by
   kernel group, the top kernels and the device's idle share;
6. elastic: the elastic loop at the same width -- the master's data
   shards through a ShardingClient, ElasticTrainer steps, flash
   checkpoints at steps 4 and 8 -- then a crash, a fresh trainer
   restored from step 4 on the RAM tier (model, optimizer and data
   position), steps 5-8 again, and a restore from the persist tier:
   state checksums, shards and losses against the uninterrupted run,
   stall, staging, serialize, persist and restore times;
7. launch: the same llama_1b loop as a user runs it, under the elastic
   launcher (``python -m dlrover_tpu_torch.trainer.elastic_run
   --standalone``: the local master, the agent and the worker in
   processes of their own) with ``DLROVER_FAULT_INJECT=crash@10``: the
   worker dies after step 10, the agent restarts it, it restores the
   newest checkpoint committed before the crash and trains to step 12;
   the launcher's exit, the restore, the worker's card and the losses of
   the steps both incarnations ran (bitwise) are checked, and the
   journal's timestamps give the recovery and its parts;
8. drain: two launches of the same loop on one checkpoint directory.
   Launch A is preempted (``preempt@6:notice=30``, a 25 s drain budget):
   the worker drains at the end of step 6 -- the master told, a durable
   emergency save of step 6 on the persist tier, its shards handed back
   -- and exits 21, which the agent reports as PREEMPTED without a
   restart, so the launcher exits 21. The RAM tier is deleted, as a
   reclaimed host's tmpfs would be. Launch B, the replacement, restores
   step 6 from the persist tier, trips the sentinel on ``nan@10``, rolls
   back to step 8 on the master's order, replays step 9 (bitwise) and
   ends at step 12;
9. the kernels line (one JSON object), then the card's name and power
   limit, then the device line, last.

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
    fail ``closeness`` against the sound plain output. Needs a GQA group
    of at least 2 and 2 kv heads."""
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

    dk_first, dv_first = fa.dkv_plain(
        first_head(q), k, v, first_head(do), first_row(lse),
        first_row(delta), causal, scale)
    return {
        "fwd": [("k loop one tile short", "o", o_short),
                ("k loop one tile short", "lse", lse_short),
                ("wrong kv head", "o", o_head),
                ("wrong kv head", "lse", lse_head)],
        "dq": [("k loop one tile short", "dq", dq_short),
               ("wrong kv head", "dq", dq_head)],
        "dkv": [("group sum of one head", "dk", dk_first),
                ("group sum of one head", "dv", dv_first)],
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
    import torch

    # the plain versions' fp32 products must not drop to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check_kernels(SMALL, timed=False)
    results = check_kernels(SLICE, timed=True)
    for r in results.values():
        emit({"phase": "kernels", "shape": SLICE, "timing": {
            key: r[key] for key in (
                "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "flop", "bytes", "readings_ms",
                "library_readings_ms")}})
    return results


def phase_slice():
    import numpy as np
    import torch

    from dlrover_tpu_torch.auto.device_context import peak_flops_per_chip
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops.attention import flash_attention, mha_reference
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.reset_launches()
    for _ in range(WARMUP_STEPS):
        trainer.train_step(mb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        loss = trainer.train_step(mb)
    loss_val = float(loss)  # the one sync: waits for the whole chain
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    launches = dict(fa.LAUNCHES)
    steps = WARMUP_STEPS + TIMED_STEPS
    if not np.isfinite(loss_val):
        raise AssertionError(f"train loss is {loss_val}")
    for name, n in launches.items():
        if n != cfg.num_layers * steps:
            raise AssertionError(
                f"{name} launched {n} times in {steps} steps, want "
                f"{cfg.num_layers} per step")
    peak_mem = torch.cuda.max_memory_allocated()

    # the trained model at full width through the kernels, through the
    # plain reference attention, and through a wrong one
    def wrong_attention(q, k, v):
        return mha_reference(q, k.roll(1, dims=2), v.roll(1, dims=2))

    attns = {"kernel": flash_attention, "reference": mha_reference,
             "wrong": wrong_attention}
    batch0 = tuple(x[0] for x in mb)
    with torch.no_grad():
        hidden = {n: trainer.model.hidden_states(batch0[0], attn_fn=f)
                  for n, f in attns.items()}
        losses = {n: float(llama.next_token_loss(trainer.model, batch0,
                                                 attn_fn=f))
                  for n, f in attns.items()}
    ref = hidden["reference"].float()
    hidden_err = {n: ((hidden[n].float() - ref).norm() / ref.norm()).item()
                  for n in ("kernel", "wrong")}
    loss_err = {n: abs(losses[n] - losses["reference"])
                for n in ("kernel", "wrong")}
    emit({"phase": "slice_check", "loss": losses,
          "loss_abs_err": loss_err, "hidden_rel_norm_err": hidden_err,
          "hidden_tol": HIDDEN_TOL, "loss_tol": LOSS_TOL})
    if hidden_err["kernel"] > HIDDEN_TOL or loss_err["kernel"] > LOSS_TOL:
        raise AssertionError(
            f"model through kernels vs mha_reference: hidden states "
            f"{hidden_err['kernel']} (limit {HIDDEN_TOL}), loss "
            f"{loss_err['kernel']} (limit {LOSS_TOL})")
    if hidden_err["wrong"] <= HIDDEN_TOL:
        raise AssertionError(
            f"a wrong attention passes the hidden-state gate: "
            f"{hidden_err['wrong']} <= {HIDDEN_TOL}")
    loss_kernel, loss_ref = losses["kernel"], losses["reference"]

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
        "max_memory_allocated_bytes": peak_mem,
        "final_loss": loss_val, "loss_kernel": loss_kernel,
        "loss_reference": loss_ref,
        "launches_per_step": {n: c / steps for n, c in launches.items()},
    })
    return launches


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


def phase_profile(trainer, mb, step_ms: float, steps: int = 2) -> None:
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
        "phase": "profile", "steps": steps,
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
    try:
        t_launch = time.time()
        proc, stdout, stderr = _launch(
            ckpt_dir, journal, out_file,
            {"DLROVER_FAULT_INJECT": f"crash@{LAUNCH_CRASH}"})
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
        **timeline, "nvidia_smi": nvidia_smi_line(),
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
    runs, launch_s = [], []
    try:
        for journal, env in zip(journals, (
                {"DLROVER_FAULT_INJECT":
                 f"preempt@{DRAIN_PREEMPT}:notice={DRAIN_NOTICE}",
                 "DLROVER_TPU_PREEMPT_NOTICE_BUDGET": str(DRAIN_BUDGET)},
                {"DLROVER_FAULT_INJECT": f"nan@{DRAIN_NAN}"})):
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
        "nvidia_smi": nvidia_smi_line(),
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
    launches = phase_slice()
    phase_elastic()
    phase_launch()
    phase_drain()
    line = []
    for name, r in kernels.items():
        line.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
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
