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
6. the kernels line (one JSON object), then the card's name and power
   limit, then the device line, last.

Exits non-zero, and prints no result, when there is no CUDA device or
when the package is not beside this file.
"""

import json
import re
import statistics
import subprocess
import sys
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
