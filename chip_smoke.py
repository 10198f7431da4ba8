#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``dlrover_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: the three flash-attention kernels from ``ops/cuda/csrc``, with
   each kernel's registers, spills and dynamic shared memory;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the Llama-1.1B train step's attention shape (GQA group 8), at
   GPT-2 XL's (25 heads over 25 kv heads, group 1), at the Llama step's
   heads split over two tensor ranks (16 over 2), at phase "sequence"'s
   (the ring's chunk of 8,192 tokens, causal and non-causal; Ulysses'
   16,384 tokens at 16 over 2 heads: their plain versions a kv-head
   group at a time), at phase "pipeline"'s microbatch (one row of 2,048
   tokens), at gpt2_small's heads over two tensor ranks (phase "auto")
   and at one small non-causal shape, element by
   element; planted faults that the same rule must reject (at the train
   steps' and the tp shapes); each kernel launched twice at every timed
   shape, which must give the same bits; times there beside the
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
7. optim: ``optim/`` on the same Llama-1.1B step, the first trainer
   freed: 3 AdamW steps from seed 0, then 3 ``bf16_adamw(1e-4,
   guard_nonfinite=True)`` steps from the same seed (fp32 masters, a
   bf16 first moment: 10 bytes of state per parameter, AdamW's printed
   beside it) -- every bf16 parameter its master rounded, the losses
   within 1e-2 of AdamW's -- then a fourth step with an inf planted in
   one element of the embedding's gradient, which must leave the
   parameters, masters and moments bitwise as they were (the state's
   checksums), give ``guard_stats`` (1, non-finite) and make the
   sentinel report ``nonfinite_grad``; then 2 steps under
   ``wsam_value_and_grad`` (44 launches of each kernel a step). Each
   step's ms is printed;
8. elastic: the elastic loop at the same width -- the master's data
   shards through a ShardingClient, ElasticTrainer steps, flash
   checkpoints at steps 4 and 8 -- then a crash, a fresh trainer
   restored from step 4 on the RAM tier (model, optimizer and data
   position), steps 5-8 again, and a restore from the persist tier:
   state checksums, shards and losses against the uninterrupted run,
   stall, staging, serialize, persist and restore times;
9. eval: the checkpoint evaluator -- a llama_1b state trains 4 steps; at
   steps 2 and 4 its held-out loss (a 3 x 2048 batch from seed 9999) is
   computed directly and the state saved durably; a
   ``CheckpointEvaluator`` restores each step into a fresh model,
   evaluates it through the flash forward and reports it over RPC, as
   an evaluator node, into a master service's job metric collector.
   Gates: steps [2, 4] evaluated once each, each loss bitwise the direct
   one, 22 forward launches and no backward launch per evaluation, the
   collector holding step 4 and its loss; restore seconds, forward ms
   and save-to-report seconds are printed;
10. families: the other model families. GPT-2 XL (48 layers, hidden
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
11. launch: the llama_1b loop as a user runs it (at full width, cut to
   ``LAUNCHER_LAYERS`` = 4 layers, as are phases 12 and 13), under the elastic
   launcher (``python -m dlrover_tpu_torch.trainer.elastic_run
   --standalone``: the local master, the agent and the worker in
   processes of their own; the example's ``--strategy ddp``, as in
   phases 12 and 13) with ``DLROVER_FAULT_INJECT=crash@10``: the
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
12. drain: two launches of the same loop on one checkpoint directory.
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
13. world: several processes. One master service of its own and two
    launchers (``--nnodes 2:2 --node_rank {0,1} --network-check``), each
    supervising one worker; both workers run on ``cuda:0`` in one gloo
    group (``--dist-backend gloo``: NCCL refuses two ranks on one
    device) with ``DLROVER_TPU_DIST_HEARTBEAT_TIMEOUT=10``, the
    example's ``--strategy ddp``. The same
    llama_1b (4 layers), batch 3 x 2048 per rank,
    flash saves every 4 steps on both tiers (each persisted before the
    loop goes on), ``crash@10:host=1``, node 1's RAM tier deleted
    before its worker comes back. Gates: both network-check rounds
    passed for both nodes and the master's verdict says so; 4 launches
    of each kernel per rank per step; the state's checksums equal on
    both ranks at steps 4, 8 and 12; the ranks' losses equal at every
    step; in step 8's committed manifest each tensor written by exactly
    the rank that owns it, the owned bytes summing to the state's, and
    COMMIT with both index pieces, after both; both ranks restore step
    8 by consensus with the checksums saved, rank 1 over rank 0's
    ``/ckpt/shard``; steps 9-10 replayed bitwise; both launchers exit 0
    with ``FINAL step=12``. Printed: step and reduction ms, save stalls
    and bytes, restore seconds and peer bytes, ``recovery_s``;
14. mesh: the sharding strategies across ranks (``trainer/sharded.py``),
    the same llama_1b cut to 4 layers, batch 3 x 2048 per data-parallel
    rank, AdamW(1e-4, 0.9, 0.95), 1 warm-up and 3 timed steps each (2
    for tp_fsdp, for the script's time limit). Two gloo ranks on
    ``cuda:0`` run zero1 and zero2 on (fsdp 2) and tp on (tensor 2), in
    the same processes; four run tp_fsdp on (fsdp 2, tensor 2). (fsdp on
    (fsdp 2), at the same model and batch, runs in phase "reshard" under
    the same loss, parameter and byte gates, its saves restored bitwise
    at one rank and at two, for the script's time limit; ``run_mesh``'s
    default runs it here too.)
    The reference is the port's one-process step on the card from the
    same weights on each global batch. Gates: each step's loss within
    MESH_LOSS_RTOL (1e-3) relative of the reference's; at least
    MESH_WITHIN_SHARE (99.9%) of every rank's kept parameter elements
    within 2 lr and one bf16 storage ulp of the reference's same
    element after as many steps, and every element within 2 lr and one
    ulp per step taken (a zero1 step without the data-parallel sum and
    an fsdp step without the update fail the first, PERF.md;
    ``tests/test_torch_mesh_gpu.py`` plants them); per rank,
    optimizer-state bytes equal
    to the bytes of the domains the rank holds, and to the layout's
    share (half at fsdp 2 or tensor 2, a quarter at 2 x 2), parameter
    bytes halved under tp; 4 launches of each kernel per rank per step,
    every rank on ``cuda:0``. Printed per strategy: step and collective ms,
    peak memory, bytes per rank, the parameters' share within 2 lr and
    their update's relative error; the collective route of the layer.
    Then, in the same two ranks, the Llama state freed, "rowwise" on
    (data 1, fsdp 2): (a) criteo_wide_deep (734,208 rows) at batch 4096,
    3 adagrad(0.05) steps against the one-process step from the same
    seed -- losses within 1e-5 relative, every parameter within 1e-5 of
    its largest element, each rank holding half the tables' bytes --
    and the save of step 3 restored bitwise into this process; (b)
    dlrm_large at 100M rows (100,000,768 padded, embed 32, bottom MLP
    64-32; each rank draws only its own rows), batch 4096, 1 warm-up and
    3 timed steps, then a gated step: the lookup on its ids equal to the
    rows fetched from the two shards on the host, a finite loss, every
    row the batch touched changed and no other row (chunked checksums).
    Printed: step ms, the lookup's all-reduce ms per step, table bytes
    and peak memory per rank. A rowwise step without the all-reduce
    fails the parity gate (``tests/test_torch_rowwise_gpu.py``);
15. sequence: long context (``parallel/context_parallel.py``), the
    same llama_1b cut to 4 layers at one sequence of 16,384 tokens a
    step, ``max_seq_len=16384``, AdamW(1e-4, 0.9, 0.95), 1 warm-up and 2
    timed steps, in two gloo ranks on ``cuda:0`` under "sequence" on (seq
    2), each rank holding 8,192 tokens: ring attention (the flash kernels
    per chunk: causal on the diagonal, non-causal on the earlier chunk,
    no launch on a later one), then Ulysses (all-to-all, the kernels on
    the whole sequence at 16 over 2 heads), each against the port's
    one-process step at 16,384 from the same seed. Gates: losses within
    MESH_LOSS_RTOL and phase "mesh"'s parameter gates; under ring rank i
    launches each kernel i + 1 times a layer a step, under Ulysses once;
    a ring that drops every chunk but the diagonal must fail the gates;
    first, the ring Function alone at RING_SMALL on the card against the
    same Function on host copies (the kernels' plain versions), under the
    kernels' element rule. Printed per rank: step and collective ms, the
    bytes ppermute and all_to_all sent a step, launches per step by
    shape, peak memory; the collective route of each op;
16. moe: the MoE Llama (``parallel/moe.py``): llama_1b's width with 4
    experts, top-2, capacity factor 1.25 (llama_moe_tiny's experts and
    k), cut to 4 layers, batch 3 x 2048, AdamW(1e-4, 0.9, 0.95), 1
    warm-up and 2 timed steps: one process, then two gloo ranks under
    tp_fsdp on (expert 2), each holding two experts. Gates: layer 0's
    dispatch on the first batch equal to the one process's, bit for bit;
    losses (with the auxiliary loss) within MESH_LOSS_RTOL; the parameter
    gates; each rank holding half of the experts' bytes; 4 launches of
    each kernel a rank a step. Printed: the dropped share of layer 0's
    choices, aux, step ms, MFU from the MoE ``flops_per_token``, peak
    memory;
17. pipeline: pipeline parallelism (``parallel/pipeline.py``), the same
    llama_1b cut to 4 layers, batch 4 x 2048 in 4 pipeline microbatches
    of one row, AdamW(1e-4, 0.9, 0.95), 1 warm-up and 2 timed steps, in
    two gloo ranks on ``cuda:0`` under "pipeline" on (pipe 2): GPipe
    (rank 0 holds layers 0-1, rank 1 layers 2-3), then the interleaved
    schedule with two chunks a stage (rank 0 layers 0 and 2, rank 1
    layers 1 and 3), each against the port's one-process step from the
    same seed, then GPipe with a planted fault: the embedding's
    gradient, which arises on stage 0, not summed over pipe. Gates:
    losses within MESH_LOSS_RTOL and phase "mesh"'s parameter gates;
    the replicated leaves (embed, final norm, head) equal to the bit on
    both ranks; each rank holding its stage's layers; the bytes each
    rank sends a step (the activations' and dX's sends of one
    microbatch, 8,388,608 bytes each, the outputs' all-reduce, the
    embedding gradient's) and the measured bubble (0.2, 1/9) as the
    schedule says; per rank per step 2 x 4 x 2 launches of the forward
    kernel (remat "dots" recomputes attention) and 4 x 2 of dQ and dK/dV
    at the microbatch's shape (1, 2048, 32, 4, 64); the planted run must
    fail. Printed per rank: step and collective ms, bytes by op, the
    measured and predicted bubble, launches per step by shape, peak
    memory;
18. auto: the strategy search (``auto/``). One process: llama_1b
    uncut at batch 3 x 2048 through ``auto_accelerate(dryrun_top_k=2)``
    -- every candidate's report (the analytic time and memory, the
    dryrun's ms and its peak ``max_memory_allocated``), no dryrun error
    but out of memory or an indivisible split -- its winner's 3 steps
    bitwise equal to ``make_trainer_for_llama``'s with the same strategy
    and seed, their launches (22 a step of each kernel, the forward
    twice where remat recomputes attention), ``dryrun_abstract``'s
    argument, temp and output bytes, and how the analytic estimates
    fare on the card; one step at batch 1 x ``SINGLE_CHIP_MAX_SEQ``
    under 0.9 x the card's memory. Then two gloo ranks on ``cuda:0``:
    ``auto_accelerate(global_batch=6, seq_len=2048, bo_iters=1)`` over
    llama_1b cut to ``MESH_LAYERS`` -- both ranks the same winner and
    the same agreed seconds -- its winner, a planned table (the planner
    under three quarters of what the replicated plan needs), gpt2_xl cut
    to 4 layers under fsdp on (fsdp 2), gpt2_small uncut under tp on
    (tensor 2) at its 50,257 vocab (its rows split 25,129 and 25,128)
    and the MNIST CNN under fsdp, 2 steps each against the one-process
    step under "mesh"'s gates, and gpt2_small's 12 launches of each
    kernel a rank a step at its tp shape (B=8, S=1024, H=KVH=6, D=64),
    which phase 3 checks too;
19. reshard: reshard-in-place (``reshard/``), the llama_1b of "mesh"
    (4 layers) under fsdp, 3 x 2048 a data-parallel rank,
    AdamW(1e-4, 0.9, 0.95), two gloo ranks on ``cuda:0`` against a
    master servicer built with a ``TransitionCoordinator`` (this process
    plays the distributed master's part), a flash checkpoint every step
    (durable on the RAM tier, persisted behind the next step, committed
    before rank 1's death and before the survivor idles). Two steps, the
    world sealed; ``node_lost@3:host=1`` SIGKILLs rank 1 after its
    step-3 save is committed; rank 0's step 4 fails in a
    gloo collective, it adopts the shrink order, re-forms a world of one
    in process and migrates live (its half from its live tensors, rank
    1's from the store), 2 steps at world 1 (two microbatches); a joiner
    reports RUNNING, the grow order re-forms a world of two, rank 0
    migrates live and the joiner assembles its half over rank 0's
    ``/ckpt/shard``, 2 steps at world 2. Gates: each migrated
    state bitwise a fresh one-process ``restore(step=pinned)``'s, the
    steps after each transition against the one-process step from it
    ("mesh"'s loss and parameter gates), "mesh"'s byte gates at every
    step (parameter bytes halved at world 2, optimizer bytes those of
    the domains the rank holds, the moments fp32 after world 1), the
    final world-2 save restored bitwise at world 2 from the store, the
    survivor's pid, both orders
    completed, the journal's replay with a reshard window and no
    restart, ``live``, ``store`` and ``peer`` moves with no digest
    mismatch, 4 (8 at world 1) launches of each kernel a step, a planted
    stale-live migration caught by the bitwise gate. Printed: adopt to
    completed ms per transition and rank, the kill to the end of the
    first world-1 step (``recovery_s``, as "launch" reads it), the
    survivor's reshard windows, migration seconds and bytes by source,
    the joiner's start and its RUNNING to its first step, step and save
    times, launches a step;
20. the wall seconds of each phase, then the kernels line (one JSON
    object; each kernel at both train steps' shapes, at the tp shape of
    "mesh", with ``mesh_launches``, at the shapes of "sequence", at
    the microbatch shape of "pipeline" and at gpt2_small's tp shape of
    "auto"; the Llama step's rows carry ``auto_launches``, the winner's
    of "auto", and ``reshard_launches``, phase "reshard"'s), then the
    card's name and power limit, then the device line, last.

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


#: the plain versions' fp32 scores above this many bytes are computed a
#: kv-head group at a time (the groups are independent of each other)
PLAIN_SCORES_BYTES = 2 ** 31


def _plain_parts(q, k) -> int:
    """1, or the kv heads when the plain versions' fp32 scores of q
    would pass PLAIN_SCORES_BYTES."""
    b, s, h, _ = q.shape
    return 1 if 4 * b * h * s * s <= PLAIN_SCORES_BYTES else k.shape[2]


def _plain(name: str, args):
    """The plain version of kernel ``name`` on ``args`` (q, k, v, then
    for the backward do, lse, delta; then causal, scale), a kv-head
    group at a time when its fp32 scores would pass PLAIN_SCORES_BYTES:
    the same equations on each group's heads, joined along the heads."""
    import torch

    from dlrover_tpu_torch.ops.cuda import flash_attention as fa

    fn = {"fwd": fa.fwd_plain, "dq": fa.dq_plain, "dkv": fa.dkv_plain}[name]
    q, k = args[0], args[1]
    parts = _plain_parts(q, k)
    if parts == 1:
        return fn(*args)
    g = q.shape[2] // parts
    outs = []
    for j in range(parts):
        heads, kv = slice(j * g, (j + 1) * g), slice(j, j + 1)
        part = [x[:, :, heads] for x in args[:1]]
        part += [x[:, :, kv] for x in args[1:3]]
        if name != "fwd":
            do, lse, delta = args[3:6]
            part += [do[:, :, heads], lse[:, heads], delta[:, heads]]
        got = fn(*[x.contiguous() for x in part], *args[-2:])
        outs.append(got if isinstance(got, tuple) else (got,))
        torch.cuda.empty_cache()
    joined = []
    for i, first in enumerate(outs[0]):
        dim = 1 if first.dim() == 3 else 2  # lse [b, h, s]; else heads
        joined.append(torch.cat([o[i] for o in outs], dim=dim))
    return tuple(joined) if len(joined) > 1 else joined[0]


def check_kernels(shape, timed: bool, planted: bool = True):
    """Hold each kernel against its plain version at ``shape``; with
    ``timed`` also time kernel, plain version and library call, and
    check a bitwise repeat and (with ``planted``) that planted faults
    fail the rule. One dict per kernel."""
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
    o_ref, lse_ref = _plain("fwd", (q, k, v, causal, scale))
    delta = fa.attention_delta(o, do)
    args = (q, k, v, do, lse, delta, causal, scale)
    dq = fa.dq(*args)
    dq_ref = _plain("dq", args)
    dk, dv = fa.dkv(*args)
    dk_ref, dv_ref = _plain("dkv", args)
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
        for name, faults in (planted_faults(*args).items() if planted
                             else ()):
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
    plains = {"fwd": lambda: _plain("fwd", (q, k, v, causal, scale)),
              "dq": lambda: _plain("dq", args),
              "dkv": lambda: _plain("dkv", args)}
    for name, plain in plains.items():
        flops, nbytes = work[name]
        t_ops, t_bytes = flops / peak, nbytes / rate
        out[name].update(
            kernel_ms=min(readings[name]),
            # a plain version a kv group at a time takes a few hundred ms
            # a call: one timing after its warm-up
            plain_ms=time_ms(plain, reps=1 if _plain_parts(q, k) > 1
                             else 3),
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=min(readings[library[name]]), flop=flops,
            bytes=nbytes, readings_ms=readings[name],
            library_readings_ms=readings[library[name]],
        )
    return out


def phase_kernels():
    """{shape name: check_kernels' dicts} at the Llama-1.1B step's shape,
    at its heads split over 2 tensor ranks (phase "mesh"'s tp and
    tp_fsdp), at GPT-2 XL's, at phase "sequence"'s -- the ring's chunk
    causal and non-causal, Ulysses' whole sequence -- at phase
    "pipeline"'s microbatch and at gpt2_small's heads over two tensor
    ranks (phase "auto"), all timed (planted faults at the two train
    steps' shapes and the two tp shapes)."""
    import torch

    # the plain versions' fp32 products must not drop to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check_kernels(SMALL, timed=False)
    results = {}
    for name, shape in (("llama_1b", SLICE), ("llama_1b_tp", SLICE_TP),
                        ("gpt2_xl", GPT), ("ring_chunk", RING_CHUNK),
                        ("ring_chunk_full", RING_FULL),
                        ("ulysses", ULYSSES), ("pipeline_mb", PIPE_MB),
                        ("gpt2_small_tp", GPT_TP)):
        t0 = time.perf_counter()
        results[name] = check_kernels(
            shape, timed=True,
            planted=name in ("llama_1b", "llama_1b_tp", "gpt2_xl",
                             "gpt2_small_tp"))
        torch.cuda.empty_cache()
        emit({"phase": "kernels", "shape": shape,
              "seconds": time.perf_counter() - t0})
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
        out["restored_checksums"] = ckpt_store.state_checksums(
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
            out.setdefault("checksums", {})[step] = ckpt_store.state_checksums(
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
        persist_checksums = ckpt_store.state_checksums(restored)
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
#: the phases under the launcher ("launch", "drain", "world") run
#: llama_1b's widths at this depth: each restart starts a process that
#: builds the model and writes, reads and persists its state, and at 22
#: layers (6.6 GB of state) they took the whole script past its 480 s.
#: Phase "elastic" saves and persists the whole 22-layer state
LAUNCHER_LAYERS = 4
#: the launch took 57-84 s on the H100, the phases before it about
#: 170 s: a hung launch is stopped, and its output read, well inside
#: a 600 s limit on the whole script
LAUNCH_TIMEOUT_S = 240


def _launcher_cfg():
    """The config the launcher phases' workers train (``--model llama_1b
    --num-layers LAUNCHER_LAYERS``)."""
    import dataclasses

    from dlrover_tpu_torch.models import llama

    return dataclasses.replace(llama.llama_1b(remat="dots_attn_out"),
                               num_layers=LAUNCHER_LAYERS)


def _incarnations(stdout: str):
    """The example's ``step k loss x`` lines, one dict per incarnation
    (a new one starts where the step number does not grow)."""
    runs, last = [], None
    for k, x in re.findall(r"^step (\d+) loss (\S+)(?: world \d+)?$",
                           stdout, re.M):
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
        "--", "--model", "llama_1b", "--num-layers", str(LAUNCHER_LAYERS),
        "--batch-size", str(SLICE["b"]),
        "--seq-len", str(SLICE["s"]), "--steps", str(LAUNCH_STEPS),
        "--save-interval", str(LAUNCH_SAVE), "--ckpt-dir", ckpt_dir,
        "--out", out_file, "--strategy", "ddp",
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

    from dlrover_tpu_torch.telemetry import read_journal

    # the worker needs the card's memory the earlier phases cached here
    gc.collect()
    torch.cuda.empty_cache()
    state_bytes = _state_bytes(_launcher_cfg())
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
    layers = LAUNCHER_LAYERS
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
        "phase": "launch", "model": "llama_1b",
        "layers": LAUNCHER_LAYERS, "batch": SLICE["b"],
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

    from dlrover_tpu_torch.telemetry import read_journal

    gc.collect()
    torch.cuda.empty_cache()
    state_bytes = _state_bytes(_launcher_cfg())
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
    layers = LAUNCHER_LAYERS
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
        "phase": "drain", "model": "llama_1b",
        "layers": LAUNCHER_LAYERS, "batch": SLICE["b"],
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


#: phase "world": two nodes of one worker each, both on cuda:0 in one
#: gloo group (NCCL refuses two ranks on one device), llama_1b at full
#: width cut to LAUNCHER_LAYERS layers, each rank at batch 3 x 2048;
#: flash saves every WORLD_SAVE steps on both tiers, node 1's worker crashes
#: after step WORLD_CRASH and its RAM tier is deleted before it comes
#: back; both ranks restore by consensus and train to WORLD_STEPS
WORLD_STEPS, WORLD_SAVE, WORLD_CRASH = 12, 4, 10
#: collectives on a dead peer give up after this many seconds
WORLD_HEARTBEAT_S = 10
WORLD_TIMEOUT_S = 300


def phase_world() -> dict:
    """Two ranks on one card under two launchers against one master: the
    pre-flight network check, the ddp step with its gradients reduced
    over the ranks, flash checkpoints each rank persists only its owned
    part of, a crash of node 1 whose RAM tier is lost, and the consensus
    restore with node 1 fetching over rank 0's peer tier."""
    import threading

    import torch

    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.checkpoint import manifest as mf
    from dlrover_tpu_torch.telemetry import read_journal
    from dlrover_tpu_torch.trainer import ckpt_store
    from dlrover_tpu_torch.trainer.elastic_run import launch_local_master

    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="dlrover_world_")
    journal = os.path.join(tmp, "journal.jsonl")
    ckpt_dir = os.path.join(tmp, "ckpt")
    ram_dirs = [os.path.join(tmp, f"ram{r}") for r in range(2)]
    outs, lost, verdicts = [[], []], [], []
    t_phase = time.time()
    master = None
    try:
        master, master_addr = launch_local_master(2)
        env = dict(os.environ, DLROVER_TPU_JOURNAL=journal,
                   DLROVER_FAULT_INJECT=f"crash@{WORLD_CRASH}:host=1",
                   DLROVER_TPU_DIST_HEARTBEAT_TIMEOUT=str(WORLD_HEARTBEAT_S))
        procs = []
        for rank in range(2):
            cmd = [
                sys.executable, "-m", "dlrover_tpu_torch.trainer.elastic_run",
                "--master_addr", master_addr, "--nnodes", "2:2",
                "--node_rank", str(rank), "--network-check",
                "--monitor_interval", "0.3", "--max_restarts", "2",
                "dlrover_tpu_torch/examples/llama_train.py", "--",
                "--model", "llama_1b", "--num-layers", str(LAUNCHER_LAYERS),
                "--batch-size", str(SLICE["b"]), "--seq-len", str(SLICE["s"]),
                "--steps", str(WORLD_STEPS), "--save-interval",
                str(WORLD_SAVE), "--persist-interval", str(WORLD_SAVE),
                "--ckpt-dir", ckpt_dir,
                "--ram-dir", ram_dirs[rank], "--dist-backend", "gloo",
                "--checksums", "--strategy", "ddp",
            ]
            procs.append(subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, start_new_session=True))

        def read(rank):
            for line in procs[rank].stdout:
                outs[rank].append(line)
                if rank == 0 and not verdicts and line.startswith("step "):
                    # the agents train only once the pre-flight check
                    # passed; ask for its verdict now, for the master
                    # exits on its own soon after the launchers do
                    try:
                        verdicts.append(tuple(MasterClient(
                            master_addr, node_id=0, node_type="worker",
                            reconnect_timeout=30.0).network_check_success()))
                    except Exception as e:  # noqa: BLE001 - reported below
                        verdicts.append(repr(e))
                if rank == 1 and line.startswith("INJECTED CRASH"):
                    # a replaced host comes back without its tmpfs
                    shutil.rmtree(ram_dirs[1], ignore_errors=True)
                    lost.append(time.time())

        readers = [threading.Thread(target=read, args=(r,), daemon=True)
                   for r in range(2)]
        for t in readers:
            t.start()
        deadline = time.time() + WORLD_TIMEOUT_S
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                _stop_launch(journal)
                p.wait(timeout=30)
        for t in readers:
            t.join(timeout=30)
        world_s = time.time() - t_phase
        verdict = verdicts[0] if verdicts else "not asked: no step on rank 0"
        store = ckpt_store.get_store(os.path.join(ckpt_dir, "persist"))
        committed = ckpt_store.committed_steps(store)
        man8 = (ckpt_store.step_manifest(store, 2 * WORLD_SAVE)
                if 2 * WORLD_SAVE in committed else None)
        keys8 = set(store.list(f"step-{2 * WORLD_SAVE}/"))
        events = read_journal(journal) if os.path.exists(journal) else []
    finally:
        _stop_launch(journal)
        if master is not None:
            master.kill()
            master.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    stdout = ["".join(o) for o in outs]

    failed = []
    rcs = [p.returncode for p in procs]
    if rcs != [0, 0]:
        failed.append(f"launcher exits {rcs}")
    for rank in range(2):
        if f"FINAL step={WORLD_STEPS} " not in stdout[rank]:
            failed.append(f"node {rank}: no 'FINAL step={WORLD_STEPS}'")
    if not lost:
        failed.append("node 1 did not crash")
    # the pre-flight check: both rounds passed for both nodes
    rounds = [e["data"] for e in events if e["kind"] == "network_check.round"]
    if (sorted((d["node_rank"], d["round"]) for d in rounds)
            != [(0, 0), (0, 1), (1, 0), (1, 1)]
            or not all(d["normal"] and d["success"] for d in rounds)
            or verdict != (True, "")):
        failed.append(f"network check {rounds}, verdict {verdict}")
    # the ddp step: 4 launches of each kernel per rank per step, every
    # step's loss equal on both ranks, steps 9-10 bitwise on replay
    steps = [e for e in events if e["kind"] == "train.step"]
    per_pid = {}
    for e in steps:
        per_pid.setdefault(e["pid"], []).append(e["data"])
    launches = [{k: n / len(v) for k, n in v[-1]["launches"].items()}
                for v in per_pid.values()]
    # each worker journals its launches since it started: the phase's
    # total over both ranks and both incarnations
    world_launches = {k: sum(v[-1]["launches"][k] for v in per_pid.values())
                      for k in REPLACES}
    if len(launches) != 4 or any(set(per.values()) != {LAUNCHER_LAYERS}
                                 for per in launches):
        failed.append(f"kernel launches per step {launches}, "
                      f"{LAUNCHER_LAYERS} of each per rank expected")
    runs = [_incarnations(out) for out in stdout]
    if [len(r) for r in runs] != [2, 2]:
        failed.append(f"incarnations {[len(r) for r in runs]}, 2 expected")
    else:
        for i in range(2):
            common = set(runs[0][i]) & set(runs[1][i])
            differ = sorted(k for k in common
                            if runs[0][i][k] != runs[1][i][k])
            if differ or not common:
                failed.append(f"incarnation {i}: the ranks' losses differ "
                              f"at steps {differ} of {sorted(common)}")
        restart = 2 * WORLD_SAVE
        for rank in range(2):
            again = {k: runs[rank][1].get(k) for k in
                     range(restart + 1, WORLD_CRASH + 1)}
            first = {k: runs[rank][0].get(k) for k in again}
            if rank == 1:  # it crashed inside step WORLD_CRASH's report
                first.pop(WORLD_CRASH)
                again.pop(WORLD_CRASH)
            if again != first or None in again.values():
                failed.append(f"rank {rank}: replayed {again}, first {first}")
    # the saves: equal state checksums on both ranks at every save
    sums = {}
    for e in events:
        if e["kind"] == "train.checksums":
            sums.setdefault(e["data"]["step"], {}).setdefault(
                e["data"]["rank"], []).append(e["data"]["sums"])
    for s in range(WORLD_SAVE, WORLD_STEPS + 1, WORLD_SAVE):
        got = sums.get(s, {})
        flat = [x for r in (0, 1) for x in got.get(r, [])]
        if sorted(got) != [0, 1] or any(x != flat[0] for x in flat):
            failed.append(f"step {s}: checksums not equal on both ranks")
    # step 8's commit: every leaf written by exactly one rank, the ranks'
    # owned bytes summing to the state's, COMMIT only with both pieces
    step8 = 2 * WORLD_SAVE
    dedup8 = {e["data"]["process_index"]: e["data"] for e in events
              if e["kind"] == "ckpt.dedup" and e["data"]["step"] == step8}
    if man8 is None:
        failed.append(f"step {step8} not committed ({committed})")
    else:
        tensors = [leaf for leaf in man8["leaves"]
                   if leaf["kind"] == "shards"]
        writers = [man8["locations"].get(mf.shard_key(
            mf.path_key(leaf["path"]), leaf["domains"][0]["idx"]),
            {}).get("proc") for leaf in tensors]
        owners = [leaf["domains"][0]["owner"] for leaf in tensors]
        if writers != owners or len(man8["locations"]) != len(tensors):
            failed.append(f"step {step8}: writers {writers} != owners")
        if (sorted(dedup8) != [0, 1]
                or sum(d["bytes_owned"] for d in dedup8.values())
                != dedup8[0]["bytes_full"]):
            failed.append(f"step {step8}: owned bytes {dedup8}")
        pieces = {f"step-{step8}/xidx-{p}.a{man8['attempt']}.json"
                  for p in range(2)}
        if not pieces <= keys8:
            failed.append(f"step {step8}: COMMIT without {pieces - keys8}")
    i_commit = next((i for i, e in enumerate(events)
                     if e["kind"] == "ckpt.manifest_committed"
                     and e["data"]["step"] == step8), None)
    i_pieces = [i for i, e in enumerate(events) if e["kind"] == "ckpt.dedup"
                and e["data"]["step"] == step8]
    if i_commit is None or len(i_pieces) != 2 or max(i_pieces) > i_commit:
        failed.append(f"step {step8}: commit event {i_commit} before both "
                      f"pieces {i_pieces}")
    # the restore: both ranks step 8 by consensus, checksums those saved,
    # rank 1 over rank 0's /ckpt/shard
    restores = {e["data"]["rank"]: e["data"] for e in events
                if e["kind"] == "train.restored"}
    want = sums.get(step8, {}).get(0, [None])[0]
    for rank in range(2):
        r = restores.get(rank)
        if r is None or r["step"] != step8 or r["checksums"] != want:
            failed.append(f"rank {rank} restored {r and r['step']} "
                          f"(checksums equal: {r and r['checksums'] == want})")
    if not (restores.get(1, {}).get("peer_bytes", 0) > 0
            and restores[1]["tier"] == "peer"):
        failed.append(f"rank 1's restore did not come over the peer tier "
                      f"({restores.get(1)})")
    readings = {}
    crash = next((e for e in events if e["kind"] == "fault.injected"), None)
    after = [e for e in steps if crash and e["ts"] > crash["ts"]
             and e["data"]["step"] == step8 + 1]
    if crash is None or len(after) != 2:
        failed.append("the journal lacks the crash or the first steps "
                      "after the restore")
    else:
        readings["recovery_s"] = max(e["ts"] for e in after) - crash["ts"]
    timed = [d for d in (e["data"] for e in steps)
             if d["step"] not in (1, step8 + 1)]  # first steps warm up
    readings.update({
        "launches": world_launches,
        "step_ms_median": statistics.median(d["step_s"] for d in timed) * 1e3
        if timed else None,
        "reduce_ms_median":
            statistics.median(d["reduce_s"] for d in timed) * 1e3
            if timed else None,
        "saves": [{k: e["data"][k] for k in (
            "rank", "step", "stall_ms", "persist_wait_ms", "archive_bytes",
            "owned_bytes")}
                  for e in events if e["kind"] == "train.saved"],
        "persisted": {p: {k: d[k] for k in ("bytes_full", "bytes_owned",
                                             "members_owned")}
                      for p, d in dedup8.items()},
        "restores": {r: {k: d[k] for k in ("tier", "seconds", "bytes",
                                           "peer_bytes")}
                     for r, d in restores.items()},
        "network_check_s": {f"{d['node_rank']}/{d['round']}": d["elapsed_s"]
                            for d in rounds},
    })
    emit({
        "phase": "world", "model": "llama_1b", "layers": LAUNCHER_LAYERS,
        "ranks": 2, "backend": "gloo", "batch_per_rank": SLICE["b"],
        "seq": SLICE["s"], "steps": WORLD_STEPS, "save_interval": WORLD_SAVE,
        "crash": f"crash@{WORLD_CRASH}:host=1",
        "heartbeat_s": WORLD_HEARTBEAT_S, "launcher_rc": rcs,
        "phase_s": world_s, "committed": committed,
        "launches_per_step": launches, "losses": runs, **readings,
        "nvidia_smi": nvidia_smi_line(),
    })
    if failed:
        for out in stdout:
            print(out[-6000:], file=sys.stderr)
        raise AssertionError("world: " + "; ".join(failed))
    return readings


# ----------------------------------------------------------- phase mesh

#: llama_1b at full width cut to MESH_LAYERS layers, batch 3 x 2048 per
#: data-parallel rank, AdamW(1e-4, 0.9, 0.95); MESH_WARMUP warm-up step
#: and MESH_TIMED[strategy] timed steps (tp_fsdp cut to 2 for the
#: script's time limit)
MESH_LAYERS = LAUNCHER_LAYERS
MESH_WARMUP = 1
MESH_TIMED = {"zero1": 3, "zero2": 3, "fsdp": 3, "tp": 3, "tp_fsdp": 2}
MESH_LR = 1e-4
#: gates against the reference: every step's loss within MESH_LOSS_RTOL
#: (relative; readings 3e-5), at least MESH_WITHIN_SHARE of every rank's
#: kept parameter elements within 2 lr and one bf16 ulp of the
#: reference's (readings 99.950-99.990%), and no element beyond 2 lr and
#: one ulp per step taken (AdamW's sign effect, ROADMAP C). PERF.md has
#: the readings of planted faults against them (``plants`` of run_mesh).
MESH_LOSS_RTOL = 1e-3
MESH_WITHIN_SHARE = 0.999
#: the fsdp run's save: restored into fresh ranks, and into one rank
MESH_SAVE_STEP = 2
#: rank count -> [(strategy, mesh spec)], each group's ranks reused
MESH_RUNS = {
    2: [("zero1", [("fsdp", 2)]), ("zero2", [("fsdp", 2)]),
        ("fsdp", [("fsdp", 2)]), ("tp", [("tensor", 2)]),
        ("rowwise", [("data", 1), ("fsdp", 2)])],
    4: [("tp_fsdp", [("fsdp", 2), ("tensor", 2)])],
}
#: the runs of the script's phase "mesh": MESH_RUNS but fsdp, whose step
#: (llama_1b at 4 layers on (fsdp 2), 3 x 2048 a rank) phase "reshard"
#: runs and holds to the one-process step under the same gates, and
#: whose saves it restores bitwise at one rank and at two
MESH_PHASE_RUNS = {n: [(s, spec) for s, spec in group if s != "fsdp"]
                   for n, group in MESH_RUNS.items()}
#: "rowwise" (the recommender): (a) criteo_wide_deep at batch ROWWISE_BATCH,
#: ROWWISE_STEPS adagrad(0.05) steps against the one-process step from the
#: same seed; (b) dlrm_large at ROWWISE_SCALE_ROWS rows at its published
#: width, 1 warm-up and ROWWISE_SCALE_TIMED timed steps, then one gated
#: step. 400M rows with their state (about 158 GB) fit no single card.
ROWWISE_BATCH = 4096
ROWWISE_STEPS = 3
ROWWISE_LOSS_RTOL = 1e-5
#: a parameter's largest difference from the reference, relative to the
#: reference tensor's largest element (fp32: the sharded gradient's sums
#: run in another order than the one-process gather's)
ROWWISE_PARAM_TOL = 1e-5
ROWWISE_SCALE_ROWS = 100_000_000
#: the scale run on CPU ranks (a dry run of its logic): a small table
ROWWISE_SCALE_ROWS_CPU = 200_000
ROWWISE_SCALE_TIMED = 3
MESH_TIMEOUT_S = 300
#: the tp shape of the flash kernels: the Llama step's heads split over 2
SLICE_TP = dict(SLICE, h=SLICE["h"] // 2, kvh=SLICE["kvh"] // 2)


def _mesh_cfg(layers: int, device=None):
    """llama_1b cut to ``layers`` layers; on the CPU (a dry run of the
    phase's logic) llama_tiny, whose widths the CPU can step."""
    import dataclasses

    from dlrover_tpu_torch.models import llama

    cfg = (llama.llama_tiny() if device == "cpu"
           else llama.llama_1b(remat="dots_attn_out"))
    return dataclasses.replace(cfg, num_layers=layers)


def _dp_size(spec) -> int:
    return math.prod(k for a, k in spec if a in ("data", "fsdp"))


def _mesh_steps(strategy: str) -> int:
    return MESH_WARMUP + MESH_TIMED[strategy]


def _owned_bytes(state, rank: int) -> int:
    """The bytes of every optimizer-state domain ``rank`` holds, by the
    domain maps of its own train state."""
    from dlrover_tpu_torch.trainer import ckpt_store

    total = 0
    for _, leaf in ckpt_store.flatten_with_path(
            {"mu": state["optimizer"]["mu"], "nu": state["optimizer"]["nu"]}):
        for d in leaf.domains:
            if rank in d["replicas"]:
                total += math.prod(b - a for a, b in d["idx"]) * (
                    leaf.dtype.itemsize)
    return total


def _plant(t, plant) -> None:
    """A planted fault that the gates must catch: "no_step" skips every
    update; "no_reduce" steps each rank on its own rows' gradients,
    leaving out their sum over the data-parallel ranks (each rank keeps
    its own chunk where the sum would be scattered)."""
    import torch.distributed as dist

    from dlrover_tpu_torch.parallel import mesh as mesh_lib

    if plant == "no_step":
        t.optimizer.step = lambda *args, **kwargs: None
    elif plant == "no_reduce":
        def local(grads):
            out = []
            for lay, g in zip(t._layouts, grads):
                for d, a in lay.scatter:
                    group = mesh_lib.axes_group(t.mesh, (a,))
                    g = g.chunk(dist.get_world_size(group), d)[
                        dist.get_rank(group)]
                out.append(g)
            return out

        t._reduce_to_opt = local
    elif plant is not None:
        raise ValueError(f"no planted fault {plant!r}")


def _against_reference(t, ref, init, steps: int) -> dict:
    """This rank's kept shards against the same boxes of the reference's
    parameters after as many steps, in units of the learning rate:
    the worst element beyond one storage ulp per step (bf16: at most
    2^-7 of the value), beyond one ulp, and as it is; the share of
    elements within 2 lr and one ulp, and of elements equal to the bit;
    and the sums of squares of the difference and of the reference's
    own update (from ``init``), whose ratio is the update's relative
    error."""
    import torch

    worst = {"per_step": 0.0, "one_ulp": 0.0, "raw": 0.0}
    within = equal = total = 0
    diff_sq = update_sq = 0.0
    for name, box, shard in t.local_shards():
        index = tuple(slice(a, b) for a, b in box)
        want = ref[name][index].to(shard.device).float()
        start = init[name][index].to(shard.device).float()
        diff = (shard.float() - want).abs()
        ulp = (want.abs() * 2.0 ** -7 if shard.dtype == torch.bfloat16
               else torch.zeros_like(want))
        for key, allow in (("per_step", steps * ulp), ("one_ulp", ulp),
                           ("raw", 0.0)):
            worst[key] = max(worst[key], float(
                ((diff - allow) / MESH_LR).max()))
        within += int((diff <= 2 * MESH_LR + ulp).sum())
        equal += int((diff == 0).sum())
        total += diff.numel()
        diff_sq += float(diff.double().pow(2).sum())
        update_sq += float((want - start).double().pow(2).sum())
    return {"param_diff_lr": worst, "param_within_2lr_share": within / total,
            "param_equal_share": equal / total,
            "param_diff_sq": diff_sq, "reference_update_sq": update_sq}


def mesh_rank(work: str, layers: int, device=None) -> None:
    """One rank of phase "mesh" (``python -c``): every strategy of its
    rank count (``runs.json``) on ``cuda:0`` in the gloo group, with the
    planted faults of ``runs.json``; one JSON result file."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.ops.cuda import flash_attention as fa
    from dlrover_tpu_torch.parallel.mesh import create_mesh
    from dlrover_tpu_torch.trainer import ckpt_store
    from dlrover_tpu_torch.trainer import distributed as coll
    from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer
    from dlrover_tpu_torch.trainer.sharded import (
        adamw, make_trainer_for_llama)

    env = coll.init_from_env(timeout_s=120, backend="gloo", device=device)
    cfg = _mesh_cfg(layers, device)
    data = np.load(os.path.join(work, "batches.npz"))
    with open(os.path.join(work, "runs.json")) as f:
        plan = json.load(f)
    opt = adamw(MESH_LR, b1=0.9, b2=0.95)
    out = {"rank": env.rank, "route": coll.collective_route(
        dist.group.WORLD), "runs": {}}
    init_path = os.path.join(work, "init.pt")
    init = (torch.load(init_path, map_location="cpu")
            if os.path.exists(init_path) else None)

    def trainer_for(strategy, spec, seed):
        t = make_trainer_for_llama(cfg, device=device, strategy=strategy,
                                   optimizer=opt,
                                   mesh=create_mesh(spec, device=device))
        t.init(seed=seed)
        return t

    for strategy, spec in plan["runs"][str(env.world_size)]:
        spec = [tuple(x) for x in spec]
        if strategy == "rowwise":
            torch.cuda.empty_cache() if device != "cpu" else None
            out["runs"][strategy] = rowwise_rank(
                work, spec, env.rank, device,
                plan["plants"].get(strategy), plan["rowwise_scale"])
            dist.barrier()
            continue
        # the global batch: 3 rows per data-parallel rank
        n_rows = _dp_size(spec) * SLICE["b"]
        steps = _mesh_steps(strategy)

        def batch(t, step):
            rows = t.split_batch((data["tokens"][step][:n_rows],
                                  data["targets"][step][:n_rows]))
            return t.shard_batch(t.microbatch(rows))

        cuda = device != "cpu"
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t = trainer_for(strategy, spec, seed=0)
        _plant(t, plan["plants"].get(strategy))
        state = t.train_state()
        run = {"bytes": t.state_bytes(),
               "owned_opt_bytes": _owned_bytes(state, env.rank),
               "device": str(t.local_shards()[0][2].device),
               "losses": [], "step_ms": [], "collective_ms": []}
        before = dict(fa.LAUNCHES)
        for step in range(steps):
            mb = batch(t, step)
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = t.train_step(mb)
            if cuda:
                torch.cuda.synchronize()
            run["step_ms"].append((time.perf_counter() - t0) * 1e3)
            run["collective_ms"].append(t.reduce_seconds * 1e3)
            run["losses"].append(loss.item())
            if strategy == "fsdp" and step + 1 == MESH_SAVE_STEP:
                ckpt = FlashCheckpointer(
                    os.path.join(work, "store"),
                    ram_dir=os.path.join(work, f"ram{env.rank}"),
                    persist_interval=MESH_SAVE_STEP)
                saved = {**t.train_state(), "step": MESH_SAVE_STEP,
                         "data": ""}
                run["saved_sums"] = ckpt_store.state_checksums(saved)
                ckpt.save(MESH_SAVE_STEP, saved)
                ckpt.close()  # persisted, and committed by rank 0
                run["saved_whole_sums"] = ckpt_store.state_checksums(
                    t.gathered_params())
        run["launches"] = {k: fa.LAUNCHES[k] - before[k] for k in before}
        run["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 2**30
                              if cuda else None)
        ref = torch.load(os.path.join(
            work, f"reference{_dp_size(spec)}_{steps}.pt"),
            map_location="cpu")
        run.update(_against_reference(t, ref, init, steps))
        del ref
        if strategy == "fsdp":
            # fresh ranks (another seed's weights) restore step 2
            fresh = trainer_for(strategy, spec, seed=1)
            reader = FlashCheckpointer(
                os.path.join(work, "store"),
                ram_dir=os.path.join(work, f"ram{env.rank}"))
            got, at = reader.restore(
                target={**fresh.train_state(), "step": 0, "data": ""})
            reader.close()
            fresh.load_train_state(got)
            run["restored_step"] = at
            run["restored_sums"] = ckpt_store.state_checksums(
                {**fresh.train_state(), "step": at, "data": ""})
            run["restore_tier"] = (reader.last_restore_stats or {}).get(
                "tier")
            del fresh, got
        out["runs"][strategy] = run
        del t, state
        dist.barrier()
    with open(os.path.join(work, f"rank{env.rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _mesh_reference(work: str, layers: int, runs, device=None) -> dict:
    """The port's single-process step on the card from the same seed:
    each global batch (the data-parallel ranks' rows) in one
    microbatch -- at two the step would take Fp32GradAdamW, which the
    ranks' one-microbatch steps do not. {dp: losses}; the initial
    parameters go to ``init.pt``, those after each strategy's step
    count to ``reference{dp}_{steps}.pt``."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.trainer.sharded import (
        adamw, make_trainer_for_llama)

    cfg = _mesh_cfg(layers, device)
    data = np.load(os.path.join(work, "batches.npz"))
    wanted = {}
    for group in runs.values():
        for strategy, spec in group:
            if strategy == "rowwise":
                continue
            wanted.setdefault(_dp_size(spec), set()).add(
                _mesh_steps(strategy))
    out = {}
    for dp, counts in sorted(wanted.items()):
        t = make_trainer_for_llama(
            cfg, device=device, optimizer=adamw(MESH_LR, b1=0.9, b2=0.95))
        t.init(seed=0)

        def save(name):
            torch.save({n: p.detach().cpu() for n, p in
                        t.model.named_parameters()},
                       os.path.join(work, name))

        if not os.path.exists(os.path.join(work, "init.pt")):
            save("init.pt")
        rows = dp * SLICE["b"]
        losses = []
        for step in range(max(counts)):
            mb = t.shard_batch(t.microbatch((data["tokens"][step][:rows],
                                             data["targets"][step][:rows])))
            losses.append(t.train_step(mb).item())
            if step + 1 in counts:
                save(f"reference{dp}_{step + 1}.pt")
        out[dp] = losses
        del t
        if device != "cpu":
            torch.cuda.empty_cache()
    return out


def _rowwise_cfg(scale: bool, device=None):
    from dlrover_tpu_torch.models import dlrm

    if not scale:
        return dlrm.criteo_wide_deep()
    return dlrm.dlrm_large(total_vocab=(
        ROWWISE_SCALE_ROWS_CPU if device == "cpu" else ROWWISE_SCALE_ROWS))


def _clicks(cfg, n: int, seed: int):
    """A batch of ``n`` clicks whose ids spread over every feature's whole
    vocabulary: (dense fp32, cat_ids int32, labels int32)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cat = np.stack([rng.integers(0, v, n) for v in cfg.vocab_sizes],
                   axis=1).astype(np.int32)
    return (rng.standard_normal((n, cfg.dense_dim)).astype(np.float32),
            cat, rng.integers(0, 2, n).astype(np.int32))


def _plant_rowwise(plant):
    """"no_allreduce": the lookup's sum over fsdp left out, so each rank
    sees only its own rows' embeddings. Returns the undo."""
    from dlrover_tpu_torch.parallel import embedding

    if plant is None:
        return lambda: None
    if plant != "no_allreduce":
        raise ValueError(f"no planted rowwise fault {plant!r}")

    class _NoSum:
        def __getattr__(self, name):
            return getattr(saved, name)

        @staticmethod
        def all_reduce_(t, group, op=None):
            return t

    saved = embedding.coll
    embedding.coll = _NoSum()
    return lambda: setattr(embedding, "coll", saved)


def _chunk_checksum(t) -> int:
    """A position-weighted checksum of a large table's bits, on its
    device, in blocks of rows (``ckpt_store.state_checksums`` whole would
    take an int64 copy of the table)."""
    import torch

    total, rows = 0, max(1, (1 << 24) // max(1, t[0].numel()))
    flat_at = 0
    for i in range(0, t.shape[0], rows):
        bits = t[i:i + rows].reshape(-1).view(torch.int32).long()
        w = (torch.arange(bits.numel(), device=t.device) + flat_at) % 65521
        total += int((bits * (w + 1)).sum())
        flat_at += bits.numel()
    return total


def rowwise_rank(work: str, spec, rank: int, device, plant,
                 scale: bool) -> dict:
    """One rank of "rowwise": (a) the CRITEO parity run and the save of
    its last step, (b) with ``scale`` the dlrm_large run."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.models import dlrm
    from dlrover_tpu_torch.parallel.mesh import create_mesh
    from dlrover_tpu_torch.trainer import ckpt_store
    from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer

    undo = _plant_rowwise(plant)
    cuda = device != "cpu"
    try:
        mesh = create_mesh(spec, device=device)
        cfg = _rowwise_cfg(False)
        data = np.load(os.path.join(work, "rowwise_batches.npz"))
        t = dlrm.make_trainer(cfg, device=device, mesh=mesh)
        t.init(seed=0)
        run = {"losses": [], "step_ms": [], "collective_ms": []}
        for i in range(ROWWISE_STEPS):
            mb = t.shard_batch(t.microbatch(t.split_batch(tuple(
                data[f"{k}{i}"] for k in ("dense", "cat", "labels")))))
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            run["losses"].append(t.train_step(mb).item())
            run["step_ms"].append((time.perf_counter() - t0) * 1e3)
            run["collective_ms"].append(t.reduce_seconds * 1e3)
        run["bytes"] = t.state_bytes()
        run["table_bytes"] = 4 * (t.model.table.numel()
                                  + t.model.wide.numel())
        run["device"] = str(t.model.table.device)
        ref = torch.load(os.path.join(work, "rowwise_reference.pt"),
                         map_location="cpu")
        run["param_err"] = {}
        for name, box, shard in t.local_shards():
            want = ref[name][tuple(slice(a, b) for a, b in box)].float()
            diff = (shard.detach().cpu().float() - want).abs().max()
            run["param_err"][name] = float(diff) / max(
                float(ref[name].abs().max()), 1e-30)
        ckpt = FlashCheckpointer(os.path.join(work, "rowwise_store"),
                                 ram_dir=os.path.join(work,
                                                      f"rowwise_ram{rank}"),
                                 persist_interval=ROWWISE_STEPS)
        ckpt.save(ROWWISE_STEPS, {**t.train_state(), "step": ROWWISE_STEPS,
                                  "data": ""})
        ckpt.close()  # persisted, and committed by rank 0
        run["saved_whole_sums"] = ckpt_store.state_checksums(
            t.gathered_params())
        del t, ref
        if scale:
            run["scale"] = _rowwise_scale(work, mesh, rank, device)
        return run
    finally:
        undo()


def _rowwise_scale(work: str, mesh, rank: int, device) -> dict:
    """dlrm_large on the mesh: each rank draws only its rows; the timed
    steps; then one gated step: the lookup on its ids (saved beside the
    rows this rank fetched to the host, for the parent to add up), a
    finite loss, every row the batch touched changed and no other row."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.models import dlrm
    from dlrover_tpu_torch.parallel.embedding import (
        stack_ids, vocab_parallel_lookup)

    cuda = device != "cpu"
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg = _rowwise_cfg(True, device)
    t0 = time.perf_counter()
    t = dlrm.make_trainer(cfg, device=device, mesh=mesh)
    t.init(seed=0)
    if cuda:
        torch.cuda.synchronize()
    out = {"total_vocab": cfg.total_vocab, "padded_vocab": cfg.padded_vocab,
           "embed_dim": cfg.embed_dim, "bottom_mlp": list(cfg.bottom_mlp),
           "init_s": time.perf_counter() - t0,
           "table_bytes": 4 * (t.model.table.numel() + t.model.wide.numel()),
           "rows": list(t.model.rows), "step_ms": [], "collective_ms": [],
           "losses": []}
    batches = [t.shard_batch(t.microbatch(_clicks(cfg, ROWWISE_BATCH,
                                                   100 + i)))
               for i in range(ROWWISE_SCALE_TIMED + 2)]
    for mb in batches[:-1]:  # the first is the warm-up
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["losses"].append(t.train_step(mb).item())
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["collective_ms"].append(t.reduce_seconds * 1e3)
    dense, cat, labels = (x[0] for x in batches[-1])
    model = t.model
    lo, hi = model.rows
    with torch.no_grad():
        ids = torch.minimum(cat.clamp(min=0), model.sizes[None, :] - 1)
        rows = stack_ids(ids.to(model.offsets.dtype), model.offsets).long()
        emb = vocab_parallel_lookup(model.table.detach(), rows, mesh)
        owned = (rows >= lo) & (rows < hi)
        fetched = torch.zeros_like(emb).cpu()
        fetched[owned.cpu()] = model.table[rows[owned] - lo].cpu()
        np.save(os.path.join(work, f"rowwise_emb{rank}.npy"),
                emb.cpu().numpy())
        np.save(os.path.join(work, f"rowwise_fetched{rank}.npy"),
                fetched.numpy())
        touched = torch.unique(rows[owned]) - lo
        before = {n: getattr(model, n)[touched].clone()
                  for n in ("table", "wide")}
        sums = {n: _chunk_checksum(getattr(model, n).detach())
                for n in ("table", "wide")}
    loss = t.train_step(batches[-1]).item()
    with torch.no_grad():
        out["gate_loss"] = loss
        out["touched_rows"] = int(touched.numel())
        out["untouched_equal"], out["touched_changed_share"] = {}, {}
        for n in ("table", "wide"):
            p = getattr(model, n)
            after = p[touched].clone()
            changed = (after != before[n]).any(dim=1)
            out["touched_changed_share"][n] = float(changed.float().mean())
            p[touched] = before[n]
            out["untouched_equal"][n] = _chunk_checksum(p.detach()) == sums[n]
            p[touched] = after
    out["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 2**30
                          if cuda else None)
    del t, model, batches, before
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _rowwise_reference(work: str, device=None) -> dict:
    """The batches of the CRITEO parity run, and the port's one-process
    step on them from the same seed: its losses; its parameters after
    the last step go to ``rowwise_reference.pt``."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.models import dlrm

    cfg = _rowwise_cfg(False)
    arrays = {}
    for i in range(ROWWISE_STEPS):
        for k, x in zip(("dense", "cat", "labels"),
                        _clicks(cfg, ROWWISE_BATCH, 10 + i)):
            arrays[f"{k}{i}"] = x
    np.savez(os.path.join(work, "rowwise_batches.npz"), **arrays)
    t = dlrm.make_trainer(cfg, device=device)
    t.init(seed=0)
    losses = [t.train_step(t.shard_batch(t.microbatch(tuple(
        arrays[f"{k}{i}"] for k in ("dense", "cat", "labels"))))).item()
        for i in range(ROWWISE_STEPS)]
    torch.save({n: p.detach().cpu() for n, p in t.gathered_params().items()},
               os.path.join(work, "rowwise_reference.pt"))
    return {"losses": losses}


def _rowwise_gates(work: str, ranks, reference, solo_sums, device,
                   failed: list) -> dict:
    """The gates of "rowwise" over its ranks' results; its readings."""
    import numpy as np

    from dlrover_tpu_torch.models import dlrm

    runs = [r["runs"]["rowwise"] for r in ranks]
    cfg = _rowwise_cfg(False)
    want = reference["losses"]
    line = {
        "mesh": {"data": 1, "fsdp": len(runs)}, "batch": ROWWISE_BATCH,
        "steps": ROWWISE_STEPS, "losses": [r["losses"] for r in runs],
        "reference_losses": want,
        "loss_rel": max(abs(a - b) / abs(b) for r in runs
                        for a, b in zip(r["losses"], want)),
        "param_err_max": max(max(r["param_err"].values()) for r in runs),
        "param_err": runs[0]["param_err"],
        "step_ms": [r["step_ms"] for r in runs],
        "collective_ms": [r["collective_ms"] for r in runs],
        "table_bytes_per_rank": [r["table_bytes"] for r in runs],
        "bytes": [r["bytes"] for r in runs],
        "restored_one_rank_bitwise": solo_sums == runs[0]["saved_whole_sums"],
    }
    for i, r in enumerate(runs):
        if line["loss_rel"] > ROWWISE_LOSS_RTOL:
            failed.append(f"rowwise rank {i}: losses {r['losses']} vs the "
                          f"one-process {want}")
        bad = {n: e for n, e in r["param_err"].items()
               if e > ROWWISE_PARAM_TOL}
        if bad:
            failed.append(f"rowwise rank {i}: parameters off the "
                          f"one-process step's: {bad}")
        if 2 * r["table_bytes"] != dlrm.table_bytes(cfg):
            failed.append(f"rowwise rank {i}: {r['table_bytes']} table "
                          f"bytes, not half of {dlrm.table_bytes(cfg)}")
        if device != "cpu" and r["device"] != "cuda:0":
            failed.append(f"rowwise rank {i} on {r['device']}")
    if not line["restored_one_rank_bitwise"]:
        failed.append("rowwise: the save did not restore bitwise into "
                      "one rank")
    scales = [r.get("scale") for r in runs]
    if scales[0] is not None:
        emb = [np.load(os.path.join(work, f"rowwise_emb{r}.npy"))
               for r in range(len(runs))]
        fetched = sum(np.load(os.path.join(work, f"rowwise_fetched{r}.npy"))
                      for r in range(len(runs)))
        line["scale"] = {
            **{k: scales[0][k] for k in ("total_vocab", "padded_vocab",
                                         "embed_dim", "bottom_mlp")},
            "per_rank": scales,
            "lookup_equals_host_rows": all(np.array_equal(e, fetched)
                                           for e in emb)}
        if not line["scale"]["lookup_equals_host_rows"]:
            failed.append("rowwise scale: the lookup differs from the rows "
                          "fetched from the shards")
        for i, sc in enumerate(scales):
            if not math.isfinite(sc["gate_loss"]):
                failed.append(
                    f"rowwise scale rank {i}: loss {sc['gate_loss']}")
            if not all(sc["untouched_equal"].values()):
                failed.append(f"rowwise scale rank {i}: rows the batch did "
                              f"not touch changed {sc['untouched_equal']}")
            if min(sc["touched_changed_share"].values()) < 1.0:
                failed.append(f"rowwise scale rank {i}: touched rows "
                              f"unchanged {sc['touched_changed_share']}")
    return line


def _rank_group(work: str, n: int, call: str, what: str):
    """``n`` rank processes running ``chip_smoke.<call>`` in one gloo
    group (each writes ``rank<r>.json`` to ``work``): their results, in
    rank order, and their combined output."""
    port = _free_port()
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"import chip_smoke; chip_smoke.{call}")
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("DLROVER_TPU_", "DLROVER_FAULT"))}
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], cwd=ROOT,
        env={**base, "DLROVER_TPU_COORDINATOR_ADDR": f"localhost:{port}",
             "DLROVER_TPU_PROCESS_ID": str(r),
             "DLROVER_TPU_NUM_PROCESSES": str(n),
             "DLROVER_TPU_DIST_HEARTBEAT_TIMEOUT": "60",
             "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
             "DLROVER_TPU_LOG_LEVEL": "WARNING"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=MESH_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=30)
    rcs = [p.returncode for p in procs]
    if rcs != [0] * n:
        raise AssertionError(f"{what}: {n} ranks exited {rcs}: "
                             + logs[rcs.index(next(c for c in rcs if c))
                                    ][-4000:])
    results = []
    for r in range(n):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results, "".join(logs)


def run_mesh(layers: int = MESH_LAYERS, device=None, runs=None,
             plants=None, rowwise_scale: bool = True) -> dict:
    """Phase "mesh"'s body at ``layers`` layers: the reference, each rank
    group's strategies (``runs``, by default MESH_RUNS), the restores of
    the fsdp and rowwise saves into one rank, the gates; returns the
    readings and the failed gates. ``plants`` ({strategy: "no_step" or
    "no_reduce"}, and for rowwise "no_allreduce") plants a fault in a
    strategy's ranks, as a control of the gates; ``rowwise_scale=False``
    leaves out rowwise's dlrm_large run. ``device="cpu"`` runs llama_tiny
    and a small dlrm_large on CPU ranks instead (the logic alone: no
    kernel launches there)."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.trainer import ckpt_store
    from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer
    from dlrover_tpu_torch.trainer.sharded import (
        adamw, make_trainer_for_llama)

    runs = MESH_RUNS if runs is None else runs
    saves = any(s == "fsdp" for group in runs.values() for s, _ in group)
    rowwise = [n for n, group in runs.items()
               if any(s == "rowwise" for s, _ in group)]
    cfg = _mesh_cfg(layers, device)
    steps = max([_mesh_steps(s) for group in runs.values() for s, _ in group
                 if s != "rowwise"] or [1])
    work = tempfile.mkdtemp(prefix="dlrover_mesh_")
    failed, readings = [], {}
    try:
        rows = 2 * SLICE["b"]  # the largest data-parallel world's batch
        rng = np.random.default_rng(11)
        tokens = rng.integers(0, cfg.vocab_size,
                              (steps, rows, SLICE["s"] + 1))
        np.savez(os.path.join(work, "batches.npz"),
                 tokens=tokens[:, :, :-1], targets=tokens[:, :, 1:])
        with open(os.path.join(work, "runs.json"), "w") as f:
            json.dump({"runs": runs, "plants": plants or {},
                       "rowwise_scale": rowwise_scale}, f)
        t0 = time.time()
        reference = _mesh_reference(work, layers, runs, device)
        if rowwise:
            row_reference = _rowwise_reference(work, device)
        readings["reference_s"] = time.time() - t0
        results = {}
        for n in runs:
            t0 = time.time()
            results[n], _ = _rank_group(
                work, n, f"mesh_rank({work!r}, {layers}, {device!r})",
                "mesh")
            readings[f"ranks{n}_s"] = time.time() - t0
        if saves:
            # the fsdp step restores whole into one rank
            solo = make_trainer_for_llama(
                cfg, device=device, strategy="fsdp",
                optimizer=adamw(MESH_LR, 0.9, 0.95))
            solo.init(seed=1)
            reader = FlashCheckpointer(
                os.path.join(work, "store"),
                ram_dir=os.path.join(work, "ram-solo"))
            got, at = reader.restore(
                target={**solo.train_state(), "step": 0, "data": ""})
            reader.close()
            solo.load_train_state(got)
            solo_sums = ckpt_store.state_checksums(solo.gathered_params())
            del solo, got
        if rowwise:
            # the rowwise step restores whole into one rank
            from dlrover_tpu_torch.models import dlrm

            solo = dlrm.make_trainer(_rowwise_cfg(False), device=device)
            solo.init(seed=1)
            reader = FlashCheckpointer(
                os.path.join(work, "rowwise_store"),
                ram_dir=os.path.join(work, "rowwise-ram-solo"))
            got, _ = reader.restore(
                target={**solo.train_state(), "step": 0, "data": ""})
            reader.close()
            solo.load_train_state(got)
            readings["rowwise"] = _rowwise_gates(
                work, results[rowwise[0]], row_reference,
                ckpt_store.state_checksums(solo.gathered_params()), device,
                failed)
            del solo, got
        if device != "cpu":
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    whole = llama.param_count(cfg) * 2  # bf16 matrices ...
    norms = 4 * cfg.hidden_size * (2 * layers + 1)  # ... fp32 norms
    whole += norms - norms // 2
    strategies = {}
    for n, ranks in results.items():
        for strategy, spec in runs[n]:
            if strategy == "rowwise":
                continue
            runs_ = [r["runs"][strategy] for r in ranks]
            steps = _mesh_steps(strategy)
            want = reference[_dp_size(spec)][:steps]
            kept = {"zero1": 1, "zero2": 1}.get(strategy, math.prod(
                k for _, k in spec))
            opt_parts = math.prod(k for _, k in spec)
            line = {
                "ranks": n, "mesh": dict(spec), "steps": steps,
                "plant": (plants or {}).get(strategy),
                "step_ms": [statistics.median(r["step_ms"][MESH_WARMUP:])
                            for r in runs_],
                "collective_ms": [
                    statistics.median(r["collective_ms"][MESH_WARMUP:])
                    for r in runs_],
                "peak_mem_gb": [r["peak_mem_gb"] for r in runs_],
                "param_bytes": [r["bytes"]["params"] for r in runs_],
                "opt_bytes": [r["bytes"]["optimizer"] for r in runs_],
                "param_fraction": runs_[0]["bytes"]["params"] / whole,
                "opt_fraction": runs_[0]["bytes"]["optimizer"] / (2 * whole),
                "losses": runs_[0]["losses"], "reference_losses": want,
                "loss_rel": max(abs(a - b) / abs(b) for r in runs_
                                for a, b in zip(r["losses"], want)),
                "param_diff_lr": {k: max(r["param_diff_lr"][k]
                                         for r in runs_)
                                  for k in runs_[0]["param_diff_lr"]},
                "param_within_2lr_share": min(
                    r["param_within_2lr_share"] for r in runs_),
                "param_equal_share": min(
                    r["param_equal_share"] for r in runs_),
                "update_rel_err": math.sqrt(
                    sum(r["param_diff_sq"] for r in runs_)
                    / max(sum(r["reference_update_sq"] for r in runs_),
                          1e-300)),
                "launches_per_step": [
                    {k: v / steps for k, v in r["launches"].items()}
                    for r in runs_],
            }
            strategies[strategy] = line
            for r, run in enumerate(runs_):
                if any(abs(a - b) > MESH_LOSS_RTOL * abs(b)
                       for a, b in zip(run["losses"], want)):
                    failed.append(f"{strategy} rank {r}: losses "
                                  f"{run['losses']} vs {want}")
                if run["param_within_2lr_share"] < MESH_WITHIN_SHARE:
                    failed.append(
                        f"{strategy} rank {r}: parameters "
                        f"{run['param_within_2lr_share']:.5%} of elements "
                        "within 2 lr and one ulp of the reference, under "
                        f"{MESH_WITHIN_SHARE:.1%}")
                # each step, AdamW's sign effect (where a gradient is near
                # zero, two runs' updates of an element differ by up to
                # 2 lr; ROADMAP C), and each run's bf16 store of the
                # update rounding to neighbouring values one ulp apart
                if run["param_diff_lr"]["per_step"] > 2.0 * steps:
                    failed.append(
                        f"{strategy} rank {r}: parameters "
                        f"{run['param_diff_lr']['per_step']:.3g} lr beyond "
                        f"{steps} storage ulps from the reference, over "
                        f"2 lr x {steps} steps")
                if run["owned_opt_bytes"] != run["bytes"]["optimizer"]:
                    failed.append(f"{strategy} rank {r}: optimizer bytes "
                                  f"{run['bytes']['optimizer']} != owned "
                                  f"{run['owned_opt_bytes']}")
                if run["bytes"]["optimizer"] != 2 * (
                        (whole - norms) // opt_parts + norms):
                    failed.append(f"{strategy} rank {r}: optimizer bytes "
                                  f"{run['bytes']['optimizer']}")
                if run["bytes"]["params"] != (whole - norms) // kept + norms:
                    failed.append(f"{strategy} rank {r}: parameter bytes "
                                  f"{run['bytes']['params']}")
                if device == "cpu":
                    continue  # the kernels and the card: on the card
                if set(run["launches"].values()) != {layers * steps}:
                    failed.append(f"{strategy} rank {r}: launches "
                                  f"{run['launches']}, {layers} of each "
                                  "per step expected")
                if run["device"] != "cuda:0":
                    failed.append(f"{strategy} rank {r} on {run['device']}")
    fsdp = [r["runs"]["fsdp"] for r in results[2]] if saves else []
    for r, run in enumerate(fsdp):
        if (run.get("restored_step") != MESH_SAVE_STEP
                or run["restored_sums"] != run["saved_sums"]):
            failed.append(f"fsdp rank {r}: restored step "
                          f"{run.get('restored_step')} not bitwise")
    if saves and (at != MESH_SAVE_STEP
                  or solo_sums != fsdp[0]["saved_whole_sums"]):
        failed.append(f"fsdp: one rank restored step {at}, whole "
                      f"parameters equal: "
                      f"{solo_sums == fsdp[0]['saved_whole_sums']}")
    readings.update({
        "strategies": strategies,
        "route": sorted({r["route"] for ranks in results.values()
                         for r in ranks}),
        "restore_tiers": [run.get("restore_tier") for run in fsdp],
        "launches": {
            shape: {k: sum(r["runs"][s]["launches"][k]
                           for n, ranks in results.items() for r in ranks
                           for s, spec in runs[n] if s != "rowwise"
                           if (s in ("tp", "tp_fsdp")) == (shape == "tp"))
                    for k in REPLACES}
            for shape in ("dense", "tp")},
    })
    return {"readings": readings, "failed": failed}


def phase_mesh() -> dict:
    """The sharding strategies across ranks on the card: zero1 and zero2
    on (fsdp 2), tp on (tensor 2), two gloo ranks on ``cuda:0``; tp_fsdp
    on (fsdp 2, tensor 2), four. Each against the port's single-process
    step from the same weights on the same global batches. Then
    "rowwise" in the two ranks (the docstring's phase 14). fsdp runs in
    phase "reshard" (``MESH_PHASE_RUNS``); ``run_mesh``'s default runs
    it here too, with its save."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    got = run_mesh(MESH_LAYERS, runs=MESH_PHASE_RUNS)
    emit({"phase": "mesh", "model": "llama_1b", "layers": MESH_LAYERS,
          "batch_per_dp_rank": SLICE["b"], "seq": SLICE["s"],
          "warmup": MESH_WARMUP, "timed": MESH_TIMED, "lr": MESH_LR,
          "backend": "gloo", "phase_s": time.time() - t0,
          **got["readings"], "nvidia_smi": nvidia_smi_line()})
    if got["failed"]:
        raise AssertionError("mesh: " + "; ".join(got["failed"]))
    return got["readings"]



#: phase "optim": the optimizers of ``optim/`` on the Llama-1.1B step
OPTIM_STEPS = 3
OPTIM_LR = 1e-4
#: the losses of bf16_adamw against AdamW's from the same seed
OPTIM_LOSS_ATOL = 1e-2
OPTIM_WSAM_STEPS = 2


def _optim_trainer(cfg, optimizer, value_and_grad=None):
    from dlrover_tpu_torch.trainer.sharded import make_trainer_for_llama

    t = make_trainer_for_llama(cfg, strategy="ddp", optimizer=optimizer,
                               value_and_grad=value_and_grad)
    t.init(seed=0)
    return t


def _optim_steps(t, batches, launches_per_step: int, failed: list,
                 what: str) -> dict:
    """Each batch's step on the card, timed one by one: the losses, the
    step ms, and the gate on the kernels' launches."""
    import torch

    from dlrover_tpu_torch.ops.cuda import flash_attention as fa

    losses, ms = [], []
    fa.reset_launches()
    for mb in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(t.train_step(mb)))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    want = launches_per_step * len(batches)
    if any(n != want for n in fa.LAUNCHES.values()):
        failed.append(f"{what}: launches {dict(fa.LAUNCHES)}, want {want}")
    if not all(math.isfinite(x) for x in losses):
        failed.append(f"{what}: losses {losses}")
    return {"losses": losses, "step_ms": ms}


def phase_optim() -> dict:
    """``optim/`` on the Llama-1.1B step (22 layers, batch 3 x 2048):
    AdamW's steps from seed 0, then ``bf16_adamw(1e-4,
    guard_nonfinite=True)``'s from the same seed -- every bf16
    parameter its master rounded, the losses within OPTIM_LOSS_ATOL of
    AdamW's -- then one more step with an inf planted in one gradient
    element, which must leave the parameters, masters and moments
    bitwise as they were, give ``guard_stats`` (1, non-finite) and trip
    the sentinel's ``nonfinite_grad``; then OPTIM_WSAM_STEPS steps under
    ``wsam_value_and_grad`` (two forwards and backwards each)."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.fault_tolerance.sentinel import TrainingSentinel
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.optim import (
        bf16_adamw, guard_stats, wsam_value_and_grad)
    from dlrover_tpu_torch.trainer.ckpt_store import state_checksums
    from dlrover_tpu_torch.trainer.sharded import adamw

    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama.llama_1b(remat="dots_attn_out")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size,
                          (OPTIM_STEPS + 1, SLICE["b"], SLICE["s"] + 1))
    failed, out = [], {}
    n_params = llama.param_count(cfg)

    def batches(t, k):
        return [t.shard_batch(t.microbatch((x[:, :-1], x[:, 1:])))
                for x in tokens[:k]]

    t = _optim_trainer(cfg, adamw(OPTIM_LR, b1=0.9, b2=0.95))
    out["adamw"] = _optim_steps(t, batches(t, OPTIM_STEPS), cfg.num_layers,
                                failed, "adamw")
    out["adamw"]["state_bytes_per_param"] = (
        t.state_bytes()["optimizer"] / n_params)
    del t
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = _optim_trainer(cfg, bf16_adamw(OPTIM_LR, guard_nonfinite=True))
    mb = batches(t, OPTIM_STEPS + 1)
    run = _optim_steps(t, mb[:OPTIM_STEPS], cfg.num_layers, failed,
                       "bf16_adamw")
    run["state_bytes_per_param"] = t.state_bytes()["optimizer"] / n_params
    guard = t.optimizer
    masters = guard.inner
    unequal = sum(int(not torch.equal(p, m.to(p.dtype)))
                  for p, m in zip(masters.params, masters.master))
    run["params_not_round_master"] = unequal
    if unequal:
        failed.append(f"bf16_adamw: {unequal} parameters differ from "
                      "their masters rounded")
    run["loss_abs_diff"] = [abs(a - b) for a, b in
                            zip(run["losses"], out["adamw"]["losses"])]
    if max(run["loss_abs_diff"]) > OPTIM_LOSS_ATOL:
        failed.append(f"bf16_adamw losses {run['losses']} vs adamw "
                      f"{out['adamw']['losses']}")
    # the planted inf: one element of the embedding's gradient
    held = state_checksums(t.train_state())
    def plant(g):
        at = (torch.tensor([7], device=g.device),
              torch.tensor([3], device=g.device))
        return g.index_put(at, torch.tensor(float("inf"), dtype=g.dtype,
                                            device=g.device))

    hook = t.model.embed.register_hook(plant)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.train_step(mb[OPTIM_STEPS])
    torch.cuda.synchronize()
    run["planted_step_ms"] = (time.perf_counter() - t0) * 1e3
    hook.remove()
    now = state_checksums(t.train_state())
    changed = sorted(k for k in held if held[k] != now[k]
                     and not k.endswith(("nonfinite_count",
                                         "last_grad_norm")))
    stats = guard_stats(t)
    sentinel = TrainingSentinel()
    trip = sentinel.check(OPTIM_STEPS + 1, 1.0, grad_norm=stats[1])
    run.update({"planted_changed": changed, "guard_stats": [
        stats[0], repr(stats[1])], "sentinel": trip and trip["kind"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    if changed:
        failed.append(f"bf16_adamw: the skipped step changed {changed[:4]}")
    if stats[0] != 1 or math.isfinite(stats[1]):
        failed.append(f"guard_stats {stats}, want (1, non-finite)")
    if run["sentinel"] != "nonfinite_grad":
        failed.append(f"the sentinel reported {trip}, not nonfinite_grad")
    out["bf16_adamw"] = run
    del t, guard, masters, mb
    gc.collect()
    torch.cuda.empty_cache()
    t = _optim_trainer(cfg, adamw(OPTIM_LR, b1=0.9, b2=0.95),
                       wsam_value_and_grad(rho=0.05))
    out["wsam"] = _optim_steps(t, batches(t, OPTIM_WSAM_STEPS),
                               2 * cfg.num_layers, failed, "wsam")
    del t
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "optim", "model": "llama_1b", "batch": SLICE["b"],
          "seq": SLICE["s"], "lr": OPTIM_LR, **out,
          "nvidia_smi": nvidia_smi_line()})
    if failed:
        raise AssertionError("optim: " + "; ".join(failed))
    return out


#: phase "sequence": llama_1b's width at SEQ_S tokens a sequence, cut to
#: MESH_LAYERS layers, one sequence a step, on (seq 2) in two gloo ranks
#: on ``cuda:0``: ring attention, then Ulysses, against the one-process
#: step from the same seed; a ring that drops every chunk but the
#: diagonal must fail the same gates
SEQ_S = 16384
SEQ_WARMUP, SEQ_TIMED = 1, 2
SEQ_RUNS = ("ring", "ulysses", "ring_planted")
#: the flash kernels' shapes under "sequence": the ring's chunk (causal on
#: the diagonal, non-causal on an earlier chunk) and Ulysses' whole
#: sequence at half the heads
RING_CHUNK = dict(b=1, s=SEQ_S // 2, h=32, kvh=4, d=64, causal=True)
RING_FULL = dict(RING_CHUNK, causal=False)
ULYSSES = dict(b=1, s=SEQ_S, h=16, kvh=2, d=64, causal=True)
#: the ring Function alone against its plain version: a small shape
RING_SMALL = dict(b=1, s=2048, h=32, kvh=4, d=64)
#: on CPU ranks (a dry run of the phase's logic): llama_tiny's sequence
SEQ_S_CPU = 256
#: phase "moe": llama_1b's width with llama_moe_tiny's experts and k, cut
#: to MESH_LAYERS layers, batch 3 x 2048, one process, then tp_fsdp on
#: (expert 2) in two gloo ranks on ``cuda:0``, each holding two experts
MOE = dict(num_experts=4, moe_top_k=2, moe_capacity_factor=1.25)
MOE_WARMUP, MOE_TIMED = 1, 2


def _shape_key(kernel: str, shape: dict) -> str:
    """A kernel at a shape, as ``SHAPE_LAUNCHES`` counts it (JSON-safe)."""
    dims = "x".join(str(shape[k]) for k in ("b", "s", "h", "kvh", "d"))
    return f"{kernel}@{dims}{'c' if shape['causal'] else 'n'}"


def _shape_launches() -> dict:
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa

    return {_shape_key(k, dict(zip(("b", "s", "h", "kvh", "d"), dims),
                                causal=c)): n
            for (k, dims, c), n in fa.SHAPE_LAUNCHES.items()}


def _seq_cfg(layers: int, device=None):
    import dataclasses

    from dlrover_tpu_torch.models import llama

    cfg = (llama.llama_tiny(max_seq_len=SEQ_S_CPU) if device == "cpu"
           else llama.llama_1b(remat="dots_attn_out", max_seq_len=SEQ_S))
    return dataclasses.replace(cfg, num_layers=layers)


def _moe_cfg(layers: int, device=None):
    import dataclasses

    from dlrover_tpu_torch.models import llama

    cfg = (llama.llama_moe_tiny() if device == "cpu"
           else llama.llama_1b(remat="dots_attn_out", **MOE))
    return dataclasses.replace(cfg, num_layers=layers)


def _run_steps(t, batches, cuda: bool) -> dict:
    """Each batch's step, timed one by one: losses, step and collective
    ms, the bytes ppermute and all_to_all sent, the kernels' launches by
    shape, peak memory."""
    import torch

    from dlrover_tpu_torch.trainer import distributed as coll

    run = {"losses": [], "step_ms": [], "collective_ms": [],
           "sent_bytes": []}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    before = _shape_launches()
    for mb in batches:
        coll.collective_bytes(reset=True)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = t.train_step(mb)
        if cuda:
            torch.cuda.synchronize()
        run["step_ms"].append((time.perf_counter() - t0) * 1e3)
        run["collective_ms"].append(t.reduce_seconds * 1e3)
        run["sent_bytes"].append(coll.collective_bytes())
        run["losses"].append(loss.item())
    after = _shape_launches()
    run["launches"] = {k: n - before.get(k, 0) for k, n in after.items()
                       if n != before.get(k, 0)}
    run["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 2**30
                          if cuda else None)
    return run


def _ring_alone(mesh, device) -> dict:
    """The ring Function at RING_SMALL on the card (the kernels) against
    the same Function on host copies (their plain versions): the output
    and the gradients of q, k, v under the kernels' element rule."""
    import torch

    from dlrover_tpu_torch.parallel import context_parallel as cp
    from dlrover_tpu_torch.parallel.mesh import SEQ_AXIS, axis_index

    b, s, h, kvh, d = (RING_SMALL[k] for k in ("b", "s", "h", "kvh", "d"))
    gen = torch.Generator().manual_seed(3)
    full = [torch.randn(b, s, n, d, generator=gen).to(torch.bfloat16)
            for n in (h, kvh, kvh, h)]
    i, s_loc = axis_index(mesh, SEQ_AXIS), s // 2
    q, k, v, do = (x[:, i * s_loc:(i + 1) * s_loc] for x in full)

    def run(dev):
        leaves = [x.to(dev).requires_grad_() for x in (q, k, v)]
        o = cp.ring_attention(*leaves, mesh)
        return [o] + list(torch.autograd.grad(o, leaves, do.to(dev)))

    got = run(device or "cuda")
    want = run("cpu")
    errors = {label: closeness(label, g.cpu(), w)
              for label, g, w in zip(("o", "dq", "dk", "dv"), got, want)}
    return {"shape": RING_SMALL, "errors": errors,
            "ok": all(e["ok"] for e in errors.values())}


def sequence_rank(work: str, layers: int, device=None) -> None:
    """One rank of phase "sequence" (``python -c``): the ring Function
    alone, then the "sequence" trainer on (seq 2) with each attention of
    SEQ_RUNS (the planted ring drops every chunk but the diagonal); one
    JSON result file."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.ops.cuda import flash_attention as fa
    from dlrover_tpu_torch.parallel import context_parallel as cp
    from dlrover_tpu_torch.parallel.mesh import create_mesh
    from dlrover_tpu_torch.trainer import distributed as coll
    from dlrover_tpu_torch.trainer.sharded import (
        adamw, make_trainer_for_llama)

    env = coll.init_from_env(timeout_s=120, backend="gloo", device=device)
    cuda = device != "cpu"
    cfg = _seq_cfg(layers, device)
    data = np.load(os.path.join(work, "batches.npz"))
    mesh = create_mesh([("seq", 2)], device=device)
    out = {"rank": env.rank, "routes": {
        op: coll.collective_route(dist.group.WORLD, op,
                                  "cuda" if cuda else "cpu")
        for op in coll.GLOO_CUDA_ROUTES},
        "ring_alone": _ring_alone(mesh, device), "runs": {}}
    init = torch.load(os.path.join(work, "init.pt"), map_location="cpu")
    ref = torch.load(os.path.join(work, "reference.pt"), map_location="cpu")
    sound_case = fa._chunk_case

    def diagonal_only(q_start, k_start, s_loc, causal):
        case = sound_case(q_start, k_start, s_loc, causal)
        return case if q_start == k_start else "masked"

    for kind in SEQ_RUNS:
        if cuda:
            torch.cuda.empty_cache()
        attn = (cp.make_context_parallel_attn(mesh, "ulysses")
                if kind == "ulysses" else None)
        t = make_trainer_for_llama(
            cfg, device=device, strategy="sequence", mesh=mesh,
            attn_fn=attn, optimizer=adamw(MESH_LR, b1=0.9, b2=0.95))
        t.init(seed=0)
        batches = [t.shard_batch(t.microbatch(t.split_batch(
            (data["tokens"][i], data["targets"][i]))))
            for i in range(len(data["tokens"]))]
        fa._chunk_case = (diagonal_only if kind == "ring_planted"
                          else sound_case)
        try:
            run = _run_steps(t, batches, cuda)
        finally:
            fa._chunk_case = sound_case
        run["device"] = str(t.local_shards()[0][2].device)
        run.update(_against_reference(t, ref, init, len(batches)))
        out["runs"][kind] = run
        del t, batches
        dist.barrier()
    with open(os.path.join(work, f"rank{env.rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _one_process_steps(cfg, work: str, batches, device=None,
                       record_moe: bool = False) -> dict:
    """The port's one-process step from seed 0 on ``batches``: its
    initial parameters to ``init.pt``, those after the last step to
    ``reference.pt``, and the run's readings (:func:`_run_steps`); with
    ``record_moe`` first the routing of layer 0 on the first batch and
    the auxiliary loss (no step)."""
    import torch

    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.trainer.sharded import (
        adamw, make_trainer_for_llama)

    t = make_trainer_for_llama(cfg, device=device,
                               optimizer=adamw(MESH_LR, b1=0.9, b2=0.95))
    t.init(seed=0)
    torch.save({n: p.detach().cpu() for n, p in t.model.named_parameters()},
               os.path.join(work, "init.pt"))
    mbs = [t.shard_batch(t.microbatch(b)) for b in batches]
    out = _moe_routing(t, mbs[0]) if record_moe else {}
    out.update(_run_steps(t, mbs, device != "cpu"))
    torch.save({n: p.detach().cpu() for n, p in t.model.named_parameters()},
               os.path.join(work, "reference.pt"))
    del t, mbs
    if device != "cpu":
        torch.cuda.empty_cache()
    return out


def _sequence_gates(ranks, reference: dict, layers: int, cuda: bool,
                    failed: list) -> None:
    """Phase "sequence"'s gates on the ranks' results."""
    want = reference["losses"]
    for r, res in enumerate(ranks):
        if not res["ring_alone"]["ok"]:
            failed.append(f"rank {r}: the ring Function against its plain "
                          f"version: {res['ring_alone']['errors']}")
        for kind, run in res["runs"].items():
            bad = []
            if any(abs(a - b) > MESH_LOSS_RTOL * abs(b)
                   for a, b in zip(run["losses"], want)):
                bad.append(f"losses {run['losses']} vs {want}")
            if run["param_within_2lr_share"] < MESH_WITHIN_SHARE:
                bad.append(f"parameters {run['param_within_2lr_share']:.5%}"
                           " within 2 lr and one ulp")
            if run["param_diff_lr"]["per_step"] > 2.0 * len(want):
                bad.append(f"parameters {run['param_diff_lr']['per_step']}"
                           " lr beyond one ulp a step")
            planted = kind.endswith("_planted")
            if planted and not bad:
                failed.append(f"rank {r}: the planted {kind} passes the "
                              "gates")
            elif not planted:
                failed += [f"{kind} rank {r}: {b}" for b in bad]
            if not cuda or planted:
                continue
            steps = len(run["losses"])
            if kind == "ring":
                # rank r holds the diagonal and r earlier chunks
                expect = {_shape_key(k, RING_CHUNK): layers * steps
                          for k in REPLACES}
                if r:
                    expect.update({_shape_key(k, RING_FULL): r * layers
                                   * steps for k in REPLACES})
            else:
                expect = {_shape_key(k, ULYSSES): layers * steps
                          for k in REPLACES}
            if run["launches"] != expect:
                failed.append(f"{kind} rank {r}: launches "
                              f"{run['launches']}, want {expect}")
            if run["device"] != "cuda:0":
                failed.append(f"{kind} rank {r} on {run['device']}")


def run_sequence(layers: int = MESH_LAYERS, device=None) -> dict:
    """Phase "sequence"'s body at ``layers`` layers: the one-process
    reference, the two ranks (:func:`sequence_rank`), the gates; returns
    the readings and the failed gates. ``device="cpu"`` runs llama_tiny
    at SEQ_S_CPU tokens on CPU ranks (the logic alone: the ring's chunks
    on the kernels' plain versions)."""
    import numpy as np

    cfg = _seq_cfg(layers, device)
    s = SEQ_S_CPU if device == "cpu" else SEQ_S
    work = tempfile.mkdtemp(prefix="dlrover_seq_")
    failed = []
    try:
        steps = SEQ_WARMUP + SEQ_TIMED
        tokens = np.random.default_rng(13).integers(
            0, cfg.vocab_size, (steps, 1, s + 1))
        batches = [(x[:, :-1], x[:, 1:]) for x in tokens]
        np.savez(os.path.join(work, "batches.npz"), tokens=tokens[:, :, :-1],
                 targets=tokens[:, :, 1:])
        t0 = time.time()
        reference = _one_process_steps(cfg, work, batches, device)
        reference_s = time.time() - t0
        t0 = time.time()
        ranks, _ = _rank_group(work, 2, f"sequence_rank({work!r}, {layers}, "
                               f"{device!r})", "sequence")
        ranks_s = time.time() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _sequence_gates(ranks, reference, layers, device != "cpu", failed)

    def med(xs):
        return statistics.median(xs[SEQ_WARMUP:])

    runs = {}
    for kind in SEQ_RUNS:
        per_rank = [r["runs"][kind] for r in ranks]
        runs[kind] = {
            "losses": per_rank[0]["losses"],
            "loss_rel": max(abs(a - b) / abs(b) for run in per_rank
                            for a, b in zip(run["losses"],
                                            reference["losses"])),
            "step_ms": [med(run["step_ms"]) for run in per_rank],
            "collective_ms": [med(run["collective_ms"]) for run in per_rank],
            "sent_bytes_per_step": [run["sent_bytes"][-1]
                                    for run in per_rank],
            "launches_per_step": [
                {k: n / len(run["losses"]) for k, n in
                 run["launches"].items()} for run in per_rank],
            "peak_mem_gb": [run["peak_mem_gb"] for run in per_rank],
            "param_within_2lr_share": min(
                run["param_within_2lr_share"] for run in per_rank),
            "param_diff_lr": {k: max(run["param_diff_lr"][k]
                                     for run in per_rank)
                              for k in per_rank[0]["param_diff_lr"]},
            "update_rel_err": math.sqrt(
                sum(run["param_diff_sq"] for run in per_rank)
                / max(sum(run["reference_update_sq"] for run in per_rank),
                      1e-300)),
        }
    launches = {}
    for kind in ("ring", "ulysses"):
        for r in ranks:
            for k, n in r["runs"][kind]["launches"].items():
                launches[k] = launches.get(k, 0) + n
    return {"readings": {
        "reference": {"losses": reference["losses"],
                      "step_ms": med(reference["step_ms"]),
                      "peak_mem_gb": reference["peak_mem_gb"]},
        "runs": runs, "routes": ranks[0]["routes"],
        "ring_alone": [r["ring_alone"] for r in ranks],
        "reference_s": reference_s, "ranks_s": ranks_s,
        "launches": launches}, "failed": failed}


def phase_sequence() -> dict:
    """Long context on the card: the docstring's phase 15."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    got = run_sequence(MESH_LAYERS)
    emit({"phase": "sequence", "model": "llama_1b", "layers": MESH_LAYERS,
          "batch": 1, "seq": SEQ_S, "mesh": {"seq": 2}, "lr": MESH_LR,
          "warmup": SEQ_WARMUP, "timed": SEQ_TIMED, "backend": "gloo",
          "phase_s": time.time() - t0, **got["readings"],
          "nvidia_smi": nvidia_smi_line()})
    if got["failed"]:
        raise AssertionError("sequence: " + "; ".join(got["failed"]))
    return got["readings"]


def _moe_routing(t, mb) -> dict:
    """Layer 0's global routing on ``mb``'s first microbatch (int32 [N,
    E]: each token's slot in each expert's queue, -1 where it was not
    dispatched) and the auxiliary loss, in a forward without grad."""
    import torch

    from dlrover_tpu_torch.models import llama

    block = t.model.blocks[0]
    block.record_routing = []
    try:
        with torch.no_grad():
            _, _, aux = llama.next_token_sums(t.model,
                                              tuple(x[0] for x in mb))
        routing = block.record_routing[0]
    finally:
        block.record_routing = None
    k = t.model.cfg.moe_top_k
    kept = int((routing >= 0).sum())
    return {"routing_sum": int(routing.long().sum()),
            "routing": routing.cpu().numpy().tolist(), "aux": aux.item(),
            "dropped_share": 1.0 - kept / (routing.shape[0] * k)}


def moe_rank(work: str, layers: int, device=None) -> None:
    """One rank of phase "moe" (``python -c``): tp_fsdp on (expert 2),
    layer 0's routing of the first batch, then the steps; one JSON
    result file."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.parallel.mesh import create_mesh
    from dlrover_tpu_torch.trainer import distributed as coll
    from dlrover_tpu_torch.trainer.sharded import (
        adamw, make_trainer_for_llama)

    env = coll.init_from_env(timeout_s=120, backend="gloo", device=device)
    cuda = device != "cpu"
    cfg = _moe_cfg(layers, device)
    data = np.load(os.path.join(work, "batches.npz"))
    t = make_trainer_for_llama(
        cfg, device=device, strategy="tp_fsdp",
        mesh=create_mesh([("expert", 2)], device=device),
        optimizer=adamw(MESH_LR, b1=0.9, b2=0.95))
    t.init(seed=0)
    batches = [t.shard_batch(t.microbatch(t.split_batch(
        (data["tokens"][i], data["targets"][i]))))
        for i in range(len(data["tokens"]))]
    run = _moe_routing(t, batches[0])
    run.update(_run_steps(t, batches, cuda))
    run["expert_bytes"] = sum(
        x.numel() * x.element_size() for name, _, x in t.local_shards()
        if name.split(".")[-1] in ("w_gate", "w_up", "w_down"))
    run["device"] = str(t.local_shards()[0][2].device)
    run.update(_against_reference(
        t, torch.load(os.path.join(work, "reference.pt"), map_location="cpu"),
        torch.load(os.path.join(work, "init.pt"), map_location="cpu"),
        len(batches)))
    run["rank"] = env.rank
    with open(os.path.join(work, f"rank{env.rank}.json"), "w") as f:
        json.dump(run, f)
    dist.barrier()
    dist.destroy_process_group()


def run_moe(layers: int = MESH_LAYERS, device=None) -> dict:
    """Phase "moe"'s body at ``layers`` layers: the one-process run, the
    two tp_fsdp ranks on (expert 2) (:func:`moe_rank`), the gates;
    returns the readings and the failed gates. ``device="cpu"`` runs
    llama_moe_tiny on CPU ranks (the logic alone)."""
    import numpy as np

    from dlrover_tpu_torch.auto.device_context import peak_flops_per_chip
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.trainer.profiler import utilization

    cfg = _moe_cfg(layers, device)
    b, s = SLICE["b"], (SLICE["s"] if device != "cpu" else 64)
    work = tempfile.mkdtemp(prefix="dlrover_moe_")
    failed = []
    try:
        steps = MOE_WARMUP + MOE_TIMED
        tokens = np.random.default_rng(17).integers(
            0, cfg.vocab_size, (steps, b, s + 1))
        batches = [(x[:, :-1], x[:, 1:]) for x in tokens]
        np.savez(os.path.join(work, "batches.npz"), tokens=tokens[:, :, :-1],
                 targets=tokens[:, :, 1:])
        t0 = time.time()
        solo = _one_process_steps(cfg, work, batches, device,
                                  record_moe=True)
        solo_s = time.time() - t0
        t0 = time.time()
        ranks, _ = _rank_group(work, 2, f"moe_rank({work!r}, {layers}, "
                               f"{device!r})", "moe")
        ranks_s = time.time() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cuda = device != "cpu"
    whole = (3 * layers * cfg.num_experts * cfg.hidden_size
             * cfg.intermediate_size * cfg.dtype.itemsize)
    want = solo["losses"]
    for r, run in enumerate(ranks):
        if run["routing"] != solo["routing"]:
            failed.append(f"rank {r}: layer 0's dispatch differs from the "
                          "one process's")
        if any(abs(a - x) > MESH_LOSS_RTOL * abs(x)
               for a, x in zip(run["losses"], want)):
            failed.append(f"rank {r}: losses {run['losses']} vs {want}")
        if run["param_within_2lr_share"] < MESH_WITHIN_SHARE:
            failed.append(f"rank {r}: parameters "
                          f"{run['param_within_2lr_share']:.5%} within 2 lr "
                          "and one ulp")
        if run["param_diff_lr"]["per_step"] > 2.0 * len(want):
            failed.append(f"rank {r}: parameters "
                          f"{run['param_diff_lr']['per_step']} lr beyond "
                          "one ulp a step")
        if 2 * run["expert_bytes"] != whole:
            failed.append(f"rank {r}: expert bytes {run['expert_bytes']}, "
                          f"half of {whole} expected")
        if cuda:
            steps = len(run["losses"])
            expect = {_shape_key(k, SLICE): layers * steps
                      for k in REPLACES}
            if run["launches"] != expect or run["device"] != "cuda:0":
                failed.append(f"rank {r}: launches {run['launches']} on "
                              f"{run['device']}, want {expect}")
    peak = peak_flops_per_chip() if cuda else 0.0
    flops = llama.flops_per_token(cfg, s) * b * s

    def med(xs):
        return statistics.median(xs[MOE_WARMUP:])

    def line(run):
        step_s = med(run["step_ms"]) / 1e3
        return {"losses": run["losses"], "aux": run["aux"],
                "dropped_share": run["dropped_share"],
                "step_ms": step_s * 1e3,
                "collective_ms": med(run["collective_ms"]),
                "mfu_percent": utilization(flops, step_s, peak),
                "peak_mem_gb": run["peak_mem_gb"]}

    return {"readings": {
        "one_process": line(solo),
        "ranks": [dict(line(run), expert_bytes=run["expert_bytes"],
                       param_within_2lr_share=run["param_within_2lr_share"],
                       param_diff_lr=run["param_diff_lr"],
                       routing_equal=run["routing"] == solo["routing"])
                  for run in ranks],
        "expert_bytes_whole": whole, "model_flops_per_step": flops,
        "params": llama.param_count(cfg), "solo_s": solo_s,
        "ranks_s": ranks_s}, "failed": failed}


def phase_moe() -> dict:
    """The MoE Llama on the card: the docstring's phase 16."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    got = run_moe(MESH_LAYERS)
    emit({"phase": "moe", "model": "llama_1b", **MOE, "layers": MESH_LAYERS,
          "batch": SLICE["b"], "seq": SLICE["s"], "mesh": {"expert": 2},
          "strategy": "tp_fsdp", "lr": MESH_LR, "warmup": MOE_WARMUP,
          "timed": MOE_TIMED, "backend": "gloo",
          "phase_s": time.time() - t0, **got["readings"],
          "nvidia_smi": nvidia_smi_line()})
    if got["failed"]:
        raise AssertionError("moe: " + "; ".join(got["failed"]))
    return got["readings"]


# ---------------------------------------------------------------------------
# phase "pipeline": GPipe and the interleaved schedule over (pipe 2)

#: batch 4 x 2048 in 4 pipeline microbatches of one row (the flash
#: kernels' shape in each stage, PIPE_MB), 1 warm-up and 2 timed steps
PIPE_B, PIPE_M = 4, 4
PIPE_WARMUP, PIPE_TIMED = 1, 2
#: (run, chunks a stage): GPipe, the interleaved schedule, and GPipe with
#: the planted fault (the embedding's gradient not summed over pipe)
PIPE_RUNS = (("gpipe", 1), ("interleaved", 2), ("gpipe_planted", 1))
PIPE_MB = dict(b=1, s=2048, h=32, kvh=4, d=64, causal=True)
#: on CPU ranks (a dry run of the phase's logic): llama_tiny's sequence
PIPE_S_CPU = 64
#: the pipeline's own collectives, by collective_bytes' label
PIPE_OPS = ("ppermute", "pipeline_outputs", "pipeline_feed")


def _digest(t) -> str:
    import hashlib

    import torch

    return hashlib.sha256(t.detach().cpu().contiguous().view(
        torch.uint8).numpy().tobytes()).hexdigest()


def _pipe_expected(cfg, chunks: int, rank: int, s: int) -> dict:
    """What the schedule says of one rank's step on (pipe 2): its
    activation sends (forward to the next stage unless final, dX back to
    the stage that fed it), their bytes, the bytes of the outputs'
    all-reduce and of the embedding gradient's, the launches of each
    kernel (the forward twice: remat "dots" recomputes attention), and
    the bubble."""
    from dlrover_tpu_torch.parallel import pipeline

    pp, layers = 2, cfg.num_layers
    local = layers // pp
    mb = PIPE_B // PIPE_M
    act = mb * s * cfg.hidden_size * cfg.dtype.itemsize
    ticks = PIPE_M * chunks + pp - 1
    sends = 0
    for t in range(ticks):
        w = pipeline._work(t, rank, pp, PIPE_M, chunks)
        if w is not None and not (rank == pp - 1 and w[1] == chunks - 1):
            sends += 1  # forward
        if w is not None and not (rank == 0 and w[1] == 0):
            sends += 1  # backward, to the feeding stage
    return {"sends": sends, "bytes": {
        "ppermute": sends * act,
        "pipeline_outputs": PIPE_B * s * cfg.hidden_size * cfg.dtype.itemsize,
        "pipeline_feed": cfg.vocab_size * cfg.hidden_size
        * cfg.dtype.itemsize},
        "launches": {"fwd": 2 * PIPE_M * local, "dq": PIPE_M * local,
                     "dkv": PIPE_M * local},
        "bubble": pipeline.bubble_fraction(pp, PIPE_M, chunks)}


def pipeline_rank(work: str, layers: int, device=None) -> None:
    """One rank of phase "pipeline" (``python -c``): the "pipeline"
    trainer on (pipe 2) under each of PIPE_RUNS, against the one-process
    reference; one JSON result file."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.parallel.mesh import create_mesh
    from dlrover_tpu_torch.trainer import distributed as coll
    from dlrover_tpu_torch.trainer.sharded import (
        adamw, make_trainer_for_llama)

    env = coll.init_from_env(timeout_s=120, backend="gloo", device=device)
    cuda = device != "cpu"
    cfg = _mesh_cfg(layers, device)
    data = np.load(os.path.join(work, "batches.npz"))
    mesh = create_mesh([("pipe", 2)], device=device)
    init = torch.load(os.path.join(work, "init.pt"), map_location="cpu")
    ref = torch.load(os.path.join(work, "reference.pt"), map_location="cpu")
    out = {"rank": env.rank, "runs": {}}
    for kind, chunks in PIPE_RUNS:
        if cuda:
            torch.cuda.empty_cache()
        t = make_trainer_for_llama(
            cfg, device=device, strategy="pipeline", mesh=mesh,
            num_microbatches=PIPE_M, num_chunks=chunks,
            optimizer=adamw(MESH_LR, b1=0.9, b2=0.95))
        t.init(seed=0)
        if kind.endswith("_planted"):
            for lay in t._layouts:
                lay.reduce_axes = tuple(a for a in lay.reduce_axes
                                        if a != "pipe")
        batches = [t.shard_batch(t.microbatch(t.split_batch(
            (data["tokens"][i], data["targets"][i]))))
            for i in range(len(data["tokens"]))]
        run = _run_steps(t, batches, cuda)
        run["layers_held"] = sorted(
            int(n.split(".")[1]) for n, _ in t.model.named_parameters()
            if n.endswith("attn_norm"))
        run["state_bytes"] = t.state_bytes()
        run["device"] = str(t.local_shards()[0][2].device)
        run["replicated"] = {n: _digest(p) for n, p in
                             t.model.named_parameters()
                             if not n.startswith("blocks.")}
        run.update(_against_reference(t, ref, init, len(batches)))
        with torch.no_grad():
            _, _, stats = t.model.hidden_states_and_aux(
                batches[0][0][0], schedule_stats=True)
        run["stats"] = stats
        out["runs"][kind] = run
        del t, batches
        dist.barrier()
    with open(os.path.join(work, f"rank{env.rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _pipeline_gates(ranks, reference: dict, cfg, s: int, cuda: bool,
                    failed: list) -> None:
    """Phase "pipeline"'s gates on the ranks' results."""
    want = reference["losses"]
    for kind, chunks in PIPE_RUNS:
        runs = [res["runs"][kind] for res in ranks]
        bad = []
        for r, run in enumerate(runs):
            if any(abs(a - b) > MESH_LOSS_RTOL * abs(b)
                   for a, b in zip(run["losses"], want)):
                bad.append(f"rank {r}: losses {run['losses']} vs {want}")
            if run["param_within_2lr_share"] < MESH_WITHIN_SHARE:
                bad.append(f"rank {r}: parameters "
                           f"{run['param_within_2lr_share']:.5%} within 2 "
                           "lr and one ulp")
            if run["param_diff_lr"]["per_step"] > 2.0 * len(want):
                bad.append(f"rank {r}: parameters "
                           f"{run['param_diff_lr']['per_step']} lr beyond "
                           "one ulp a step")
        if runs[0]["replicated"] != runs[1]["replicated"]:
            bad.append("the replicated leaves differ across the ranks")
        if kind.endswith("_planted"):
            if not bad:
                failed.append(f"the planted {kind} passes the gates")
            continue
        failed += [f"{kind}: {b}" for b in bad]
        from dlrover_tpu_torch.parallel import pipeline

        for r, run in enumerate(runs):
            expect = _pipe_expected(cfg, chunks, r, s)
            if run["layers_held"] != pipeline.stage_layers(
                    cfg.num_layers, 2, r, chunks):
                failed.append(f"{kind} rank {r} holds layers "
                              f"{run['layers_held']}")
            sent = {op: run["sent_bytes"][-1].get(op, 0) for op in PIPE_OPS}
            if sent != expect["bytes"]:
                failed.append(f"{kind} rank {r}: bytes a step {sent}, want "
                              f"{expect['bytes']}")
            if abs(run["stats"]["bubble_measured"] - expect["bubble"]) > 1e-9:
                failed.append(f"{kind} rank {r}: bubble "
                              f"{run['stats']['bubble_measured']}, want "
                              f"{expect['bubble']}")
            if not cuda:
                continue
            steps = len(run["losses"])
            want_launches = {_shape_key(k, PIPE_MB): n * steps
                             for k, n in expect["launches"].items()}
            if run["launches"] != want_launches:
                failed.append(f"{kind} rank {r}: launches {run['launches']}, "
                              f"want {want_launches}")
            if run["device"] != "cuda:0":
                failed.append(f"{kind} rank {r} on {run['device']}")


def run_pipeline(layers: int = MESH_LAYERS, device=None) -> dict:
    """Phase "pipeline"'s body at ``layers`` layers: the one-process
    reference, the two ranks (:func:`pipeline_rank`), the gates; returns
    the readings and the failed gates. ``device="cpu"`` runs llama_tiny
    at PIPE_S_CPU tokens on CPU ranks (the logic alone)."""
    import numpy as np

    cfg = _mesh_cfg(layers, device)
    s = PIPE_S_CPU if device == "cpu" else SLICE["s"]
    work = tempfile.mkdtemp(prefix="dlrover_pipe_")
    failed = []
    try:
        steps = PIPE_WARMUP + PIPE_TIMED
        tokens = np.random.default_rng(19).integers(
            0, cfg.vocab_size, (steps, PIPE_B, s + 1))
        batches = [(x[:, :-1], x[:, 1:]) for x in tokens]
        np.savez(os.path.join(work, "batches.npz"), tokens=tokens[:, :, :-1],
                 targets=tokens[:, :, 1:])
        t0 = time.time()
        reference = _one_process_steps(cfg, work, batches, device)
        reference_s = time.time() - t0
        t0 = time.time()
        ranks, _ = _rank_group(work, 2, f"pipeline_rank({work!r}, {layers}, "
                               f"{device!r})", "pipeline")
        ranks_s = time.time() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _pipeline_gates(ranks, reference, cfg, s, device != "cpu", failed)

    def med(xs):
        return statistics.median(xs[PIPE_WARMUP:])

    runs = {}
    for kind, chunks in PIPE_RUNS:
        per_rank = [r["runs"][kind] for r in ranks]
        runs[kind] = {
            "chunks": chunks,
            "losses": per_rank[0]["losses"],
            "loss_rel": max(abs(a - b) / abs(b) for run in per_rank
                            for a, b in zip(run["losses"],
                                            reference["losses"])),
            "step_ms": [med(run["step_ms"]) for run in per_rank],
            "collective_ms": [med(run["collective_ms"]) for run in per_rank],
            "sent_bytes_per_step": [run["sent_bytes"][-1]
                                    for run in per_rank],
            "bubble_measured": [run["stats"]["bubble_measured"]
                                for run in per_rank],
            "bubble_predicted": _pipe_expected(cfg, chunks, 0, s)["bubble"],
            "launches_per_step": [
                {k: n / len(run["losses"]) for k, n in
                 run["launches"].items()} for run in per_rank],
            "layers_held": [run["layers_held"] for run in per_rank],
            "state_bytes": [run["state_bytes"] for run in per_rank],
            "peak_mem_gb": [run["peak_mem_gb"] for run in per_rank],
            "replicated_equal": (per_rank[0]["replicated"]
                                 == per_rank[1]["replicated"]),
            "param_within_2lr_share": [run["param_within_2lr_share"]
                                       for run in per_rank],
            "param_diff_lr": {k: max(run["param_diff_lr"][k]
                                     for run in per_rank)
                              for k in per_rank[0]["param_diff_lr"]},
        }
    launches = {k: 0 for k in REPLACES}
    for kind, _ in PIPE_RUNS:
        if kind.endswith("_planted"):
            continue
        for r in ranks:
            for k, n in r["runs"][kind]["launches"].items():
                name = k.split("@")[0]
                if k == _shape_key(name, PIPE_MB):
                    launches[name] += n
    return {"readings": {
        "reference": {"losses": reference["losses"],
                      "step_ms": med(reference["step_ms"]),
                      "peak_mem_gb": reference["peak_mem_gb"]},
        "runs": runs, "reference_s": reference_s, "ranks_s": ranks_s,
        "launches": launches}, "failed": failed}


def phase_pipeline() -> dict:
    """Pipeline parallelism on the card: the docstring's phase 17."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    got = run_pipeline(MESH_LAYERS)
    emit({"phase": "pipeline", "model": "llama_1b", "layers": MESH_LAYERS,
          "batch": PIPE_B, "seq": SLICE["s"], "microbatches": PIPE_M,
          "mesh": {"pipe": 2}, "strategy": "pipeline", "lr": MESH_LR,
          "warmup": PIPE_WARMUP, "timed": PIPE_TIMED, "backend": "gloo",
          "phase_s": time.time() - t0, **got["readings"],
          "nvidia_smi": nvidia_smi_line()})
    if got["failed"]:
        raise AssertionError("pipeline: " + "; ".join(got["failed"]))
    return got["readings"]



# ---------------------------------------------------------------------------
# phase "auto": the strategy search

#: the one-process search: llama_1b uncut at the slice's batch, the top 2
#: dryrun, then AUTO_STEPS steps of the winner
AUTO_STEPS = 3
#: the two-rank search: llama_1b at MESH_LAYERS, a global batch of
#: AUTO_MESH_B x 2048, BO with one iteration; each trained layout
#: AUTO_MESH_STEPS steps against the one-process step
AUTO_MESH_B = 6
AUTO_MESH_STEPS = 2
#: the planner's budget for the two-rank planned table, as a share of
#: what the replicated plan needs: under it, so the plan must shard a
#: parameter axis
AUTO_PLAN_SHARE = 0.75
#: gpt2_xl cut to 4 layers under fsdp, gpt2_small uncut under tp, the
#: CNN under fsdp: their global batches
AUTO_GPT_B, AUTO_GPT_S, AUTO_CNN_B = 8, 1024, 64
GPT_XL_LAYERS = 4
#: gpt2_small's heads over two tensor ranks: the kernels' shape under tp
GPT_TP = dict(b=AUTO_GPT_B, s=AUTO_GPT_S, h=6, kvh=6, d=64, causal=True)


def _auto_report(r, peak=None) -> dict:
    return {"strategy": r.strategy.to_json(), "fits": r.fits,
            "est_ms": r.est_step_seconds * 1e3,
            "est_memory_bytes": r.memory_bytes,
            "measured_ms": (None if r.measured_step_seconds is None
                            else r.measured_step_seconds * 1e3),
            "max_memory_allocated_bytes": peak, "error": r.error}


def _unexpected_errors(reports) -> list:
    """Reports whose dryrun failed other than by the card's own limits
    (``accelerate.EXPECTED_FAILURES``): a kernel that fails to build or
    launch cannot hide behind the search."""
    from dlrover_tpu_torch.auto.accelerate import EXPECTED_FAILURES

    return [f"{r.strategy}: {r.error}" for r in reports
            if r.error and not any(e in r.error for e in EXPECTED_FAILURES)]


def _auto_cfg(device=None):
    """llama_1b uncut; on the CPU (a dry run of the phase's logic)
    llama_tiny."""
    from dlrover_tpu_torch.models import llama

    return llama.llama_tiny() if device == "cpu" else llama.llama_1b()


def run_auto_search(device=None) -> dict:
    """The one-process search (``auto_accelerate(dryrun_top_k=2)``) at
    the slice's batch: every report with each dryrun's peak memory, the
    winner's AUTO_STEPS steps against ``make_trainer_for_llama`` of the
    same strategy and seed (bitwise) with their launches,
    ``dryrun_abstract``'s bytes, and how the analytic estimates fare
    against the card. Returns the readings and the failed gates."""
    import dataclasses

    import numpy as np
    import torch

    from dlrover_tpu_torch.auto import accelerate, analyser
    from dlrover_tpu_torch.auto.device_context import peak_flops_per_chip
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa
    from dlrover_tpu_torch.trainer.sharded import (
        adamw, make_trainer_for_llama)

    cuda = device != "cpu"
    cfg = _auto_cfg(device)
    b, s = (2, 64) if not cuda else (SLICE["b"], SLICE["s"])
    opt = adamw(1e-4, b1=0.9, b2=0.95)
    failed, peaks = [], {}
    real = accelerate._measure

    def measure(cfg_, strategy, *args, **kw):  # each dryrun's peak
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        try:
            return real(cfg_, strategy, *args, **kw)
        finally:
            if cuda:
                peaks[strategy] = torch.cuda.max_memory_allocated()

    accelerate._measure = measure
    try:
        t0 = time.perf_counter()
        res = accelerate.auto_accelerate(cfg, b, s, device=device,
                                         dryrun_top_k=2, optimizer=opt)
        search_s = time.perf_counter() - t0
    finally:
        accelerate._measure = real
    failed += _unexpected_errors(res.reports)
    reports = [_auto_report(r, peaks.get(r.strategy)) for r in res.reports]
    measured = [r for r in res.reports if r.measured_step_seconds]
    if len(measured) < 1:
        failed.append("the one-process search measured no candidate")
    x = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s + 1))
    batch = (x[:, :-1], x[:, 1:])
    win, strategy = res.trainer, res.strategy
    res.trainer = None
    win.init(seed=0)
    mb = win.shard_batch(win.microbatch(win.split_batch(batch)))
    if cuda:
        torch.cuda.synchronize()
    fa.reset_launches()
    losses = [win.train_step(mb).item() for _ in range(AUTO_STEPS)]
    launches = dict(fa.LAUNCHES)
    del win, mb
    if cuda:
        torch.cuda.empty_cache()
    # the same strategy and seed through make_trainer_for_llama
    ref = make_trainer_for_llama(
        dataclasses.replace(cfg, remat=strategy.remat),
        device=device, strategy=strategy.sharding, optimizer=opt)
    ref.init(seed=0)
    mb = ref.shard_batch(ref.microbatch(batch))
    ref_losses = [ref.train_step(mb).item() for _ in range(AUTO_STEPS)]
    del ref, mb
    if losses != ref_losses:
        failed.append(f"the winner's losses {losses} are not "
                      f"make_trainer_for_llama's {ref_losses}")
    if cuda:
        # the forward runs twice a layer where remat recomputes attention
        twice = strategy.remat in ("dots", "minimal")
        want = {"fwd": (2 if twice else 1) * cfg.num_layers * AUTO_STEPS,
                "dq": cfg.num_layers * AUTO_STEPS,
                "dkv": cfg.num_layers * AUTO_STEPS}
        if launches != want:
            failed.append(f"the winner launched {launches}, want {want}")
        torch.cuda.empty_cache()
        args, temp, out = accelerate.dryrun_abstract(cfg, strategy, b, s,
                                                     optimizer=opt)
    else:  # no temp bytes without the card's peak
        (args, out), temp = accelerate.abstract_bytes(
            cfg, strategy, b, s, device=device), None
    # how the analytic model fares on the card: its time and memory
    # against the dryruns', the step's MFU against mfu_guess, the remat
    # policies' measured ratio against REMAT_COMPUTE's
    flops = llama.flops_per_token(cfg, s) * b * s
    peak = peak_flops_per_chip() if cuda else analyser.PEAK_FLOPS
    fare = [{"remat": r.strategy.remat,
             "time_est_over_measured": r.est_step_seconds
             / r.measured_step_seconds,
             "memory_est_over_peak": (r.memory_bytes / peaks[r.strategy]
                                      if r.strategy in peaks else None),
             "mfu_measured": flops / r.measured_step_seconds / peak,
             "remat_compute": analyser.REMAT_COMPUTE[r.strategy.remat]}
            for r in measured]
    return {"readings": {
        "model": "llama_1b" if cuda else "llama_tiny", "batch": b,
        "seq": s, "search_s": search_s, "reports": reports,
        "winner": strategy.to_json(), "losses": losses,
        "reference_losses": ref_losses, "launches": launches,
        "dryrun_abstract": {"argument_bytes": args, "temp_bytes": temp,
                            "output_bytes": out},
        "estimates_on_the_card": fare,
        "mfu_guess": 0.4, "act_factor": analyser.ACT_FACTOR,
        "hbm_utilization_planner": _planner_hbm_utilization()},
        "failed": failed}


def _planner_hbm_utilization() -> float:
    from dlrover_tpu_torch.auto import planner

    return planner.HBM_UTILIZATION


def run_auto_envelope() -> dict:
    """One llama_1b step (remat "dots", AdamW) at batch 1 x
    ``SINGLE_CHIP_MAX_SEQ``: its peak must stay under 0.9 x the card's
    memory."""
    import dataclasses

    import numpy as np
    import torch

    from dlrover_tpu_torch.auto import strategy as strategy_lib
    from dlrover_tpu_torch.auto.device_context import hbm_bytes_per_chip
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.trainer.sharded import (
        adamw, make_trainer_for_llama)

    seq = strategy_lib.SINGLE_CHIP_MAX_SEQ
    cfg = dataclasses.replace(llama.llama_1b(remat="dots"), max_seq_len=seq)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = make_trainer_for_llama(cfg, optimizer=adamw(1e-4))
    t.init(seed=0)
    x = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, seq + 1))
    t0 = time.perf_counter()
    loss = t.train_step(t.shard_batch(t.microbatch(
        (x[:, :-1], x[:, 1:])))).item()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del t
    torch.cuda.empty_cache()
    limit = 0.9 * hbm_bytes_per_chip()
    failed = [] if peak < limit and math.isfinite(loss) else [
        f"batch 1 x {seq}: peak {peak} bytes (limit {limit}), loss {loss}"]
    return {"readings": {"seq": seq, "peak_bytes": peak, "limit": limit,
                         "loss": loss, "step_s": step_s}, "failed": failed}


def _auto_models(layers: int, device=None) -> dict:
    """{name: (config, global batch, seq)} of the two-rank group's
    layouts past the search: gpt2_xl cut to GPT_XL_LAYERS, gpt2_small
    uncut, the MNIST CNN; on the CPU gpt_tiny stands for both GPTs."""
    import dataclasses

    from dlrover_tpu_torch.models import cnn, gpt

    cpu = device == "cpu"
    xl = (gpt.gpt_tiny() if cpu
          else gpt.gpt2_xl(remat="dots_attn_out"))
    small = (gpt.gpt_tiny() if cpu
             else gpt.gpt2_small(remat="dots_attn_out"))
    s = 32 if cpu else AUTO_GPT_S
    return {"llama": (_mesh_cfg(layers, device), AUTO_MESH_B,
                      PIPE_S_CPU if cpu else SLICE["s"]),
            "gpt2_xl": (dataclasses.replace(xl, num_layers=GPT_XL_LAYERS),
                        AUTO_GPT_B, s),
            "gpt2_small": (small, AUTO_GPT_B, s),
            "cnn": (cnn.mnist_cnn(), AUTO_CNN_B, 1)}


def _auto_batches(cfg, b: int, s: int, seed: int) -> list:
    """AUTO_MESH_STEPS seeded global batches of the family's shape."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if type(cfg).__name__ == "CNNConfig":
        return [(rng.standard_normal((b, 28, 28, 1)).astype(np.float32),
                 rng.integers(0, cfg.num_classes, b))
                for _ in range(AUTO_MESH_STEPS)]
    out = []
    for _ in range(AUTO_MESH_STEPS):
        x = rng.integers(0, cfg.vocab_size, (b, s + 1))
        out.append((x[:, :-1], x[:, 1:]))
    return out


def _auto_reference(name: str, cfg, batches, work: str, device) -> dict:
    """The one-process step of ``cfg`` from seed 0 on ``batches`` (ddp,
    AdamW(MESH_LR, 0.9, 0.95)): initial and final parameters to
    ``{name}_init.pt`` and ``{name}_reference.pt``, the run's
    readings."""
    import torch

    from dlrover_tpu_torch.models import make_trainer_for
    from dlrover_tpu_torch.trainer.sharded import adamw

    t = make_trainer_for(cfg, device=device, strategy="ddp",
                         optimizer=adamw(MESH_LR, b1=0.9, b2=0.95))
    t.init(seed=0)
    torch.save({n: p.detach().cpu() for n, p in t.model.named_parameters()},
               os.path.join(work, f"{name}_init.pt"))
    out = _run_steps(t, [t.shard_batch(t.microbatch(b)) for b in batches],
                     device != "cpu")
    torch.save({n: p.detach().cpu() for n, p in t.model.named_parameters()},
               os.path.join(work, f"{name}_reference.pt"))
    del t
    if device != "cpu":
        torch.cuda.empty_cache()
    return out


def auto_rank(work: str, layers: int, device=None) -> None:
    """One rank of phase "auto"'s two-rank group (``python -c``): the
    search over llama_1b at ``layers`` layers with BO, its winner's
    steps, a planned table, gpt2_xl under fsdp, gpt2_small under tp and
    the CNN under fsdp, each against its one-process reference; one JSON
    result file."""
    import pickle

    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.auto import accelerate, planner
    from dlrover_tpu_torch.auto.device_context import (
        TARGET_CARD, hbm_bytes_per_chip)
    from dlrover_tpu_torch.models import make_trainer_for
    from dlrover_tpu_torch.parallel.mesh import create_mesh
    from dlrover_tpu_torch.trainer import distributed as coll
    from dlrover_tpu_torch.trainer.sharded import adamw

    env = coll.init_from_env(timeout_s=120, backend="gloo", device=device)
    cuda = device != "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False  # as the reference's
    torch.backends.cudnn.allow_tf32 = False
    models = _auto_models(layers, device)
    with open(os.path.join(work, "batches.pkl"), "rb") as f:
        batches = pickle.load(f)
    opt = adamw(MESH_LR, b1=0.9, b2=0.95)
    out = {"rank": env.rank, "runs": {}}

    def run(name, key, t):
        if cuda:
            torch.cuda.empty_cache()
        t.init(seed=0)
        mbs = [t.shard_batch(t.microbatch(t.split_batch(b)))
               for b in batches[key]]
        r = _run_steps(t, mbs, cuda)
        init = torch.load(os.path.join(work, f"{key}_init.pt"))
        ref = torch.load(os.path.join(work, f"{key}_reference.pt"))
        r.update(_against_reference(t, ref, init, len(mbs)))
        r["state_bytes"] = t.state_bytes()
        r["strategy"] = t.strategy
        r["mesh"] = {a: int(k) for a, k in zip(
            t.mesh.mesh_dim_names or (), t.mesh.mesh.shape)}
        out["runs"][name] = r
        dist.barrier()

    cfg, b, s = models["llama"]
    t0 = time.perf_counter()
    res = accelerate.auto_accelerate(cfg, b, s, device=device, bo_iters=1,
                                     optimizer=opt)
    out["search"] = {"strategy": res.strategy.to_json(),
                     "search_s": time.perf_counter() - t0,
                     "reports": [_auto_report(r) for r in res.reports]}
    win, res.trainer = res.trainer, None
    run("winner", "llama", win)
    del win
    # the plan under the card's whole memory (the replicated one), then
    # under a share of what it needs
    whole = planner.plan_rules_for_llama(cfg, [("fsdp", 2)], b, s,
                                         hbm_bytes_per_chip(TARGET_CARD))
    budget = (AUTO_PLAN_SHARE * whole.memory_bytes
              / planner.HBM_UTILIZATION)
    report = planner.plan_rules_for_llama(cfg, [("fsdp", 2)], b, s, budget)
    planner.register_plan("planned", report)
    out["plan"] = {"rules": {k: v for k, v in report.rules.items()},
                   "budget_bytes": budget,
                   "replicated_memory_bytes": whole.memory_bytes,
                   "memory_bytes": report.memory_bytes,
                   "comm_seconds": report.comm_seconds}
    for name, key, strategy, spec in (
            ("planned", "llama", "planned", [("fsdp", 2)]),
            ("gpt2_xl_fsdp", "gpt2_xl", "fsdp", [("fsdp", 2)]),
            ("gpt2_small_tp", "gpt2_small", "tp", [("tensor", 2)]),
            ("cnn_fsdp", "cnn", "fsdp", [("fsdp", 2)])):
        run(name, key, make_trainer_for(
            models[key][0], device=device, strategy=strategy,
            mesh=create_mesh(spec, device=device), optimizer=opt))
    with open(os.path.join(work, f"rank{env.rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _auto_gates(ranks, references: dict, cuda: bool, failed: list) -> None:
    """Phase "auto"'s two-rank gates: both ranks the same winner and the
    same agreed seconds, no unexpected dryrun error, every layout within
    "mesh"'s gates of its one-process step, gpt2_small's tp launches."""
    if ranks[0]["search"]["strategy"] != ranks[1]["search"]["strategy"]:
        failed.append(f"the ranks picked {ranks[0]['search']['strategy']} "
                      f"and {ranks[1]['search']['strategy']}")
    agreed = [[(r["strategy"], r["measured_ms"]) for r in rank["search"][
        "reports"] if r["measured_ms"] is not None] for rank in ranks]
    if agreed[0] != agreed[1] or not agreed[0]:
        failed.append(f"the ranks' measured seconds differ: {agreed}")
    from dlrover_tpu_torch.auto.accelerate import EXPECTED_FAILURES

    for r in ranks[0]["search"]["reports"]:
        if r["error"] and not any(e in r["error"] for e in
                                  EXPECTED_FAILURES):
            failed.append(f"{r['strategy']}: {r['error']}")
    if not any(ax not in ("batch",) and rule for ax, rule in
               ranks[0]["plan"]["rules"].items()):
        failed.append(f"the plan shards no axis: {ranks[0]['plan']}")
    key_of = {"winner": "llama", "planned": "llama",
              "gpt2_xl_fsdp": "gpt2_xl", "gpt2_small_tp": "gpt2_small",
              "cnn_fsdp": "cnn"}
    for name, key in key_of.items():
        want = references[key]["losses"]
        for r, rank in enumerate(ranks):
            run = rank["runs"][name]
            if any(abs(a - b) > MESH_LOSS_RTOL * abs(b)
                   for a, b in zip(run["losses"], want)):
                failed.append(f"{name} rank {r}: losses {run['losses']} vs "
                              f"{want}")
            if run["param_within_2lr_share"] < MESH_WITHIN_SHARE:
                failed.append(f"{name} rank {r}: parameters "
                              f"{run['param_within_2lr_share']:.5%} within "
                              "2 lr and one ulp")
            if run["param_diff_lr"]["per_step"] > 2.0 * len(want):
                failed.append(f"{name} rank {r}: parameters "
                              f"{run['param_diff_lr']['per_step']} lr beyond "
                              "one ulp a step")
    if cuda:
        layers = _auto_models(MESH_LAYERS)["gpt2_small"][0].num_layers
        for r, rank in enumerate(ranks):
            got = {k.split("@")[0]: n for k, n in
                   rank["runs"]["gpt2_small_tp"]["launches"].items()}
            want = {k: layers * AUTO_MESH_STEPS for k in REPLACES}
            if got != want:
                failed.append(f"gpt2_small tp rank {r}: launches {got}, "
                              f"want {want}")


def run_auto_mesh(layers: int = MESH_LAYERS, device=None) -> dict:
    """Phase "auto"'s two-rank group at ``layers`` layers: the one-process
    references, the ranks (:func:`auto_rank`), the gates; returns the
    readings and the failed gates. ``device="cpu"`` runs llama_tiny and
    gpt_tiny on CPU ranks (the logic alone)."""
    import pickle

    models = _auto_models(layers, device)
    work = tempfile.mkdtemp(prefix="dlrover_auto_")
    failed = []
    try:
        batches = {key: _auto_batches(cfg, b, s, seed=23 + i)
                   for i, (key, (cfg, b, s)) in enumerate(models.items())}
        with open(os.path.join(work, "batches.pkl"), "wb") as f:
            pickle.dump(batches, f)
        t0 = time.time()
        references = {key: _auto_reference(key, models[key][0],
                                           batches[key], work, device)
                      for key in models}
        reference_s = time.time() - t0
        t0 = time.time()
        ranks, _ = _rank_group(work, 2, f"auto_rank({work!r}, {layers}, "
                               f"{device!r})", "auto")
        ranks_s = time.time() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _auto_gates(ranks, references, device != "cpu", failed)
    runs = {}
    for name in ranks[0]["runs"]:
        per_rank = [r["runs"][name] for r in ranks]
        runs[name] = {
            "strategy": per_rank[0]["strategy"], "mesh": per_rank[0]["mesh"],
            "losses": per_rank[0]["losses"],
            "step_ms": [run["step_ms"] for run in per_rank],
            "collective_ms": [run["collective_ms"] for run in per_rank],
            "peak_mem_gb": [run["peak_mem_gb"] for run in per_rank],
            "state_bytes": [run["state_bytes"] for run in per_rank],
            "launches": [run["launches"] for run in per_rank],
            "param_within_2lr_share": [run["param_within_2lr_share"]
                                       for run in per_rank],
        }
    launches = {k: sum(n for r in ranks for key, n in r["runs"][
        "gpt2_small_tp"]["launches"].items() if key.split("@")[0] == k)
        for k in REPLACES}
    return {"readings": {
        "search": ranks[0]["search"], "plan": ranks[0]["plan"],
        "references": {k: {"losses": v["losses"], "step_ms": v["step_ms"],
                           "peak_mem_gb": v["peak_mem_gb"]}
                       for k, v in references.items()},
        "runs": runs, "reference_s": reference_s, "ranks_s": ranks_s,
        "gpt_tp_launches": launches}, "failed": failed}


def phase_auto() -> dict:
    """The strategy search on the card: the docstring's phase 18."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    search = run_auto_search()
    emit({"phase": "auto_search", **search["readings"]})
    envelope = run_auto_envelope()
    emit({"phase": "auto_envelope", **envelope["readings"]})
    mesh = run_auto_mesh(MESH_LAYERS)
    emit({"phase": "auto", "layers": MESH_LAYERS, "backend": "gloo",
          "phase_s": time.time() - t0, **mesh["readings"],
          "nvidia_smi": nvidia_smi_line()})
    failed = search["failed"] + envelope["failed"] + mesh["failed"]
    if failed:
        raise AssertionError("auto: " + "; ".join(failed))
    return {"launches": search["readings"]["launches"],
            "gpt_tp_launches": mesh["readings"]["gpt_tp_launches"]}


#: phase "reshard": reshard-in-place (``reshard/``), the llama_1b fsdp step
#: of "mesh" (4 layers, 3 x 2048 a data-parallel rank) across two gloo
#: ranks on ``cuda:0``, a flash checkpoint every step on both tiers. Rank
#: 1 dies (SIGKILL) after its step RESHARD_LOST is durable; rank 0 shrinks
#: to a world of one in process, trains RESHARD_WORLD1_STEPS steps; a
#: joiner grows the world back to two, RESHARD_WORLD2_STEPS steps more
RESHARD_LAYERS = LAUNCHER_LAYERS
RESHARD_LOST = 3
RESHARD_WORLD1_STEPS = 2
RESHARD_WORLD2_STEPS = 2
RESHARD_FINAL = RESHARD_LOST + RESHARD_WORLD1_STEPS + RESHARD_WORLD2_STEPS
#: the global batch: 3 rows a data-parallel rank at world 2; at world 1
#: the survivor takes them all in two microbatches (ElasticTrainer)
RESHARD_GLOBAL_B = 2 * SLICE["b"]
#: the step whose live state the planted stale-live migration serves
RESHARD_STALE = RESHARD_LOST - 1
RESHARD_TIMEOUT_S = 300
RESHARD_HEARTBEAT_S = 30
#: on the CPU (a dry run of the phase's logic): llama_tiny at this length
RESHARD_S_CPU = 64
#: the rc of a rank that took the restart-the-world fallback
RESHARD_FALLBACK_RC = 7
#: the master KV key the harness sets when the joiner may report RUNNING
#: (the survivor idles): the joiner starts ahead, as a scheduler would
#: bring a node up, and announces itself then
RESHARD_GO_KEY = "reshard/drill/join"



def _box_sums(state, boxes=None) -> dict:
    """``{"path@box": checksum}`` of a train state's tensors, box by box
    (each ShardedLeaf's pieces; a plain tensor whole), other leaves as
    they are; with ``boxes`` ({path: [box, ...]}, another rank's) the
    same boxes cut out of this state's whole tensors. Equal sums are
    equal bits (``ckpt_store.state_checksums``'s checksum)."""
    import torch

    from dlrover_tpu_torch.trainer import ckpt_store

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    for path, leaf in ckpt_store.flatten_with_path(state):
        key = "/".join(str(c.get("k", c.get("i"))) for c in path)
        if isinstance(leaf, ckpt_store.ShardedLeaf):
            pieces = [([list(map(int, b)) for b in idx], t)
                      for idx, t in leaf.pieces]
            if boxes is not None:
                whole = _whole(leaf)
                pieces = [(idx, whole[tuple(slice(a, b) for a, b in idx)])
                          for idx in boxes.get(key, [])]
        elif isinstance(leaf, torch.Tensor):
            pieces = [([[0, n] for n in leaf.shape], leaf)]
        else:
            out[key] = leaf
            continue
        for idx, t in pieces:
            out[f"{key}@{idx}"] = ckpt_store._checksum(
                t.contiguous(), ints)
    return out


def _whole(leaf):
    """A ShardedLeaf's tensor whole, from pieces that cover it (a
    one-process state: a stacked leaf's layers are pieces of it)."""
    t0 = leaf.pieces[0][1]
    out = t0.new_empty(tuple(leaf.shape))
    for idx, t in leaf.pieces:
        out[tuple(slice(int(a), int(b)) for a, b in idx)] = t
    return out


def _numpy_state(state) -> dict:
    """{"path": (float32 or int array, dtype name)} of a one-process
    train state, each leaf whole in the JAX tree's coordinates (the
    start of a parity test's JAX side)."""
    import torch

    from dlrover_tpu_torch.trainer import ckpt_store

    out = {}
    for path, leaf in ckpt_store.flatten_with_path(state):
        key = "/".join(str(c.get("k", c.get("i"))) for c in path)
        if isinstance(leaf, ckpt_store.ShardedLeaf):
            leaf = _whole(leaf)
        if isinstance(leaf, torch.Tensor):
            x = leaf.detach().cpu()
            out[key] = ((x.float() if x.is_floating_point() else x).numpy(),
                        str(x.dtype).replace("torch.", ""))
        else:
            out[key] = (leaf, type(leaf).__name__)
    return out


def _sums_boxes(sums: dict) -> dict:
    """{path: [box, ...]} of a rank's ``_box_sums``."""
    out = {}
    for key in sums:
        if "@" in key:
            path, box = key.split("@", 1)
            out.setdefault(path, []).append(json.loads(box))
    return out


def _clone_state(state):
    """A copy of a train state's tensors (the planted stale live state)."""
    import torch

    from dlrover_tpu_torch.trainer import ckpt_store

    leaves = []
    for _, leaf in ckpt_store.flatten_with_path(state):
        if isinstance(leaf, ckpt_store.ShardedLeaf):
            leaf = leaf.with_tensors([t.clone() for t in leaf.tensors()])
        elif isinstance(leaf, torch.Tensor):
            leaf = leaf.clone()
        leaves.append(leaf)
    return ckpt_store.unflatten_like(state, leaves)


def reshard_tokens(cfg, s: int):
    """The phase's dataset: rows of ``s + 1`` token ids from seed 13,
    enough for every step and the one a dead rank left in flight."""
    import numpy as np

    n_rows = RESHARD_GLOBAL_B * (RESHARD_FINAL + 3)
    return np.random.default_rng(13).integers(
        0, cfg.vocab_size, (n_rows, s + 1))


def _reshard_cfg(layers: int, device=None, tiny: bool = False):
    """The phase's model: "mesh"'s (llama_1b cut to ``layers``; on the
    CPU llama_tiny), or with ``tiny`` on the card llama_tiny at head_dim
    64, which the flash kernels take."""
    from dlrover_tpu_torch.models import llama

    if tiny and device != "cpu":
        return llama.llama_tiny(hidden_size=256, num_layers=layers,
                                remat="dots_attn_out")
    return _mesh_cfg(layers, device)


def _reshard_trainer(cfg, device):
    """The phase's trainer: fsdp over the process group's world (JAX's
    default mesh), AdamW(1e-4, 0.9, 0.95) as in "mesh", seed 0."""
    from dlrover_tpu_torch.trainer.sharded import (
        adamw, make_trainer_for_llama)

    t = make_trainer_for_llama(cfg, device=device, strategy="fsdp",
                               optimizer=adamw(MESH_LR, b1=0.9, b2=0.95))
    t.init(seed=0)
    return t


def _restore_target(trainer, store_dir: str, step: int) -> dict:
    """A restore target of ``trainer``'s state at the dtypes ``step``
    saved (its AdamW moments fp32 after a step of two microbatches)."""
    from dlrover_tpu_torch.trainer import ckpt_store

    return ckpt_store.with_dtypes(
        {**trainer.train_state(), "step": 0, "data": ""},
        ckpt_store.step_dtypes(ckpt_store.get_store(store_dir), step))


def _state_bytes_expected(cfg, layers: int, world: int,
                          moment_bytes: int) -> dict:
    """An fsdp rank's parameter and optimizer bytes at ``world`` ranks
    ("mesh"'s byte gates): the bf16 matrices split over the ranks, the
    fp32 norms whole on each; AdamW's two moments at ``moment_bytes`` an
    element for the matrices, fp32 for the norms."""
    from dlrover_tpu_torch.models import llama

    norms = 4 * cfg.hidden_size * (2 * layers + 1)  # fp32 norms' bytes
    matrices = llama.param_count(cfg) - norms // 4  # elements
    return {"params": 2 * matrices // world + norms,
            "optimizer": 2 * (moment_bytes * matrices // world + norms)}


def reshard_rank(work: str, layers: int, device=None) -> None:
    """One process of phase "reshard" (``python -c``): node 0 or 1 of the
    first world (``DLROVER_TPU_NODE_RANK``), or the joiner
    (``RESHARD_JOINER=1``). Steps the fsdp trainer under an
    ElasticTrainer against the phase's master, saves every step durably
    on both tiers, and carries the master's transition orders out in
    process (``ElasticTrainer.execute_reshard``); one JSON line a step
    (``STEP``) on stdout and ``node<n>.json`` at the end."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.agent.master_client import build_master_client
    from dlrover_tpu_torch.checkpoint.peer import PeerRegistry
    from dlrover_tpu_torch.common.constants import NodeEnv
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa
    from dlrover_tpu_torch.reshard.migrate import migrate_live
    from dlrover_tpu_torch.telemetry.http import (
        MetricsServer, set_shard_provider)
    from dlrover_tpu_torch.trainer import distributed as coll
    from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer
    from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
    from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler

    node = int(os.environ[NodeEnv.NODE_RANK])
    joiner = os.environ.get("RESHARD_JOINER") == "1"
    with open(os.path.join(work, "plan.json")) as f:
        plan = json.load(f)
    cuda = device != "cpu"
    if not cuda:
        torch.set_num_threads(1)
    if not joiner:
        coll.init_from_env(timeout_s=120, backend="gloo", device=device)
    elif cuda:
        torch.cuda.set_device(0)
    client = build_master_client()
    server = MetricsServer(port=0).start()
    url = f"http://127.0.0.1:{server.port}"
    cfg = _reshard_cfg(layers, device, plan.get("tiny"))
    tokens = np.load(os.path.join(work, "tokens.npy"))
    store_dir = os.path.join(work, "store")
    ckpt_kwargs = dict(ram_dir=os.path.join(plan["ram"], f"ram{node}"),
                       persist_interval=1, max_ram_keep=2,
                       max_persist_keep=RESHARD_FINAL + 1,
                       commit_timeout=60.0)
    out = {"node": node, "pid": os.getpid(), "steps": [],
           "transitions": [], "device": None}

    def build():
        return _reshard_trainer(cfg, device)

    sampler = ElasticDistributedSampler(len(tokens), 1, 0, shuffle=False)

    def resize(size, index, data):
        if data:
            sampler.load_state_dict(json.loads(data))
        if plan.get("plant") == "no_resize" and not joiner:
            return  # planted: the survivor keeps the old world's stride
        sampler.set_world(size, index)

    if joiner:
        elastic = ElasticTrainer(None, max_nodes=2, cur_nodes=1,
                                 master_client=client)
        world = 0
        # the joiner warms up before it announces itself (as a spare
        # pre-builds its model): one throwaway step at world 1 loads the
        # kernels and the libraries' handles on its card
        warm = build()
        warm.train_step(warm.shard_batch(warm.microbatch(
            (tokens[:SLICE["b"], :-1], tokens[:SLICE["b"], 1:]))))
        del warm
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        print("READY", flush=True)
        while not client.kv_store_get(RESHARD_GO_KEY):
            time.sleep(0.05)
        out["running_ts"] = time.time()
    else:
        rank, world = dist.get_rank(), dist.get_world_size()
        elastic = ElasticTrainer(build(), max_nodes=2, cur_nodes=world,
                                 master_client=client)
        ckpt = FlashCheckpointer(
            store_dir, process_index=rank, n_processes=world,
            peer_registry=PeerRegistry(client, rank, url), **ckpt_kwargs)
        set_shard_provider(ckpt.shard_provider())
        elastic.attach_checkpointer(ckpt, 1)
        sampler.set_world(world, rank)
    client.update_node_status("running")
    stale = None

    def planted_sums(res):
        """The planted fault: a migration that serves a stale step's live
        boxes as the pinned step's. Its state goes nowhere; its sums are
        checked against the sound migration's, which they must fail."""
        reader = FlashCheckpointer(
            store_dir, ram_dir=os.path.join(work, "ram-plant"),
            process_index=res["index"], n_processes=res["world_size"])
        planted = build()
        bad, _, stats = migrate_live(
            reader, stale, step=res["step"], live_step=res["step"],
            target=_restore_target(planted, store_dir, res["step"]))
        reader.close()
        planted.load_train_state(bad)
        planted.set_accum_steps(elastic.trainer.accum_steps)
        sums = _box_sums({**planted.train_state(), "step": res["step"],
                          "data": ""})
        return sums, stats

    def transition(order, live_step):
        t0 = time.perf_counter()
        res = elastic.execute_reshard(
            order, build, store_dir, ckpt_kwargs, peer_url=url,
            live_step=live_step, resize=resize, backend="gloo",
            timeout_s=RESHARD_TIMEOUT_S, save_interval=1)
        if res is None:
            out["fallback"] = order.id
            with open(os.path.join(work, f"node{node}.json"), "w") as f:
                json.dump(out, f)
            print("FALLBACK", flush=True)
            sys.exit(RESHARD_FALLBACK_RC)
        t1 = time.perf_counter()
        res["adopt_to_completed_ms"] = (t1 - t0) * 1e3
        res["live_step"] = live_step
        res["sums"] = _box_sums({**elastic.trainer.train_state(),
                                 "step": res["step"], "data": ""})
        # the gate's sums delay the first step after the transition
        res["checks_s"] = time.perf_counter() - t1
        out["transitions"].append(res)
        print("TRANSITION " + json.dumps(
            {k: v for k, v in res.items() if not k.endswith("sums")}),
            flush=True)
        return res["step"], res["world_size"]

    if joiner:
        order = elastic.wait_reshard(RESHARD_TIMEOUT_S)
        if order is None:
            sys.exit(RESHARD_FALLBACK_RC)
        step, world = transition(order, None)
    else:
        step = 0
    while step < RESHARD_FINAL:
        order = elastic.pending_reshard()
        if order is None and world == 1 and (
                step == RESHARD_LOST + RESHARD_WORLD1_STEPS):
            # the survivor's world-1 steps are done: the planted migration
            # of the shrink runs here, off the timed path, then it waits
            # to be grown
            shrink = out["transitions"][-1]
            if stale is not None:
                shrink["planted_sums"], shrink["planted_stats"] = (
                    planted_sums(shrink))
                stale = None
            print("IDLE", flush=True)
            order = elastic.wait_reshard(RESHARD_TIMEOUT_S)
            if order is None:
                sys.exit(RESHARD_FALLBACK_RC)
        if order is not None:
            step, world = transition(order, step)
            continue
        t = elastic.trainer
        idx = next(sampler.iter_batches(RESHARD_GLOBAL_B // world))
        mb = t.shard_batch(elastic.microbatch(
            (tokens[idx, :-1], tokens[idx, 1:])))
        before = dict(fa.LAUNCHES)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            loss = elastic.train_step(mb).item()
        except Exception as e:  # noqa: BLE001 - a peer died mid-step
            # every collective of the step runs before its first
            # in-place write: the live state is still step's
            print(f"STEP FAILED {step + 1}: {e!r}"[:300], flush=True)
            out["failed_step"] = step + 1
            order = elastic.wait_reshard(RESHARD_TIMEOUT_S)
            if order is None:
                sys.exit(RESHARD_FALLBACK_RC)
            step, world = transition(order, step)
            continue
        if cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        t_end = time.time()
        step += 1
        launches = {k: fa.LAUNCHES[k] - before[k] for k in before}
        state = {**t.train_state(), "step": step,
                 "data": json.dumps(sampler.state_dict())}
        t1 = time.perf_counter()
        elastic.maybe_checkpoint(state, step=step, force=True, durable=True)
        if step == RESHARD_LOST or (
                world == 1 and step == RESHARD_LOST + RESHARD_WORLD1_STEPS):
            # the drill's durable points: the victim's last save (and its
            # peer's) committed before the injection kills it; the
            # survivor's saves committed before it idles. Elsewhere the
            # persist runs behind the next step
            elastic.checkpointer.wait()
        save_s = time.perf_counter() - t1
        if plan.get("stale") and step == RESHARD_STALE and node == 0:
            stale = _clone_state(state)
        parts = elastic.checkpointer.save_stats.get(step, {})
        rec = {"step": step, "loss": loss, "ms": ms, "save_s": save_s,
               "save_parts": {k: v for k, v in parts.items()
                              if isinstance(v, (int, float)) and k != "t0"},
               "world": world, "accum": t.accum_steps, "t_end": t_end,
               "bytes": t.state_bytes(),
               "owned_opt_bytes": _owned_bytes(
                   state, dist.get_rank() if dist.is_initialized() else 0),
               "rows": [int(i) for i in idx], "launches": launches}
        out["steps"].append(rec)
        out.setdefault("first_step_ts", time.time())
        out["device"] = str(t.local_shards()[0][2].device)
        print("STEP " + json.dumps(rec), flush=True)
        if step in (RESHARD_LOST + RESHARD_WORLD1_STEPS, RESHARD_FINAL):
            torch.save([(n, b, x.cpu()) for n, b, x in t.local_shards()],
                       os.path.join(work, f"params{node}_{step}.pt"))
        # the injector fires here, after the step's save is durable
        elastic.report_step(step, loss=loss)
    out["pid_end"] = os.getpid()
    # the last world-2 save restored bitwise at world 2: a fresh
    # checkpointer, its RAM tier empty and no peers, reads it from the
    # store once both ranks' saves are committed
    elastic.checkpointer.wait()
    dist.barrier()
    reader = FlashCheckpointer(
        store_dir, ram_dir=os.path.join(work, f"ram-final{node}"),
        process_index=dist.get_rank(), n_processes=dist.get_world_size())
    live = {**elastic.trainer.train_state(), "step": step, "data": ""}
    t0 = time.perf_counter()
    got, at = reader.restore(target=live, step=step)
    reader.close()
    out["final_restore"] = {
        "step": at, "tier": reader.last_restore_stats["tier"],
        "seconds": time.perf_counter() - t0,
        "bitwise": _box_sums({**got, "step": step, "data": ""})
        == _box_sums(live)}
    del got, live
    elastic.checkpointer.close()
    with open(os.path.join(work, f"node{node}.json"), "w") as f:
        json.dump(out, f)
    server.stop()
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def _reshard_reference(work, cfg, device, pinned: int, accum: int,
                       steps: int, boxes=(), numpy: bool = False) -> dict:
    """The one-process fsdp step (world 1) from a fresh
    ``restore(step=pinned)`` of the phase's store at the dtypes it saved,
    at ``accum`` microbatches: its state right after the
    restore (box sums, its own and cut to each of ``boxes``, other
    ranks' ``{path: [box]}``, and with ``numpy`` the state as numpy),
    then ``steps`` steps on the
    global rows its own sampler draws from the restored data position:
    the losses, the rows and the parameters before and after."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer
    from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler

    tokens = np.load(os.path.join(work, "tokens.npy"))
    t = _reshard_trainer(cfg, device)
    store_dir = os.path.join(work, "store")
    reader = FlashCheckpointer(
        store_dir, ram_dir=os.path.join(work, f"ram-ref{pinned}"),
        process_index=0, n_processes=1)
    got, at = reader.restore(
        target=_restore_target(t, store_dir, pinned), step=pinned)
    reader.close()
    t.load_train_state(got)
    t.set_accum_steps(accum)
    sampler = ElasticDistributedSampler(len(tokens), 1, 0, shuffle=False)
    sampler.load_state_dict(json.loads(got["data"]))
    del got
    state = {**t.train_state(), "step": at, "data": ""}
    out = {"step": at, "sums": _box_sums(state),
           "sums_for": [_box_sums(state, b) for b in boxes],
           "numpy": _numpy_state(state) if numpy else None,
           "init": {n: p.detach().clone() for n, _, p in t.local_shards()},
           "losses": [], "rows": []}
    for _ in range(steps):
        idx = next(sampler.iter_batches(RESHARD_GLOBAL_B))
        mb = t.shard_batch(t.microbatch((tokens[idx, :-1],
                                         tokens[idx, 1:])))
        out["losses"].append(t.train_step(mb).item())
        out["rows"].append([int(i) for i in idx])
    out["final"] = {n: p.detach().clone() for n, _, p in t.local_shards()}
    return out


class _Shards:
    """Saved ``(name, box, tensor)`` shards, as ``_against_reference``
    reads a trainer's, on ``device`` (the card, where it compares them)."""

    def __init__(self, path, device=None):
        import torch

        self._shards = torch.load(path, map_location=device or "cuda")

    def local_shards(self):
        return self._shards


def run_reshard(layers: int = RESHARD_LAYERS, device=None,
                plant=None, tiny: bool = False) -> dict:
    """Phase "reshard"'s body. This process is the master: a servicer
    built with a ``TransitionCoordinator``, and the distributed master's
    part played here (ROADMAP queue A.2.2): the world sealed after the
    first steps, ``note_node_lost`` on a rank's exit, ``check_abort`` on
    its tick, the joiner started once the survivor idles. Then the
    gates, against fresh one-process restores of the pinned steps and
    the one-process step from them. ``plant="no_resize"`` makes the
    survivor skip its sampler's resize, which the gates must fail; the
    stale-live migration is planted beside every shrink (its state must
    differ from the restored step's). ``device="cpu"`` runs llama_tiny
    on CPU ranks (the logic alone); ``tiny`` llama_tiny at head_dim 64
    on the card, at 256 tokens a row. Returns the readings, the failed
    gates, and for a parity test the pinned states (numpy), the
    reference's rows, each rank's record and its saved parameters."""
    import threading

    import numpy as np
    import torch

    from dlrover_tpu_torch import telemetry as T
    from dlrover_tpu_torch.master.elastic_training.kv_store_service import (
        KVStoreService)
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.master.servicer import create_master_service
    from dlrover_tpu_torch.reshard import TransitionCoordinator
    from dlrover_tpu_torch.telemetry import goodput, read_journal
    from dlrover_tpu_torch.telemetry.journal import EventJournal

    cuda = device != "cpu"
    cfg = _reshard_cfg(layers, device, tiny)
    s = RESHARD_S_CPU if not cuda else 256 if tiny else SLICE["s"]
    work = tempfile.mkdtemp(prefix="dlrover_reshard_")
    # the RAM tier on /dev/shm when it holds both ranks' two newest
    # saves (fp32 moments at world 1: 10 bytes a parameter), else beside
    # the store
    state_bytes = 10 * llama.param_count(cfg)
    shm_free = (shutil.disk_usage("/dev/shm").free
                if os.path.isdir("/dev/shm") else 0)
    ram = (tempfile.mkdtemp(prefix="dlrover_reshard_", dir="/dev/shm")
           if cuda and shm_free >= 3 * state_bytes else work)
    journal = os.path.join(work, "journal.jsonl")
    np.save(os.path.join(work, "tokens.npy"), reshard_tokens(cfg, s))
    with open(os.path.join(work, "plan.json"), "w") as f:
        json.dump({"plant": plant, "stale": True, "tiny": tiny,
                   "ram": ram}, f)
    kv = KVStoreService()
    coord = TransitionCoordinator(kv, max_transitions=4,
                                  abort_timeout=RESHARD_TIMEOUT_S)
    saved_journal = T.default_journal()
    T.set_default_journal(EventJournal(journal))
    server, _ = create_master_service(0, kv_store=kv,
                                      transition_coordinator=coord)
    server.start()
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("DLROVER_TPU_", "DLROVER_FAULT"))}
    base.update({
        "DLROVER_TPU_MASTER_ADDR": f"localhost:{server.port}",
        "DLROVER_TPU_JOURNAL": journal, "DLROVER_TPU_RESHARD": "1",
        "DLROVER_FAULT_INJECT": f"node_lost@{RESHARD_LOST}:host=1",
        "DLROVER_TPU_DIST_HEARTBEAT_TIMEOUT": str(RESHARD_HEARTBEAT_S),
        "DLROVER_TPU_LOG_LEVEL": "WARNING", "PYTHONUNBUFFERED": "1",
        "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"})
    if not cuda:
        base["OMP_NUM_THREADS"] = "1"
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"import chip_smoke; chip_smoke.reshard_rank({work!r}, "
            f"{layers}, {device!r})")
    procs, lines, marks = {}, {}, {}
    lock = threading.Lock()

    def spawn(node, **env):
        marks[f"spawn{node}"] = time.time()
        p = procs[node] = subprocess.Popen(
            [sys.executable, "-c", code], cwd=ROOT, env={
                **base, "DLROVER_TPU_NODE_RANK": str(node),
                "DLROVER_TPU_NODE_ID": str(node), **env},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)
        lines[node] = []

        def read():
            for line in p.stdout:
                with lock:
                    lines[node].append(line)
                    if line.startswith("STEP {"):
                        marks.setdefault(f"first{node}", time.time())
                        if node == 0 and json.loads(line[5:])["step"] == 2:
                            marks["seal"] = True
                    if node == 0 and line.startswith("IDLE"):
                        marks["idle"] = True
                    if line.startswith("READY"):
                        marks[f"ready{node}"] = time.time()

        threading.Thread(target=read, daemon=True).start()

    failed, readings = [], {}
    t_phase = time.time()
    try:
        port = _free_port()
        for r in range(2):
            spawn(r, DLROVER_TPU_COORDINATOR_ADDR=f"localhost:{port}",
                  DLROVER_TPU_PROCESS_ID=str(r),
                  DLROVER_TPU_NUM_PROCESSES="2")
        deadline = time.time() + 2 * RESHARD_TIMEOUT_S
        while time.time() < deadline:
            with lock:
                seal, idle = marks.get("seal"), marks.get("idle")
            if seal and not coord.sealed:
                coord.seal_world()
            if "lost" not in marks and procs[1].poll() is not None:
                # the distributed master's part: a worker's exit is a
                # loss the coordinator takes online
                marks["lost"] = time.time()
                coord.note_node_lost(
                    1, reason=f"exit {procs[1].returncode}")
            if coord.transitions_done and 2 not in procs:
                spawn(2, RESHARD_JOINER="1")  # a node comes up
            if idle and not kv.get(RESHARD_GO_KEY):
                kv.set(RESHARD_GO_KEY, b"1")
            coord.check_abort()
            if procs[0].poll() not in (None, 0) or (
                    procs[0].poll() is not None
                    and (2 not in procs or procs[2].poll() is not None)):
                break  # the survivor failed, or every rank is done
            time.sleep(0.05)
        readings["ranks_s"] = time.time() - t_phase
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait(timeout=30)
        rcs = {n: p.returncode for n, p in procs.items()}
        if rcs != {0: 0, 1: -signal.SIGKILL, 2: 0}:
            raise AssertionError(
                f"reshard: exits {rcs}; node 0: "
                + "".join(lines.get(0, []))[-3000:] + " node 2: "
                + "".join(lines.get(2, []))[-2000:] + " node 1: "
                + "".join(lines.get(1, []))[-1500:])
        results = {}
        for n in (0, 2):
            with open(os.path.join(work, f"node{n}.json")) as f:
                results[n] = json.load(f)
        t_ref = time.time()
        shrink, grow0 = results[0]["transitions"]
        grow2, = results[2]["transitions"]
        ref1 = _reshard_reference(work, cfg, device, shrink["step"], 2,
                                  RESHARD_WORLD1_STEPS, numpy=not cuda)
        ref2 = _reshard_reference(
            work, cfg, device, grow0["step"], 1, RESHARD_WORLD2_STEPS,
            boxes=[_sums_boxes(tr["sums"]) for tr in (grow0, grow2)],
            numpy=not cuda)
        grow_sums = dict(zip((0, 2), ref2["sums_for"]))
        shards = {"shrink": _Shards(os.path.join(
            work, f"params0_{RESHARD_LOST + RESHARD_WORLD1_STEPS}.pt"),
            device), **{f"grow node {n}": _Shards(os.path.join(
                work, f"params{n}_{RESHARD_FINAL}.pt"), device)
                for n in (0, 2)}}
        params = {what: _against_reference(
            sh, *((ref1["final"], ref1["init"], RESHARD_WORLD1_STEPS)
                  if what == "shrink" else
                  (ref2["final"], ref2["init"], RESHARD_WORLD2_STEPS)))
            for what, sh in shards.items()}
        for ref in (ref1, ref2):
            for key in ("init", "final"):
                ref.pop(key)
        readings["reference_s"] = time.time() - t_ref
        events = read_journal(journal) if os.path.exists(journal) else []
    finally:
        server.stop(grace=0.5)
        T.set_default_journal(saved_journal)
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=30)
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(ram, ignore_errors=True)
        if cuda:
            torch.cuda.empty_cache()

    steps1 = [json.loads(x[5:]) for x in lines[1] if x.startswith("STEP {")]
    by_step = {n: {r["step"]: r for r in res["steps"]}
               for n, res in results.items()}
    world1 = range(RESHARD_LOST + 1,
                   RESHARD_LOST + RESHARD_WORLD1_STEPS + 1)
    world2 = range(RESHARD_FINAL - RESHARD_WORLD2_STEPS + 1,
                   RESHARD_FINAL + 1)
    losses = {"shrink": [by_step[0][k]["loss"] for k in world1],
              "grow node 0": [by_step[0][k]["loss"] for k in world2],
              "grow node 2": [by_step[2][k]["loss"] for k in world2]}
    # the survivor's process went on, the loss was taken online
    if results[0]["pid"] != results[0].get("pid_end"):
        failed.append("the survivor's pid changed")
    if not any(f"INJECTED NODE LOST at step {RESHARD_LOST}" in x
               for x in lines[1]) or [r["step"] for r in steps1][-1:] != [
                   RESHARD_LOST]:
        failed.append(f"rank 1 not lost after step {RESHARD_LOST}: "
                      f"{[r['step'] for r in steps1]}")
    if coord.transitions_done != 2 or coord.active_order is not None:
        failed.append(f"transitions_done {coord.transitions_done}, "
                      f"active {coord.active_order}")
    kinds = [e["kind"] for e in events if e["kind"].startswith("reshard.")]
    if kinds.count("reshard.completed") != 2 or "reshard.aborted" in kinds:
        failed.append(f"journal: {kinds}")
    if (shrink["step"], grow0["step"], grow2["step"]) != (
            RESHARD_LOST, world1[-1], world1[-1]):
        failed.append(f"pinned steps {shrink['step']}, {grow0['step']}, "
                      f"{grow2['step']}")
    moves = {"shrink": shrink["stats"], "grow node 0": grow0["stats"],
             "grow node 2": grow2["stats"]}
    if not (moves["shrink"]["live"] > 0 and moves["shrink"]["store"] > 0):
        failed.append(f"shrink moves {moves['shrink']}")
    if moves["grow node 2"]["peer"] <= 0:
        failed.append(f"joiner moves {moves['grow node 2']}")
    if any(m["digest_mismatch"] for m in moves.values()):
        failed.append(f"digest mismatches {moves}")
    # "mesh"'s byte gates at every step of every rank; the moments turn
    # fp32 at world 1's two microbatches and stay so
    all_steps = results[0]["steps"] + results[2]["steps"] + steps1
    for r in all_steps:
        want = _state_bytes_expected(cfg, layers, r["world"],
                                     4 if r["step"] > RESHARD_LOST else 2)
        if r["bytes"] != want or r["owned_opt_bytes"] != want["optimizer"]:
            failed.append(f"step {r['step']} at world {r['world']}: bytes "
                          f"{r['bytes']}, owned optimizer bytes "
                          f"{r['owned_opt_bytes']}, want {want}")
    # the last world-2 save, restored at world 2 from the store
    for n, res in results.items():
        fin = res.get("final_restore") or {}
        if (fin.get("step"), fin.get("bitwise")) != (RESHARD_FINAL, True):
            failed.append(f"node {n}: the step-{RESHARD_FINAL} save "
                          f"restored at world 2 {fin}")
    # bitwise: each migrated state is what a fresh restore assembles
    for what, got, want in (("shrink", shrink["sums"], ref1["sums"]),
                            ("grow node 0", grow0["sums"], grow_sums[0]),
                            ("grow node 2", grow2["sums"], grow_sums[2])):
        if got != want:
            bad = [k for k in want if got.get(k) != want[k]]
            failed.append(f"{what}: the migrated state differs from "
                          f"restore(step=pinned) at {bad[:3]}")
    planted_caught = shrink.get("planted_sums") not in (None, ref1["sums"])
    if not planted_caught:
        failed.append("the planted stale-live migration passed the "
                      "bitwise gate")
    # the steps after each transition against the one-process step
    for what, want in (("shrink", ref1["losses"]),
                       ("grow node 0", ref2["losses"]),
                       ("grow node 2", ref2["losses"])):
        if any(abs(a - b) > MESH_LOSS_RTOL * abs(b)
               for a, b in zip(losses[what], want)):
            failed.append(f"{what}: losses {losses[what]} vs {want}")
    for what, check in params.items():
        steps = (RESHARD_WORLD1_STEPS if what == "shrink"
                 else RESHARD_WORLD2_STEPS)
        if check["param_within_2lr_share"] < MESH_WITHIN_SHARE:
            failed.append(f"{what}: {check['param_within_2lr_share']:.5%}"
                          " of parameters within 2 lr and one ulp")
        if check["param_diff_lr"]["per_step"] > 2.0 * steps:
            failed.append(f"{what}: parameters "
                          f"{check['param_diff_lr']['per_step']:.3g} lr "
                          "beyond one ulp a step")
    # the replay: a reshard window on the survivor, and no restart but
    # the victim's own (its injection opens one just before it dies)
    report = goodput.reconstruct(events)
    victim = str(procs[1].pid)
    survivor = [p for k, p in report["procs"].items()
                if k.endswith(f":{results[0]['pid']}")]
    reshard_s = sum(p["phases"].get("reshard", 0.0) for p in survivor)
    phases = [e for e in events if e["kind"] == "goodput.phase"
              and e.get("pid") == results[0]["pid"]]
    windows = [b["ts"] - a["ts"] for a, b in zip(phases, phases[1:])
               if a["data"].get("phase") == "reshard"]
    t_kill = next((e["ts"] for e in events
                   if e["kind"] == "fault.injected"), None)
    restart_s = {k: p["phases"].get("restart", 0.0)
                 for k, p in report["procs"].items()}
    if reshard_s <= 0 or len(survivor) != 1 or any(
            v > 0 for k, v in restart_s.items()
            if not k.endswith(f":{victim}")):
        failed.append(f"replay: reshard {reshard_s} s on the survivor "
                      f"({len(survivor)} found), restart {restart_s}")
    if cuda:
        for r in all_steps:
            if set(r["launches"].values()) != {layers * r["accum"]}:
                failed.append(f"step {r['step']}: launches "
                              f"{r['launches']}")
        for n, res in results.items():
            if res["device"] != "cuda:0":
                failed.append(f"node {n} on {res['device']}")
    readings.update({
        "adopt_to_completed_ms": {
            "shrink": shrink["adopt_to_completed_ms"],
            "grow node 0": grow0["adopt_to_completed_ms"],
            "grow node 2": grow2["adopt_to_completed_ms"]},
        "coordinator_s": [e["data"].get("duration_s") for e in events
                          if e["kind"] == "reshard.completed"],
        # the master's view: the loss noticed to the shrink completed
        "lost_to_shrunk_s": next(
            (e["ts"] - marks["lost"] for e in events
             if e["kind"] == "reshard.completed"), None),
        # the kill (journaled just before it) to the end of the survivor's
        # first world-1 step: "launch"'s recovery_s, crash to the first
        # step after the restore, read the same way
        "recovery_s": (by_step[0][RESHARD_LOST + 1]["t_end"] - t_kill
                       if t_kill is not None else None),
        # of which the gate's box sums after the shrink
        "checks_s": shrink["checks_s"],
        # the final world-2 save restored at world 2 (rank: step, tier,
        # bitwise, seconds)
        "final_restore": {n: res.get("final_restore")
                          for n, res in results.items()},
        # the survivor's reshard windows in the replay: each adoption to
        # its next phase (its first step after the migration)
        "survivor_reshard_windows_s": windows,
        "migration_s": {"shrink": shrink["seconds"],
                        "grow node 0": grow0["seconds"],
                        "grow node 2": grow2["seconds"]},
        "transition_parts_s": {"shrink": shrink["parts"],
                               "grow node 0": grow0["parts"],
                               "grow node 2": grow2["parts"]},
        "moves": moves, "planted_moves": shrink.get("planted_stats"),
        "planted_caught": planted_caught,
        # the joiner's start (spawn to ready: the process on the card),
        # and its RUNNING report to its first step; spawn to first step
        # less the wait for the survivor between them
        "joiner_spawn_to_ready_s": marks["ready2"] - marks["spawn2"],
        "joiner_running_to_first_step_s": (results[2]["first_step_ts"]
                                           - results[2]["running_ts"]),
        "joiner_spawn_to_first_step_s": (
            marks["ready2"] - marks["spawn2"] + results[2]["first_step_ts"]
            - results[2]["running_ts"]),
        "step_ms": [(r["step"], r["world"], r["ms"]) for r in all_steps],
        "save_s": [(r["step"], r["world"], r["save_s"])
                   for r in all_steps],
        "save_parts_node0": [(r["step"], r["save_parts"])
                             for r in results[0]["steps"]],
        "launches_per_step": [(r["step"], r["world"], r["launches"])
                              for r in all_steps],
        "failed_step": results[0].get("failed_step"),
        "losses": losses, "reference_losses": {
            "shrink": ref1["losses"], "grow": ref2["losses"]},
        "params": params,
        "replay": {"survivor_reshard_s": reshard_s,
                   "restart_s": sorted(restart_s.values()),
                   "faults": [f["cause"] for f in report["faults"]]},
        "launches": {k: sum(r["launches"][k] for r in all_steps)
                     for k in REPLACES},
    })
    return {"readings": readings, "failed": failed,
            "pinned": {"shrink": ref1, "grow": ref2}, "results": results,
            "shards": None if cuda else shards}


def phase_reshard() -> dict:
    """Reshard-in-place on the card (the docstring's phase 19): a lost and
    a joined rank as in-process fsdp transitions of the llama_1b step
    across two gloo ranks on ``cuda:0``."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    got = run_reshard(RESHARD_LAYERS)
    emit({"phase": "reshard", "model": "llama_1b", "layers": RESHARD_LAYERS,
          "strategy": "fsdp", "batch_per_dp_rank": SLICE["b"],
          "seq": SLICE["s"], "lost_at": RESHARD_LOST,
          "backend": "gloo", "phase_s": time.time() - t0,
          **got["readings"], "nvidia_smi": nvidia_smi_line()})
    if got["failed"]:
        raise AssertionError("reshard: " + "; ".join(got["failed"]))
    return got["readings"]


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
    seconds, t0 = {}, time.perf_counter()

    def timed(name, fn, *args):
        start = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = time.perf_counter() - start

    timed("env", phase_env)
    timed("build", phase_build)
    kernels = timed("kernels", phase_kernels)
    launches, trainer, mb = timed("slice", phase_slice)
    timed("data", phase_data, trainer, mb)
    del trainer, mb  # the card's memory goes back for the next phases
    timed("optim", phase_optim)
    timed("elastic", phase_elastic)
    timed("eval", phase_eval)
    gpt_launches = timed("families", phase_families)
    timed("launch", phase_launch)
    timed("drain", phase_drain)
    world = timed("world", phase_world)
    mesh = timed("mesh", phase_mesh)
    sequence = timed("sequence", phase_sequence)
    timed("moe", phase_moe)
    pipe = timed("pipeline", phase_pipeline)
    auto = timed("auto", phase_auto)
    reshard = timed("reshard", phase_reshard)
    # wall seconds per phase, from main's start (the interpreter's start
    # and torch's import before it are not counted)
    emit({"phase_seconds": seconds, "total_s": time.perf_counter() - t0})
    line = []

    def seq_launches(shape):
        return {k: sequence["launches"].get(_shape_key(k, shape), 0)
                for k in REPLACES}

    # each shape's launches: its main path's run (the count reset just
    # before it), the Llama step of "slice", the tp ranks of "mesh", the
    # GPT step of "families", and the ring and Ulysses runs of
    # "sequence" (both ranks), and the microbatch shape of "pipeline"
    # (both ranks, GPipe and interleaved)
    for shape, counts in (("llama_1b", launches),
                          ("llama_1b_tp", mesh["launches"]["tp"]),
                          ("gpt2_xl", gpt_launches),
                          ("ring_chunk", seq_launches(RING_CHUNK)),
                          ("ring_chunk_full", seq_launches(RING_FULL)),
                          ("ulysses", seq_launches(ULYSSES)),
                          ("pipeline_mb", pipe["launches"]),
                          ("gpt2_small_tp", auto["gpt_tp_launches"])):
        for name, r in kernels[shape].items():
            line.append({
                "name": name if shape == "llama_1b" else f"{name}@{shape}",
                "shape": shape, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": counts[name],
                "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            })
            if shape == "llama_1b":
                # the same shape's launches in phase "world" (two ranks,
                # 4 layers, both incarnations)
                line[-1]["world_launches"] = world["launches"][name]
            if shape.startswith("llama_1b"):
                # and in phase "mesh", over every rank of its strategies
                line[-1]["mesh_launches"] = mesh["launches"][
                    "tp" if shape.endswith("_tp") else "dense"][name]
            if shape == "llama_1b":
                # and by the winner of phase "auto"'s one-process search
                line[-1]["auto_launches"] = auto["launches"][name]
                # and in phase "reshard" (every rank, 4 layers)
                line[-1]["reshard_launches"] = reshard["launches"][name]
    emit({"kernels": line})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
