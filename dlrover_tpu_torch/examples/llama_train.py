"""Elastic training workload: Llama fed by the master's data shards.

    python -m dlrover_tpu_torch.examples.llama_train --steps 50 \
        --ckpt-dir /tmp/llama_ckpt              # on the GPU
    python -m dlrover_tpu_torch.examples.llama_train --steps 50 \
        --ckpt-dir /tmp/llama_ckpt --device cpu
    python -m dlrover_tpu_torch.trainer.elastic_run --standalone \
        --nnodes 1:1 dlrover_tpu_torch/examples/llama_train.py -- \
        --model llama_1b --batch-size 3 --seq-len 2048 --steps 12 \
        --save-interval 4 --ckpt-dir /tmp/llama_ckpt

Counterpart of ``examples/llama_train.py``: master dataset sharding ->
ShardingClient -> ElasticTrainer driving the ShardedTrainer step ->
FlashCheckpointer, and on a restart the restore of model, optimizer and
data position. The one difference: batches come from a ShardingClient
in this process, since the shm data plane (``ElasticShmDataLoader``) is
not ported yet (ROADMAP.md, queue A). Each shard's tokens are made from
its sample index, as the JAX example's ``synth_batch`` makes them, so
every shard is reproducible. Under the launcher the master client is
the RPC one (``build_master_client`` reads the master address the agent
exports), and the ElasticTrainer arms the hang detector, the fault
injector of the drills, the sentinel and the preemption drain. The drain
gets this loop's step and state: a SIGTERM (``preempt@k:notice=N``)
lands an emergency save of the step it ended inside the notice window
and the worker exits 21. A rollback order from the master (the sentinel
tripped on ``nan@k`` or ``sdc@k``) restores the ordered step, rewinds the
shard ledger to it and prints ``ROLLBACK to step k``; training goes on
in the same process. ``--model`` picks llama_tiny (the default) or
llama_1b at full width with ``bench.py``'s optimizer. Prints ``step k
loss x`` per step (the loss's full repr), ``RESTORED from step k`` after
a restore and ``FINAL step=N loss=...`` at the end, as the JAX example
does; ``--out`` gets ``step,loss,start_step``. The journal gets
``train.model_ready`` (the model on its device) and ``train.step`` per
step (with the flash kernels' launches so far), the marks a recovery's
timeline is read from.

The checkpointed state is ``{"model": {name: parameter}, "optimizer":
{"mu": ..., "nu": ..., "count": ...}, "step": N, "data": <the shard
checkpoint JSON>}``.
"""

import argparse
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dlrover_tpu_torch.agent.master_client import build_master_client
from dlrover_tpu_torch.agent.sharding.client import ShardingClient
from dlrover_tpu_torch.common.constants import NodeStatus
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.ops.cuda import flash_attention
from dlrover_tpu_torch.telemetry import record
from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer
from dlrover_tpu_torch.trainer.distributed import init_from_env
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from dlrover_tpu_torch.trainer.sharded import adamw, make_trainer_for_llama

DATASET = "llama-train"


def model_config(name: str):
    """``--model``: the config and the AdamW learning rate. llama_tiny is
    cut to the flash kernels' head_dim of 64, so that it runs on the card
    too (``seq_len`` a multiple of 128 there); llama_1b is ``bench.py``'s
    default model with its AdamW(1e-4, 0.9, 0.95)."""
    if name == "tiny":
        return llama.llama_tiny(hidden_size=128, num_heads=2,
                                num_kv_heads=1), adamw(1e-3)
    if name == "llama_1b":
        return (llama.llama_1b(remat="dots_attn_out"),
                adamw(1e-4, b1=0.9, b2=0.95))
    raise ValueError(f"unknown model {name!r}")


def synth_batch(start: int, end: int, seq_len: int = 128,
                vocab: int = 256):
    """One shard's batch. A real job reads and tokenizes a corpus slice
    here; the synthetic stream is seeded by the sample index so every
    shard is reproducible (the JAX example's ``synth_batch``)."""
    rng = np.random.default_rng(start)
    tokens = rng.integers(
        0, vocab, (end - start, seq_len), dtype=np.int32
    ).astype(np.int64)
    return tokens, tokens


def checkpoint_state(trainer, step: int, sharding: ShardingClient) -> Dict:
    return {**trainer.train_state(), "step": step,
            "data": sharding.get_shard_checkpoint()}


def rollback(order, trainer, sharding, ckpt, client, sentinel) -> int:
    """Restore the master-ordered last clean step, as the JAX loop
    does: the model and optimizer from its archive, the shard ledger
    rewound to its ``"data"`` so the voided steps see their shards
    again. Returns the restored step."""
    rolled, _ = ckpt.restore(
        target={**trainer.train_state(), "step": 0, "data": ""},
        step=order["step"])
    if rolled is None:
        raise RuntimeError(f"rollback step {order['step']} not found")
    trainer.load_train_state(rolled)
    if rolled["data"] and not sharding.restore_shard_from_checkpoint(
            rolled["data"]):
        raise RuntimeError("the master refused the shard checkpoint")
    step = int(rolled["step"])
    sentinel.note_restored(step, order["id"])
    # the RUNNING re-report closes the rollback window on the master
    update = getattr(client, "update_node_status", None)
    if update is not None:
        update(NodeStatus.RUNNING)
    print(f"ROLLBACK to step {step}", flush=True)
    return step


def run(steps: int, ckpt_dir: str, batch_size: int = 8, seq_len: int = 128,
        device: Optional[str] = None, save_interval: int = 10,
        seed: int = 0, model: str = "tiny") -> Dict:
    """Train to ``steps``, resuming from ``ckpt_dir`` when it holds a
    checkpoint. Returns what happened: the start step, each step's
    (start, end) shard and loss, and the final step."""
    cfg, optimizer = model_config(model)
    client = build_master_client()
    trainer = make_trainer_for_llama(cfg, device=device,
                                     optimizer=optimizer)
    trainer.init(seed=seed)
    # the parameters' device carries its index (cuda:0)
    on = next(trainer.model.parameters()).device
    if on.type == "cuda":
        torch.cuda.synchronize(on)
    record("train.model_ready", model=model, device=str(on))
    print(f"DEVICE {on}", flush=True)
    elastic = ElasticTrainer(trainer, max_nodes=1, cur_nodes=1,
                             master_client=client, report_interval=5)
    sharding = ShardingClient(
        DATASET, batch_size, num_epochs=10**6,  # stream until --steps
        dataset_size=steps * batch_size, shuffle=False,
        num_minibatches_per_shard=1, master_client=client,
    )
    ckpt = FlashCheckpointer(
        persist_dir=os.path.join(ckpt_dir, "persist"),
        ram_dir=os.path.join(ckpt_dir, "ram"), persist_interval=0,
    )
    restored, _ = ckpt.restore(
        target={**trainer.train_state(), "step": 0, "data": ""})
    start_step = 0
    if restored is not None:
        trainer.load_train_state(restored)
        start_step = int(restored["step"])
        if restored["data"] and not sharding.restore_shard_from_checkpoint(
                restored["data"]):
            raise RuntimeError("the master refused the shard checkpoint")
        print(f"RESTORED from step {start_step}", flush=True)
    elastic.attach_checkpointer(ckpt, save_interval=save_interval)
    # page-lock the staging block while the first steps run
    ckpt.prepare(checkpoint_state(trainer, start_step, sharding))

    # the flash kernels launched from here on (none on the CPU)
    launched_before = dict(flash_attention.LAUNCHES)
    step, loss = start_step, float("nan")
    # the emergency save of a preemption: ``step`` is the last step
    # whose update and shard report are done (the drain runs between
    # steps, or at a step's end), and the state is built when it runs
    elastic.drain.set_state_provider(lambda: (
        step, lambda: checkpoint_state(trainer, step, sharding)))
    sentinel = elastic.sentinel
    shards: List = []
    losses: List[float] = []
    try:
        while step < steps:
            shard = sharding.fetch_shard()
            if shard is None:
                break
            batch = trainer.shard_batch(elastic.microbatch(
                synth_batch(shard.start, shard.end, seq_len,
                            cfg.vocab_size)))
            loss = elastic.report_step(step + 1,
                                       loss=elastic.train_step(batch))
            step += 1
            sharding.report_batch_done()
            shards.append((shard.start, shard.end))
            losses.append(loss)
            record("train.step", step=step, loss=loss, launches={
                k: n - launched_before[k]
                for k, n in flash_attention.LAUNCHES.items()})
            print(f"step {step} loss {loss!r}", flush=True)
            order = (sentinel.pending_rollback()
                     if sentinel is not None else None)
            if order is not None:
                # the poisoned steps never reach a save; a notice during
                # the restore drains at the next step's dispatch
                step = rollback(order, trainer, sharding, ckpt, client,
                                sentinel)
                continue
            # durable: a crash drill hard-kills shortly after a cadence
            # step -- the archive must already be on the RAM tier
            elastic.maybe_checkpoint(
                lambda: checkpoint_state(trainer, step, sharding),
                durable=True)
    finally:
        sharding.stop()
        elastic.drain.disarm()
        # flush the async save pipeline before exit
        ckpt.close()
    return {"start_step": start_step, "step": step, "loss": loss,
            "shards": shards, "losses": losses}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", choices=("tiny", "llama_1b"),
                        default="tiny")
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--save-interval", type=int, default=10)
    parser.add_argument("--ckpt-dir", type=str, default="/tmp/llama_ckpt")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the GPU")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=str, default="")
    args = parser.parse_args(argv)

    t0 = time.time()
    init_from_env(device=args.device)
    result = run(args.steps, args.ckpt_dir, batch_size=args.batch_size,
                 seq_len=args.seq_len, device=args.device,
                 save_interval=args.save_interval, seed=args.seed,
                 model=args.model)
    print(f"FINAL step={result['step']} loss={result['loss']:.6f}",
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(f"{result['step']},{result['loss']:.6f},"
                    f"{result['start_step']}")
    print(f"elapsed {time.time() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
