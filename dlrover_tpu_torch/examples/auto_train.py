"""auto_accelerate end to end: search the strategy space, train with the
winner, save it for the next (possibly resized) run.

    python -m dlrover_tpu_torch.examples.auto_train --steps 20 \
        --dryrun-top-k 2                       # on the GPU
    python -m dlrover_tpu_torch.examples.auto_train --device cpu \
        --steps 10 --dryrun-top-k 2 --save-strategy /tmp/strategy.json
    python -m dlrover_tpu_torch.examples.auto_train --device cpu \
        --load-strategy /tmp/strategy.json

Counterpart of ``examples/auto_train.py``, with its flags: llama_tiny,
``adamw(1e-3)``, a seeded token batch. Under a process group (the
launcher's ``--nproc_per_node``, or ``DLROVER_TPU_*`` in the
environment) every rank runs the same search over the world's ranks and
trains the same winner on its part of the batch. Prints ``strategy:
...``, ``step k: loss=...`` every 5 steps and ``FINAL loss=...``.
"""

import argparse
import sys

import numpy as np

from dlrover_tpu_torch.auto.accelerate import auto_accelerate
from dlrover_tpu_torch.auto.strategy import save_strategy
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.trainer.distributed import init_from_env
from dlrover_tpu_torch.trainer.sharded import adamw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--dryrun-top-k", type=int, default=0)
    ap.add_argument("--bo-iters", type=int, default=0)
    ap.add_argument("--save-strategy", type=str, default="")
    ap.add_argument("--load-strategy", type=str, default="")
    ap.add_argument("--device", type=str, default=None,
                    help="default: the GPU")
    args = ap.parse_args(argv)

    env = init_from_env(device=args.device)
    cfg = llama.llama_tiny()
    result = auto_accelerate(
        cfg, global_batch=args.global_batch, seq_len=args.seq_len,
        device=args.device, dryrun_top_k=args.dryrun_top_k,
        bo_iters=args.bo_iters,
        load_strategy_path=args.load_strategy or None,
        optimizer=adamw(1e-3),
    )
    print(f"strategy: {result.strategy}", flush=True)
    if args.save_strategy and env.rank == 0:
        save_strategy(result.strategy, args.save_strategy)
        print(f"saved -> {args.save_strategy}")

    trainer = result.trainer
    trainer.init(seed=0)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.global_batch, args.seq_len))
    batch = trainer.shard_batch(trainer.microbatch(
        trainer.split_batch((tokens, tokens))))
    loss = None
    for step in range(1, args.steps + 1):
        loss = trainer.train_step(batch)
        if step % 5 == 0:
            print(f"step {step}: loss={loss.item():.4f}", flush=True)
    final = loss.item() if loss is not None else float("nan")
    print(f"FINAL loss={final:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
