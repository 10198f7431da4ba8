"""Elastic recommender training: the CRITEO Wide&Deep workload.

    python -m dlrover_tpu_torch.examples.dlrm_train --steps 60 \
        --ckpt-dir /tmp/dlrm_ckpt                # on the GPU
    python -m dlrover_tpu_torch.trainer.elastic_run --standalone \
        --nnodes 1:1 --nproc_per_node 2 \
        dlrover_tpu_torch/examples/dlrm_train.py -- \
        --steps 60 --ckpt-dir /tmp/dlrm_ckpt --device cpu

Counterpart of ``examples/dlrm_train.py``: ``criteo_wide_deep`` (the
stacked 734,208-row table of width 8 and the wide table) under
``adagrad(0.05)`` and the "rowwise" strategy on the JAX default mesh
``[(data, 1), (fsdp, world)]``: above one rank each rank holds its block
of the tables' rows and every rank steps the same batch
(``shard_loop.SameBatch``). It is fed a procedural click stream with
planted per-id effects (made from a seed: learnable, not separable)
through the master's shards, in the loop of ``shard_loop.py``. Ids
arrive as int32.
Prints ``RESTORED from step k`` after a restore and ``FINAL step=N
loss=... acc=...`` (the training accuracy on the first 512 rows);
``--out`` gets ``step,loss,acc,start_step``.
"""

import argparse
import sys

import numpy as np
import torch

from dlrover_tpu_torch.examples import shard_loop
from dlrover_tpu_torch.models import dlrm
from dlrover_tpu_torch.trainer.distributed import init_from_env


def make_clicks(n, cfg, seed=0, hot_per_feature=50):
    """Procedural CTR data (the JAX example's, bit for bit): each feature
    has a few hot ids with planted logit effects, plus dense-feature
    effects -- a learnable logistic ground truth over the table rows the
    run touches. (dense fp32, cat_ids int32, labels int32)."""
    rng = np.random.RandomState(seed)
    dense = rng.randn(n, cfg.dense_dim).astype(np.float32)
    hot = [min(s, hot_per_feature) for s in cfg.vocab_sizes]
    cat = np.stack(
        [rng.randint(0, h, n) for h in hot], axis=1
    ).astype(np.int32)
    logit = np.zeros(n, np.float32)
    for j, h in enumerate(hot):
        w = rng.randn(h).astype(np.float32) * 0.8
        logit += w[cat[:, j]]
    logit += dense[:, 0] * 0.5 - dense[:, 1] * 0.5
    prob = 1.0 / (1.0 + np.exp(-logit))
    labels = (rng.rand(n) < prob).astype(np.int32)
    return dense, cat, labels


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--ckpt-dir", type=str, default="/tmp/dlrm_ckpt")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the GPU")
    parser.add_argument("--out", type=str, default="")
    args = parser.parse_args(argv)

    init_from_env(device=args.device)
    cfg = dlrm.criteo_wide_deep()
    dense, cat, labels = make_clicks(4096, cfg)
    trainer = dlrm.make_trainer(cfg, device=args.device)
    start_step, step, loss = shard_loop.run(
        trainer, (dense, cat, labels), "clicks", args.steps,
        args.batch_size, args.ckpt_dir)
    with torch.no_grad():
        logits = trainer.model(*(torch.from_numpy(x[:512]).to(
            trainer.device) for x in (dense, cat)), mesh=trainer.mesh)
    acc = ((logits > 0).cpu().numpy() == labels[:512]).mean()
    shard_loop.finish(step, loss, float(acc), start_step, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
