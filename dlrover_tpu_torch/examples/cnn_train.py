"""Elastic CNN classification: the MNIST-CNN workload.

    python -m dlrover_tpu_torch.examples.cnn_train --steps 60 \
        --ckpt-dir /tmp/cnn_ckpt                 # on the GPU
    python -m dlrover_tpu_torch.trainer.elastic_run --standalone \
        --nnodes 1:1 dlrover_tpu_torch/examples/cnn_train.py -- \
        --steps 60 --ckpt-dir /tmp/cnn_ckpt --device cpu

Counterpart of ``examples/cnn_train.py``: ``mnist_cnn`` under
``adam(1e-3)``, fed the procedural digits (class-dependent 28 x 28
patterns plus noise, made from a seed: no download) through the
master's shards, in the loop of ``shard_loop.py``. Prints ``RESTORED
from step k`` after a restore and ``FINAL step=N loss=... acc=...`` (the
training accuracy on the first 256 digits); ``--out`` gets
``step,loss,acc,start_step``.
"""

import argparse
import sys

import numpy as np
import torch

from dlrover_tpu_torch.examples import shard_loop
from dlrover_tpu_torch.models import cnn
from dlrover_tpu_torch.trainer.distributed import init_from_env
from dlrover_tpu_torch.trainer.sharded import adam


def make_digits(n=2048, size=28, num_classes=10, seed=0):
    """Class-dependent stripe/blob patterns plus noise, NHWC fp32 images
    and int32 labels (the JAX example's, bit for bit)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n).astype(np.int32)
    xs = rng.randn(n, size, size, 1).astype(np.float32) * 0.3
    yy, xx = np.mgrid[0:size, 0:size]
    for cls in range(num_classes):
        mask = labels == cls
        pattern = (
            np.sin(xx * (cls + 1) * np.pi / size)
            + np.cos(yy * (cls + 2) * np.pi / size)
        ).astype(np.float32)[None, :, :, None]
        xs[mask] += pattern
    return xs, labels


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--ckpt-dir", type=str, default="/tmp/cnn_ckpt")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the GPU")
    parser.add_argument("--out", type=str, default="")
    args = parser.parse_args(argv)

    init_from_env(device=args.device)
    cfg = cnn.mnist_cnn()
    images, labels = make_digits()
    trainer = cnn.make_trainer(cfg, device=args.device,
                               optimizer=adam(1e-3))
    start_step, step, loss = shard_loop.run(
        trainer, (images, labels), "digits", args.steps, args.batch_size,
        args.ckpt_dir)
    with torch.no_grad():
        logits = trainer.model(torch.from_numpy(images[:256]).to(
            trainer.device))
    acc = (logits.argmax(-1).cpu().numpy() == labels[:256]).mean()
    shard_loop.finish(step, loss, float(acc), start_step, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
