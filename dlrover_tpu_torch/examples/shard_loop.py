"""The elastic loop of the CNN and DLRM examples.

Counterpart of the loop that ``examples/cnn_train.py`` and
``examples/dlrm_train.py`` share: the master's shards of an in-memory
dataset through a ShardingClient (shuffled, one minibatch per shard), a
tail shard padded to the batch with zero features and label -1 (which
both families' losses mask out), an ElasticTrainer step over the
family's ShardedTrainer, and a durable FlashCheckpointer save every
``SAVE_INTERVAL`` steps and at the last one. The checkpoint holds the
model, the optimizer and the step, not the data position, as in the JAX
examples: a restart takes the master's next shards. Each step prints
``step k loss x``; a restore prints ``RESTORED from step k``. Under the
launcher the ElasticTrainer arms the hang detector, the drills' fault
injector and the preemption drain, whose emergency save takes this
loop's step and state.
"""

import os
from typing import Sequence, Tuple

import numpy as np

from dlrover_tpu_torch.agent.master_client import build_master_client
from dlrover_tpu_torch.agent.sharding.client import ShardingClient
from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer

#: steps between durable saves (the JAX examples' 10)
SAVE_INTERVAL = 10


def pad_batch(arrays: Sequence[np.ndarray], batch_size: int):
    """A shard's arrays padded to ``batch_size`` rows: zeros for the
    features, -1 for the labels (the last array)."""
    pad = batch_size - len(arrays[-1])
    if pad <= 0:
        return tuple(arrays)
    *features, labels = arrays
    return (*(np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
              for x in features),
            np.pad(labels, (0, pad), constant_values=-1))


def run(trainer, arrays: Sequence[np.ndarray], dataset_name: str,
        steps: int, batch_size: int, ckpt_dir: str
        ) -> Tuple[int, int, float]:
    """Train ``trainer`` (not yet initialized) to ``steps`` on the rows of
    ``arrays`` (features..., labels), resuming from ``ckpt_dir`` when it
    holds a checkpoint. Returns (start step, final step, last loss)."""
    client = build_master_client()
    trainer.init(seed=0)
    elastic = ElasticTrainer(trainer, max_nodes=1, cur_nodes=1,
                             master_client=client, report_interval=5)
    ckpt = FlashCheckpointer(
        persist_dir=os.path.join(ckpt_dir, "persist"),
        ram_dir=os.path.join(ckpt_dir, "ram"), persist_interval=0,
    )

    def state(at: int):
        return {**trainer.train_state(), "step": at}

    restored, _ = ckpt.restore(target=state(0))
    start_step = 0
    if restored is not None:
        trainer.load_train_state(restored)
        start_step = int(restored["step"])
        print(f"RESTORED from step {start_step}", flush=True)
    elastic.attach_checkpointer(ckpt, save_interval=SAVE_INTERVAL)
    sharding = ShardingClient(
        dataset_name, batch_size, num_epochs=10**6,
        dataset_size=len(arrays[-1]), shuffle=True,
        num_minibatches_per_shard=1, master_client=client,
    )
    step, loss = start_step, float("nan")
    elastic.drain.set_state_provider(lambda: (step, lambda: state(step)))
    try:
        while step < steps:
            shard = sharding.fetch_shard()
            if shard is None:
                break
            idx = (shard.record_indices if shard.record_indices
                   else np.arange(shard.start, shard.end))
            batch = trainer.shard_batch(elastic.microbatch(
                pad_batch([x[idx] for x in arrays], batch_size)))
            loss = elastic.report_step(step + 1,
                                       loss=elastic.train_step(batch))
            step += 1
            sharding.report_batch_done()
            print(f"step {step} loss {loss!r}", flush=True)
            # durable: a crash drill hard-kills shortly after a cadence
            # step -- the archive must already be on the RAM tier
            elastic.maybe_checkpoint(lambda: state(step),
                                     force=step == steps, durable=True)
    finally:
        sharding.stop()
        elastic.drain.disarm()
        # flush the async save pipeline before exit
        ckpt.close()
    return start_step, step, loss


def finish(step: int, loss: float, acc: float, start_step: int,
           out: str) -> None:
    """The examples' last line, ``FINAL step=... loss=... acc=...``, and
    the ``--out`` file's ``step,loss,acc,start_step``."""
    print(f"FINAL step={step} loss={loss:.6f} acc={acc:.3f}", flush=True)
    if out:
        with open(out, "w") as f:
            f.write(f"{step},{loss:.6f},{acc:.3f},{start_step}")
