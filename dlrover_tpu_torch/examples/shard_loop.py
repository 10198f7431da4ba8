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

Above one rank the ranks that share a data-parallel index step the same
rows (under "rowwise" every rank of an fsdp group): the lowest of them
fetches the master's shard and the others take its indices
(:class:`SameBatch`); each rank saves its own shards of the state, and
a restart restores them.
"""

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

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


class SameBatch:
    """The master's shards for the ranks of a process group: the lowest
    rank of each data-parallel index fetches, and one all-gather over the
    host's gloo group (``trainer/distributed.py``) hands its indices to
    the ranks of the same index. At one rank, and where every rank has
    an index of its own, each rank fetches its own."""

    def __init__(self, trainer, make_client):
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        index, self.fetcher = trainer.data_parallel_index(), 0
        self.shared = False
        if self.world > 1:
            from dlrover_tpu_torch.trainer.distributed import host_group

            self.group = host_group()
            mine = torch.tensor([index], dtype=torch.int64)
            got = [torch.zeros_like(mine) for _ in range(self.world)]
            dist.all_gather(got, mine, group=self.group)
            indices = [int(t) for t in got]
            self.fetcher = indices.index(index)
            self.shared = len(set(indices)) < self.world
        me = dist.get_rank() if self.world > 1 else 0
        self.client = (make_client() if not self.shared or me == self.fetcher
                       else None)

    def fetch(self, batch_size: int) -> Optional[np.ndarray]:
        """The next shard's record indices (None: no more shards)."""
        idx = None
        if self.client is not None:
            shard = self.client.fetch_shard()
            if shard is not None:
                idx = np.asarray(shard.record_indices if shard.record_indices
                                 else np.arange(shard.start, shard.end))
        if not self.shared:
            return idx
        row = torch.full((batch_size + 1,), -1, dtype=torch.int64)
        if idx is not None:
            row[0] = len(idx)
            row[1:1 + len(idx)] = torch.from_numpy(idx.astype(np.int64))
        rows = [torch.empty_like(row) for _ in range(self.world)]
        dist.all_gather(rows, row, group=self.group)
        n = int(rows[self.fetcher][0])
        return None if n < 0 else rows[self.fetcher][1:1 + n].numpy()

    def done(self) -> None:
        if self.client is not None:
            self.client.report_batch_done()

    def stop(self) -> None:
        if self.client is not None:
            self.client.stop()


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
    sharding = SameBatch(trainer, lambda: ShardingClient(
        dataset_name, batch_size, num_epochs=10**6,
        dataset_size=len(arrays[-1]), shuffle=True,
        num_minibatches_per_shard=1, master_client=client,
    ))
    step, loss = start_step, float("nan")
    elastic.drain.set_state_provider(lambda: (step, lambda: state(step)))
    try:
        while step < steps:
            idx = sharding.fetch(batch_size)
            if idx is None:
                break
            batch = trainer.shard_batch(elastic.microbatch(
                pad_batch([x[idx] for x in arrays], batch_size)))
            loss = elastic.report_step(step + 1,
                                       loss=elastic.train_step(batch))
            step += 1
            sharding.done()
            # one write, newline included: the ranks share the
            # launcher's stdout, and an unbuffered one (PYTHONUNBUFFERED)
            # would take print's newline as a write of its own, letting
            # another rank's line in between
            print(f"step {step} loss {loss!r}\n", end="", flush=True)
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
