"""Elastic shm data path: master-sharded coworker producers -> ring ->
device prefetch, feeding the trainer.

Counterpart of ``dlrover_tpu/data/elastic_shm.py``. Each coworker
PROCESS owns a ShardingClient over its own master client and pulls
disjoint sample-range shards from the master's TaskManager (a dead
coworker's unacked shards are recycled to the others), materializes
batches with a user ``batch_fn`` and pushes them into the C++ ring.
The trainer pops ready batches, and ``DevicePrefetch`` stages them on
the GPU on a copy stream. ``device`` takes the place of JAX's
``sharding``.

A producer acks a shard once it has pushed its batch, so the batches in
the ring and in the prefetch queue count as done at the master before
any step has trained on them: the master's ledger, not a checkpoint,
holds the data position of this feed, and a crash skips what was in
flight (ROADMAP.md, section C).

This module and what ``_ShardedProducer`` imports load without torch.
"""

import os
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.data.shm_dataloader import DevicePrefetch, ShmDataLoader


@dataclass
class _ShardedProducer:
    """Picklable zero-arg callable run inside each coworker process:
    fetch shards from the master, yield ``batch_fn(start, end)``."""

    batch_fn: Callable[[int, int], Any]
    dataset_name: str
    batch_size: int
    dataset_size: int
    num_epochs: int
    shuffle: bool
    num_minibatches_per_shard: int
    master_addr: Optional[str]
    fetch_batch: Optional[int] = None
    lookahead: Optional[int] = None

    def __call__(self) -> Iterable[Any]:
        # built here (not in the trainer) so every producer has its own
        # connection; the master hands out disjoint shards
        from dlrover_tpu_torch.agent.master_client import build_master_client
        from dlrover_tpu_torch.agent.sharding.client import ShardingClient

        client = build_master_client(self.master_addr)
        sharding = ShardingClient(
            dataset_name=self.dataset_name,
            batch_size=self.batch_size,
            num_epochs=self.num_epochs,
            dataset_size=self.dataset_size,
            shuffle=self.shuffle,
            num_minibatches_per_shard=self.num_minibatches_per_shard,
            master_client=client,
            fetch_batch=self.fetch_batch,
            lookahead=self.lookahead,
        )
        while True:
            shard = sharding.fetch_shard()
            if shard is None:
                return
            yield self.batch_fn(shard.start, shard.end)
            sharding.report_batch_done()


class ElasticShmDataLoader:
    """Master-coordinated elastic data loading over the shm ring.

    Args:
      batch_fn: ``batch_fn(start, end) -> batch pytree`` materializing
        the samples of one shard (read from disk / tokenize / augment) --
        runs in the coworker processes; its class must live in a module
        that imports no torch.
      dataset_name/batch_size/dataset_size/num_epochs: registered with
        the master's dataset manager (shards of ``batch_size`` samples).
      num_workers: coworker producer processes.
      master_addr: the master's ``host:port``; None reads the address
        the agent exports (``DLROVER_TPU_MASTER_ADDR``). The producers
        are other processes, so an in-process master cannot serve them.
      device: where DevicePrefetch stages the batches; None is the GPU
        (it raises without one), ``"cpu"`` for the tests.
      transform (optional): per-batch reshape (e.g. the trainer's
        microbatch split) run on the prefetch thread, off the train
        loop.
      fetch_batch/lookahead (optional): per-producer shard dispatch
        batching and lookahead window (see ShardingClient; None reads
        DLROVER_TPU_SHARD_FETCH_BATCH / DLROVER_TPU_SHARD_LOOKAHEAD).
    """

    def __init__(
        self,
        batch_fn: Callable[[int, int], Any],
        dataset_name: str,
        batch_size: int,
        dataset_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
        num_workers: int = 2,
        num_minibatches_per_shard: int = 1,
        master_addr: Optional[str] = None,
        slot_bytes: int = 64 << 20,
        num_slots: int = 8,
        prefetch_depth: int = 2,
        device=None,
        transform: Optional[Callable[[Any], Any]] = None,
        fetch_batch: Optional[int] = None,
        lookahead: Optional[int] = None,
    ):
        from dlrover_tpu_torch.common.constants import NodeEnv

        master_addr = (master_addr
                       or os.environ.get(NodeEnv.MASTER_ADDR, "")
                       or None)
        if master_addr is None:
            raise ValueError(
                "ElasticShmDataLoader needs the master's address: its "
                "producers are processes of their own")
        producer = _ShardedProducer(
            batch_fn=batch_fn,
            dataset_name=dataset_name,
            batch_size=batch_size,
            dataset_size=dataset_size,
            num_epochs=num_epochs,
            shuffle=shuffle,
            num_minibatches_per_shard=num_minibatches_per_shard,
            master_addr=master_addr,
            fetch_batch=fetch_batch,
            lookahead=lookahead,
        )
        self._loader = ShmDataLoader(
            producer,
            num_workers=num_workers,
            slot_bytes=slot_bytes,
            num_slots=num_slots,
            pre_sharded=True,  # disjointness comes from the master
        )
        try:
            self._prefetch = DevicePrefetch(
                self._loader, depth=prefetch_depth, device=device,
                transform=transform,
            )
        except BaseException:
            self._loader.shutdown()
            raise
        logger.info(
            "ElasticShmDataLoader: %d coworkers, dataset=%s size=%d "
            "batch=%d", num_workers, dataset_name, dataset_size,
            batch_size,
        )

    @property
    def producer_pids(self) -> List[int]:
        return self._loader.pids

    @property
    def ring_name(self) -> str:
        return self._loader.ring_name

    @property
    def started_at(self) -> float:
        """When the producers were started (``time.perf_counter``)."""
        return self._loader.started_at

    def __iter__(self) -> Iterator[Any]:
        return iter(self._prefetch)

    def shutdown(self):
        # order matters: EOF the ring so the prefetch thread's pop()
        # returns, JOIN it, and only then unmap/destroy the ring -- the
        # thread shares this process's mapping and unmapping under a
        # live pop() is a SIGSEGV. Idempotent; if the fill thread won't
        # die in time, leak the segment rather than crash.
        if getattr(self, "_shut", False):
            return
        self._shut = True
        self._loader.close()
        joined = self._prefetch.join()
        if not joined:
            logger.error(
                "prefetch thread still alive at shutdown; leaking the "
                "shm ring instead of unmapping under it"
            )
        self._loader.shutdown(destroy=joined)
