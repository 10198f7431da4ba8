"""Dataset splitters: turn a dataset into shards.

Parity reference: dlrover/python/master/shard/dataset_splitter.py:144,257,359
(TableDatasetSplitter, TextDatasetSplitter, StreamingDatasetSplitter, factory
new_dataset_splitter:325). Shards here are index ranges consumed by JAX data
pipelines (grain / tf.data / numpy loaders) — the splitter itself is
device-agnostic pure logic.
"""

import random
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger

_MAX_SHARD_COUNT = 50000


@dataclass
class Shard:
    """A unit of data the master hands to a worker.

    name: dataset name (or stream partition); [start, end): record range;
    record_indices: explicit sample indices when shuffling at sample level.
    """

    name: str
    start: int
    end: int
    record_indices: Optional[List[int]] = None


@dataclass
class PartitionOffsets:
    """Kafka-style stream partition offsets (parity: dataset_splitter.py:80)."""

    partition_offsets: dict = field(default_factory=dict)

    @property
    def partitions(self):
        return list(self.partition_offsets.keys())


class DatasetSplitter(ABC):
    """Base splitter over ``dataset_size`` records with epochs."""

    def __init__(self, dataset_name: str, dataset_size: int, shard_size: int,
                 num_epochs: int):
        self.dataset_name = dataset_name
        self.dataset_size = dataset_size
        self.shard_size = max(1, shard_size)
        self._num_epochs = num_epochs
        self._epoch = 0

    @abstractmethod
    def create_shards(self) -> bool:
        """Create shards for the next epoch; False if no epochs remain."""

    @abstractmethod
    def get_shards(self) -> List[Shard]:
        ...

    def epoch_finished(self) -> bool:
        return self._epoch >= self._num_epochs

    @property
    def epoch(self) -> int:
        return self._epoch

    def get_epoch(self) -> int:
        return self._epoch

    def set_epoch(self, epoch: int):
        self._epoch = epoch


class TableDatasetSplitter(DatasetSplitter):
    """Row-range shards over a table (parity: dataset_splitter.py:144).

    Handles very large datasets by lazily materialising at most
    ``max_shard_count`` shards per call; the remainder is generated on the
    next ``create_shards`` within the same epoch.
    """

    def __init__(self, dataset_name: str, dataset_size: int, shard_size: int,
                 num_epochs: int = 1, max_shard_count: int = _MAX_SHARD_COUNT):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self._max_shard_count = max_shard_count
        self._shards: List[Shard] = []
        self._split_start = 0

    def epoch_finished(self) -> bool:
        # a lazily-materialised epoch is not finished while mid-epoch
        # (_split_start > 0): without this, the dataset manager would stop
        # refilling and silently drop the tail of the final epoch
        return super().epoch_finished() and self._split_start == 0

    def get_shards(self) -> List[Shard]:
        return self._shards

    def create_shards(self) -> bool:
        shard_count = (
            self.dataset_size + self.shard_size - 1
        ) // self.shard_size
        if shard_count <= self._max_shard_count:
            if self.epoch_finished():
                self._shards = []
                return False
            self._epoch += 1
            self._shards = self._create_shards_in_range(0, self.dataset_size)
        else:
            if self._split_start == 0:
                if self.epoch_finished():
                    self._shards = []
                    return False
                self._epoch += 1
            end = min(
                self._split_start + self._max_shard_count * self.shard_size,
                self.dataset_size,
            )
            self._shards = self._create_shards_in_range(
                self._split_start, end
            )
            self._split_start = 0 if end >= self.dataset_size else end
        logger.info(
            "Created %d shards for dataset %s epoch %d",
            len(self._shards), self.dataset_name, self._epoch,
        )
        return True

    def _create_shards_in_range(self, start: int, end: int) -> List[Shard]:
        shards = []
        for s in range(start, end, self.shard_size):
            shards.append(
                Shard(
                    name=self.dataset_name,
                    start=s,
                    end=min(s + self.shard_size, end),
                )
            )
        return shards


class TextDatasetSplitter(DatasetSplitter):
    """Index-list shards with optional sample-level shuffle
    (parity: dataset_splitter.py:257)."""

    def __init__(self, dataset_name: str, dataset_size: int, shard_size: int,
                 num_epochs: int = 1, shuffle: bool = False, seed: int = 0):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self._shuffle = shuffle
        self._seed = seed
        self._shards: List[Shard] = []

    def get_shards(self) -> List[Shard]:
        return self._shards

    def create_shards(self) -> bool:
        if self.epoch_finished():
            self._shards = []
            return False
        self._epoch += 1
        indices = list(range(self.dataset_size))
        if self._shuffle:
            rng = random.Random(self._seed + self._epoch)
            rng.shuffle(indices)
        shards = []
        for s in range(0, self.dataset_size, self.shard_size):
            chunk = indices[s:s + self.shard_size]
            shards.append(
                Shard(
                    name=self.dataset_name,
                    start=s,
                    end=s + len(chunk),
                    record_indices=chunk,
                )
            )
        self._shards = shards
        return True


class StreamingDatasetSplitter(DatasetSplitter):
    """Partition-offset shards for unbounded streams
    (parity: dataset_splitter.py:359).

    ``dataset_size`` < 0 means unbounded; each ``create_shards`` advances
    every partition offset by ``fetch_data_size``.
    """

    def __init__(self, dataset_name: str, shard_size: int,
                 partition_offsets: PartitionOffsets,
                 dataset_size: int = -1, fetch_data_size: int = 10000,
                 num_epochs: int = 1):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self._partition_offsets = partition_offsets
        self._fetch_data_size = fetch_data_size
        self._shards: List[Shard] = []

    def get_shards(self) -> List[Shard]:
        return self._shards

    def epoch_finished(self) -> bool:
        return self.dataset_size == 0

    def create_shards(self) -> bool:
        if self.epoch_finished():
            self._shards = []
            return False
        shards = []
        fetch = self._fetch_data_size
        if self.dataset_size > 0:
            fetch = min(fetch, self.dataset_size)
        for partition, offset in self._partition_offsets.partition_offsets.items():
            for s in range(offset, offset + fetch, self.shard_size):
                end = min(s + self.shard_size, offset + fetch)
                shards.append(Shard(name=str(partition), start=s, end=end))
            self._partition_offsets.partition_offsets[partition] = (
                offset + fetch
            )
        if self.dataset_size > 0:
            self.dataset_size -= fetch
        self._shards = shards
        return True

    def get_checkpoint_offsets(self) -> dict:
        return dict(self._partition_offsets.partition_offsets)


def new_dataset_splitter(
    shuffle: bool,
    shard_size: int,
    dataset_size: int,
    num_epochs: int,
    dataset_name: str,
    storage_type: str = "table",
    partition_offsets: Optional[PartitionOffsets] = None,
) -> DatasetSplitter:
    """Factory (parity: dataset_splitter.py:325)."""
    if storage_type in ("table", ""):
        if shuffle:
            return TextDatasetSplitter(
                dataset_name, dataset_size, shard_size, num_epochs,
                shuffle=True,
            )
        return TableDatasetSplitter(
            dataset_name, dataset_size, shard_size, num_epochs
        )
    if storage_type == "text":
        return TextDatasetSplitter(
            dataset_name, dataset_size, shard_size, num_epochs, shuffle
        )
    if storage_type == "stream":
        return StreamingDatasetSplitter(
            dataset_name, shard_size,
            partition_offsets or PartitionOffsets({0: 0}),
            dataset_size=dataset_size, num_epochs=num_epochs,
        )
    raise ValueError(f"unknown storage_type {storage_type}")
