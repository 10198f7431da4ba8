"""ElasticDistributedSampler: resumable sharded sampling.

A copy of ``dlrover_tpu/trainer/sampler.py`` (parity reference:
dlrover/trainer/torch/elastic_sampler.py:25; state_dict at :101 stores
the completed sample offset so resume skips consumed samples even when
the world size changed).

Framework-neutral: yields integer indices (numpy, no torch); drive a
``torch.utils.data`` pipeline or numpy batching with it.
"""

import math
import random
from typing import Dict, Iterator, List, Optional

import numpy as np


class ElasticDistributedSampler:
    def __init__(
        self,
        dataset_size: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if rank >= num_replicas or rank < 0:
            raise ValueError(
                f"rank {rank} out of range for {num_replicas} replicas"
            )
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        #: samples already consumed in the current epoch (global count)
        self.completed_num = 0
        self._recompute_sizes()

    def _recompute_sizes(self):
        # padding advances completed_num past dataset_size at epoch
        # end; a set_world after that must see an EMPTY remainder, not
        # a negative one (negative num_samples breaks __len__ and the
        # drop_last slice)
        remaining = max(0, self.dataset_size - self.completed_num)
        if self.drop_last:
            self.num_samples = remaining // self.num_replicas
        else:
            self.num_samples = math.ceil(remaining / self.num_replicas)
        self.total_size = self.num_samples * self.num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.completed_num = 0
        self._recompute_sizes()

    def set_world(self, num_replicas: int, rank: int):
        """Resize mid-epoch (reshard transition): the remaining
        ``dataset_size - completed_num`` samples re-partition across
        the new world. Call between batches and build a FRESH iterator
        afterwards — a live iterator keeps the stride it was built
        with (see __iter__/iter_batches), so indices it already handed
        out stay counted under the old geometry."""
        if rank >= num_replicas or rank < 0:
            raise ValueError(
                f"rank {rank} out of range for {num_replicas} replicas"
            )
        self.num_replicas = num_replicas
        self.rank = rank
        self._recompute_sizes()

    def _epoch_indices(self) -> List[int]:
        indices = list(range(self.dataset_size))
        if self.shuffle:
            rng = random.Random(self.seed + self.epoch)
            rng.shuffle(indices)
        return indices

    def __iter__(self) -> Iterator[int]:
        # stride snapshot: these indices were partitioned under THIS
        # world size — a set_world during iteration must not advance
        # completed_num at the new stride for old-geometry indices
        stride = self.num_replicas
        for idx in self._rank_indices():
            # count global progress: each yielded index advances the global
            # consumed count by num_replicas (all replicas move in lockstep)
            self.completed_num += stride
            yield idx

    def _rank_indices(self) -> List[int]:
        # completed_num advances between calls (mid-epoch suspension,
        # set_world): size the padding from the CURRENT remainder, not
        # the one seen at construction/resize time
        self._recompute_sizes()
        indices = self._epoch_indices()[self.completed_num:]
        if not self.drop_last:
            # pad to a replica multiple, REPEATING the remainder when
            # it is shorter than the pad (a grow past the remaining
            # samples): a short pad would hand some ranks fewer
            # indices than others and stall the lockstep collective
            pad = self.total_size - len(indices)
            if pad > 0 and indices:
                reps = -(-pad // len(indices))  # ceil
                indices += (indices * reps)[:pad]
        else:
            indices = indices[: self.total_size]
        return indices[self.rank::self.num_replicas]

    def iter_batches(self, batch_size: int) -> Iterator[np.ndarray]:
        """Vectorized iteration: numpy index arrays of ``batch_size``
        (the last may be short), one bookkeeping update per batch
        instead of per sample. Progress accounting matches __iter__:
        each yielded INDEX advances the global consumed count by
        num_replicas, committed when the batch is handed out."""
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive: {batch_size}")
        stride = self.num_replicas  # snapshot; see __iter__
        indices = np.asarray(self._rank_indices(), dtype=np.int64)
        for off in range(0, indices.size, batch_size):
            batch = indices[off:off + batch_size]
            self.completed_num += batch.size * stride
            yield batch

    def __len__(self) -> int:
        return self.num_samples

    # -------------------------------------------------------- resume state

    def state_dict(self) -> Dict:
        """Checkpointable progress (parity: elastic_sampler.py:101)."""
        return {
            "epoch": self.epoch,
            "completed_num": min(self.completed_num, self.dataset_size),
        }

    def load_state_dict(self, state: Dict, num_replicas: Optional[int] = None,
                        rank: Optional[int] = None):
        """Restore, possibly into a different world size."""
        self.epoch = state.get("epoch", 0)
        self.completed_num = state.get("completed_num", 0)
        if num_replicas is not None:
            self.num_replicas = num_replicas
        if rank is not None:
            self.rank = rank
        if self.rank >= self.num_replicas or self.rank < 0:
            # same guard as set_world: a stale rank silently yields a
            # partition overlapping a live rank's (double consumption)
            raise ValueError(
                f"rank {self.rank} out of range for "
                f"{self.num_replicas} replicas"
            )
        self._recompute_sizes()
