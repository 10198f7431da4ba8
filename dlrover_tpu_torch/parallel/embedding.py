"""The stacked embedding table's lookup, on one device.

Counterpart of ``dlrover_tpu/parallel/embedding.py``. All categorical
features share ONE table ``[total_vocab, dim]`` with per-feature row
offsets (the DLRM layout). The JAX package gathers a row-sharded table
under ``shard_map`` (masked local gather, then a psum over the shard
axis); with no mesh, or a shard axis of size 1, it is the plain gather
``table[ids]``, and that is what the port runs. Its gradient is dense,
as JAX's is: a scatter-add of the looked-up rows' gradients into a
zero table.
"""

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def vocab_parallel_lookup(table: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: [batch, features] int global row ids -> [batch,
    features, dim], on one device. The table's rows sharded over several
    devices are ROADMAP.md queue A item 6; ShardedTrainer refuses
    "rowwise" across more than one device until then."""
    return F.embedding(ids, table)


def feature_offsets(vocab_sizes: Sequence[int], device=None) -> torch.Tensor:
    """Per-feature starting row in the stacked table, int32."""
    return torch.as_tensor(
        np.concatenate([[0], np.cumsum(vocab_sizes[:-1])]),
        dtype=torch.int32, device=device)


def stack_ids(per_feature_ids: torch.Tensor,
              offsets: torch.Tensor) -> torch.Tensor:
    """[batch, features] per-feature indices -> global stacked-table
    row ids. Callers clip ids into each feature's own vocabulary first
    (models/dlrm.py does): an unclipped id lands in a neighbouring
    feature's rows, not out of the table."""
    return per_feature_ids + offsets[None, :]
