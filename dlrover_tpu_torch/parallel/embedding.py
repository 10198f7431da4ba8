"""The stacked embedding table's lookup, whole or row-sharded.

Counterpart of ``dlrover_tpu/parallel/embedding.py``. All categorical
features share ONE table ``[total_vocab, dim]`` with per-feature row
offsets (the DLRM layout). With no mesh, or a shard axis of size 1, the
lookup is the plain gather ``table[ids]``; its gradient is dense, as
JAX's is: a scatter-add of the looked-up rows' gradients into a zero
table.

Above that the table's rows are sharded over the shard axis (the
"rowwise" strategy, ``trainer/sharded.py``), and ``table`` is this
rank's block of consecutive rows, the block ``parallel/sharding.py``'s
``local_slices`` gives it. The lookup is the JAX ``shard_map`` body as
a ``torch.autograd.Function``: each rank gathers the rows it owns (ids
outside its block give zero rows) and an all-reduce sum over the shard
axis's group assembles the embedding, which every rank of the group
then holds. The backward is the identity for the sum (every rank holds
the same upstream gradient) and then the masked gather's transpose: a
scatter-add into the rank's own rows only. The table's gradient never
crosses ranks.
"""

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dlrover_tpu_torch.parallel.mesh import (
    FSDP_AXIS, axes_group, axis_index, axis_names, axis_size,
)
from dlrover_tpu_torch.trainer import distributed as coll


class _VocabParallelLookup(torch.autograd.Function):
    """The masked local gather and its sum over ``group``."""

    @staticmethod
    def forward(ctx, table, ids, lo, group):
        rows = table.shape[0]
        local = ids.long() - lo
        mask = (local >= 0) & (local < rows)
        local = local.clamp(0, rows - 1)
        emb = F.embedding(local, table) * mask[..., None].to(table.dtype)
        ctx.save_for_backward(local, mask)
        ctx.rows = rows
        return coll.all_reduce_(emb, group)

    @staticmethod
    def backward(ctx, grad):
        local, mask = ctx.saved_tensors
        g = grad * mask[..., None].to(grad.dtype)
        table_grad = g.new_zeros((ctx.rows, g.shape[-1]))
        table_grad.index_add_(0, local.reshape(-1),
                              g.reshape(-1, g.shape[-1]))
        return table_grad, None, None, None


def vocab_parallel_lookup(table: torch.Tensor, ids: torch.Tensor,
                          mesh=None, shard_axis: str = FSDP_AXIS,
                          batch_axes: Tuple[str, ...] = ("data",)
                          ) -> torch.Tensor:
    """``table[ids]``: [batch, features] int global row ids -> [batch,
    features, dim]. With ``mesh`` and its ``shard_axis`` above size 1,
    ``table`` is this rank's block of rows and every rank of the shard
    axis must look up the same ``ids``: ``batch_axes``, the axes the
    batch is split over, must not hold ``shard_axis`` (a ``ValueError``,
    as in JAX)."""
    if (mesh is None or shard_axis not in axis_names(mesh)
            or axis_size(mesh, shard_axis) <= 1):
        return F.embedding(ids, table)
    if shard_axis in batch_axes:
        raise ValueError(
            f"batch axes {batch_axes} must not include the table shard "
            f"axis {shard_axis!r} (the vocab-parallel psum would mix "
            "different batch shards)")
    lo = axis_index(mesh, shard_axis) * table.shape[0]
    return _VocabParallelLookup.apply(
        table, ids, lo, axes_group(mesh, (shard_axis,)))


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
