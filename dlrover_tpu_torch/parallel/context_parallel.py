"""Long-context sequence parallelism: ring and Ulysses attention.

Counterpart of ``dlrover_tpu/parallel/context_parallel.py``. Under the
"sequence" strategy each rank of the mesh's ``seq`` axis holds one
chunk of the sequence -- rank i of the seq group the positions ``i x
s_loc`` on (:class:`SeqShard`, the one place those positions come from:
the model's RoPE tables and the ring's mask both read it).

* :func:`ring_attention` -- K/V chunks rotate around the seq group
  (un-broadcast, kvh-sized); each step runs the flash kernels of
  ``ops/cuda/flash_attention.py`` on the local queries against the
  visiting chunk and folds the (o, lse) pair into running accumulators
  (``RingFlashAttentionFn``: one autograd Function per call, which
  fixes every rank's collectives in one order). A chunk after all of
  the rank's queries is skipped: no launch.
* :func:`ulysses_attention` -- ``all_to_all`` re-shards seq -> heads,
  the port's ``flash_attention`` runs on the whole sequence for h/sp
  heads, and a second ``all_to_all`` re-shards back.

Both are ``attn_fn`` for ``models/llama.py``. Where JAX's shard_map maps
the batch axes too, each rank here already holds its own rows.
"""

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from dlrover_tpu_torch.ops.attention import flash_attention, mha_reference
from dlrover_tpu_torch.ops.cuda.flash_attention import ring_flash_attention
from dlrover_tpu_torch.parallel.mesh import (
    SEQ_AXIS, Mesh, axes_group, axis_index, axis_size,
)
from dlrover_tpu_torch.trainer.distributed import all_to_all


@dataclass(frozen=True)
class SeqShard:
    """This rank's chunk of a sequence split over a seq group: its
    ``index`` among ``size`` equal chunks, and the ``group`` (None for
    one rank)."""

    group: object
    index: int
    size: int

    def chunk_start(self, index: int, s_loc: int) -> int:
        """The first position of chunk ``index`` of ``s_loc`` positions."""
        return index * s_loc

    def start(self, s_loc: int) -> int:
        """The first position of this rank's chunk."""
        return self.chunk_start(self.index, s_loc)


def seq_shard(mesh: Mesh, axis_name: str = SEQ_AXIS) -> SeqShard:
    """This rank's :class:`SeqShard` over the mesh axis ``axis_name``."""
    return SeqShard(axes_group(mesh, (axis_name,)),
                    axis_index(mesh, axis_name), axis_size(mesh, axis_name))


def ring_attention(
    q: torch.Tensor,  # [batch, seq/sp, heads, head_dim] (this rank's chunk)
    k: torch.Tensor,  # [batch, seq/sp, kv_heads, head_dim]
    v: torch.Tensor,
    mesh: Mesh,
    causal: bool = True,
    scale: Optional[float] = None,
    axis_name: str = SEQ_AXIS,
) -> torch.Tensor:
    """Ring attention over the mesh's sequence axis. At one rank it is
    ``mha_reference`` on the CPU, as JAX's is, and the flash kernels on
    the card (no plain attention on a CUDA tensor)."""
    shard = seq_shard(mesh, axis_name)
    if shard.size == 1:
        if q.is_cuda:
            return flash_attention(q, k, v, causal=causal, scale=scale)
        return mha_reference(q, k, v, causal=causal, scale=scale)
    h, kvh = q.shape[2], k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"heads {h} not a multiple of kv_heads {kvh}")
    s_loc = q.shape[1]
    # at ring step r this rank holds the chunk that started at rank me - r
    k_starts = [shard.chunk_start((shard.index - r) % shard.size, s_loc)
                for r in range(shard.size)]
    return ring_flash_attention(q, k, v, shard.group, shard.start(s_loc),
                                k_starts, causal=causal, scale=scale)


def ulysses_attention(
    q: torch.Tensor,  # [batch, seq/sp, heads, head_dim] (this rank's chunk)
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    causal: bool = True,
    scale: Optional[float] = None,
    axis_name: str = SEQ_AXIS,
    attn_impl: Optional[Callable] = None,
) -> torch.Tensor:
    """Ulysses (all-to-all head-scatter) attention over the seq axis."""
    sp = axis_size(mesh, axis_name)
    attn_impl = attn_impl or (
        lambda q, k, v, causal, scale: flash_attention(
            q, k, v, causal=causal, scale=scale))
    if sp == 1:
        return attn_impl(q, k, v, causal, scale)
    h, kvh = q.shape[2], k.shape[2]
    if h % sp:
        raise ValueError(f"heads {h} must divide by seq-parallel size {sp}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"heads {h} not a multiple of kv_heads {kvh}")
    if kvh != h and kvh % sp:
        # the all-to-all splits the head dim; KV heads are repeated only
        # when they cannot be split sp ways themselves
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    group = axes_group(mesh, (axis_name,))
    # [b, s/sp, h, d] -> [b, s, h/sp, d]
    q, k, v = (all_to_all(x, 2, 1, group) for x in (q, k, v))
    o = attn_impl(q, k, v, causal, scale)
    # back: [b, s, h/sp, d] -> [b, s/sp, h, d]
    return all_to_all(o, 1, 2, group)


def make_context_parallel_attn(mesh: Mesh, kind: str = "ring",
                               axis_name: str = SEQ_AXIS) -> Callable:
    """An ``attn_fn`` for ``models/llama.py``."""
    if kind == "ring":
        return lambda q, k, v: ring_attention(
            q, k, v, mesh, causal=True, axis_name=axis_name)
    if kind == "ulysses":
        return lambda q, k, v: ulysses_attention(
            q, k, v, mesh, causal=True, axis_name=axis_name)
    raise ValueError(f"unknown context-parallel kind {kind!r}")
