"""Megatron tensor parallelism over a mesh's ``tensor`` axis.

What XLA derives from the JAX ``tp`` rule table (``parallel/sharding.py``)
is written out here as autograd functions over the collective layer of
``trainer/distributed.py``:

* :func:`copy_to_tensor` -- identity forward, the gradient all-reduced
  over the tensor group (before a column-parallel matmul, whose input
  every tensor rank holds whole);
* :func:`reduce_from_tensor` -- the partial sums of a row-parallel
  matmul all-reduced forward, identity backward;
* :func:`vocab_parallel_embedding` -- each rank looks up the rows of its
  vocab range and the ranks' partial rows are summed;
* :func:`vocab_parallel_nll` -- cross entropy over vocab-sharded logits:
  the row max and the sum of exponentials are all-reduced over the
  group, the target's logit comes from the rank that owns its column,
  and the backward (written by hand) recomputes each chunk's logits from
  its hidden states, so the full ``[tokens, vocab]`` logits are never
  gathered and no chunk's logits outlive it.
"""

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dlrover_tpu_torch.trainer.distributed import all_reduce_


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``group``."""
    return x if group is None else _CopyToTensor.apply(x, group)


def reduce_from_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``; its gradient as it is."""
    return x if group is None else _ReduceFromTensor.apply(x, group)


def vocab_parallel_embedding(tokens: torch.Tensor, table: torch.Tensor,
                             vocab_start: int, group) -> torch.Tensor:
    """Rows of the vocab-sharded ``table`` (rows ``vocab_start`` on) for
    the int ``tokens``: a rank contributes the rows it owns and zeros
    elsewhere, and the ranks' contributions are summed."""
    if group is None:
        return F.embedding(tokens, table)
    n = table.shape[0]
    local = tokens - vocab_start
    own = (local >= 0) & (local < n)
    rows = F.embedding(local.clamp(0, n - 1), table)
    return reduce_from_tensor(rows * own.unsqueeze(-1).to(rows.dtype),
                              group)


class _VocabParallelNLL(torch.autograd.Function):
    """(summed masked nll, count) of one chunk of hidden states ``x``
    [n, h] against the vocab shard ``w`` [vocab/T, h] of the lm_head;
    ``x``'s gradient is this rank's partial sum (summed over the group
    by :func:`copy_to_tensor` upstream)."""

    @staticmethod
    def forward(ctx, x, w, targets, vocab_start, group):
        logits = F.linear(x, w).float()
        n_local = logits.shape[-1]
        row_max = logits.max(dim=-1).values
        all_reduce_(row_max, group, dist.ReduceOp.MAX)
        sum_exp = (logits - row_max[:, None]).exp().sum(dim=-1)
        all_reduce_(sum_exp, group)
        lse = row_max + sum_exp.log()
        local = targets - vocab_start
        own = (local >= 0) & (local < n_local)
        picked = logits.gather(1, local.clamp(0, n_local - 1)[:, None])
        target_logit = picked[:, 0] * own.float()
        all_reduce_(target_logit, group)
        mask = (targets >= 0).float()
        ctx.save_for_backward(x, w, lse, local, own, mask)
        cnt = mask.sum()
        ctx.mark_non_differentiable(cnt)
        return ((lse - target_logit) * mask).sum(), cnt

    @staticmethod
    def backward(ctx, grad_sum, grad_cnt):
        x, w, lse, local, own, mask = ctx.saved_tensors
        logits = F.linear(x, w).float()
        probs = (logits - lse[:, None]).exp()
        rows = own.nonzero().squeeze(-1)
        probs[rows, local[rows]] -= 1.0
        grad = (probs * (mask * grad_sum)[:, None]).to(x.dtype)
        return grad @ w, grad.t() @ x, None, None, None


def vocab_parallel_nll(x: torch.Tensor, w: torch.Tensor,
                       targets: torch.Tensor, vocab_start: int, group,
                       chunk: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed masked next-token nll, count of targets >= 0) of hidden
    states ``x`` [..., h] against the lm_head's vocab shard ``w``
    [vocab/T, h] (rows ``vocab_start`` on), ``chunk`` tokens at a time
    (0: all at once)."""
    h = x.shape[-1]
    xf = copy_to_tensor(x.reshape(-1, h), group)
    tf = targets.reshape(-1)
    chunk = chunk if chunk > 0 else max(1, xf.shape[0])
    total = x.new_zeros((), dtype=torch.float32)
    cnt = x.new_zeros((), dtype=torch.float32)
    for xs, ts in zip(xf.split(chunk), tf.split(chunk)):
        s, c = _VocabParallelNLL.apply(xs, w, ts, vocab_start, group)
        total = total + s
        cnt = cnt + c
    return total, cnt
