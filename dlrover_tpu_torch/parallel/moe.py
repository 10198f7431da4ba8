"""Mixture-of-Experts with expert parallelism.

Counterpart of ``dlrover_tpu/parallel/moe.py``: top-k gating with a
per-expert capacity (:func:`topk_gating`) and the MoE SwiGLU block
(:func:`moe_mlp`) -- the fp32 router, the router z-loss, the capacity
bucketed dispatch and combine einsums, the expert SwiGLU. Plain
PyTorch: the JAX package computes them outside any Pallas kernel.

Where the JAX program traces ``moe_mlp`` on the global batch and XLA
splits it over the mesh, a rank here holds its own tokens (its rows,
and under "sequence" its seq chunk) and, under a rule table that shards
the ``expert`` (or ``mlp``) dim, its own experts. :class:`ExpertShard`
says where it sits, and ``moe_mlp`` then:

* gathers the router logits (N x E, fp32) over the seq group, then the
  rows' group, into the global ``[batch, seq]`` order, and computes the
  gating on the whole -- capacity ``int(cf x N x k / E)`` over all N
  tokens, queue positions a cumsum in the global order -- so a split
  batch drops the tokens JAX drops; it keeps its tokens' slots of its
  experts;
* dispatches its own tokens into its experts' slots and runs its
  experts -- a slot holds one token, so the slots of other ranks'
  tokens stay empty here and nothing is summed over the ranks that hold
  them -- and sums the combined outputs over the expert group (the
  ranks that split the experts' work);
* sums the gradients that reach the combine weights and the dispatched
  x over the expert group before they reach the router (the
  ``copy_to_tensor`` of ``parallel/tensor_parallel.py``), so the router
  sees every expert's share once.

The auxiliary loss is the same on every rank; the trainer adds it so
that the ranks' losses sum to the JAX loss with it counted once.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dlrover_tpu_torch.parallel.tensor_parallel import (
    copy_to_tensor,
    reduce_from_tensor,
)
from dlrover_tpu_torch.trainer.distributed import all_gather, reduce_scatter

# loss coefficients owned HERE (callers add aux unscaled): Switch-style
# balance loss at 1e-2, router z-loss at 1e-3
BALANCE_LOSS_COEF = 1e-2
Z_LOSS_COEF = 1e-3


@dataclass(frozen=True)
class ExpertShard:
    """Where a rank's MoE layer sits on the mesh: its first expert
    ``expert_start``; ``expert_group``, the ranks that split the experts'
    work (the expert dim, or the mlp dim under tensor parallelism) and
    sum their outputs; ``seq_group`` and ``batch_group``, the ranks that
    hold the other seq chunks of its rows and the other rows. None: one
    rank."""

    expert_start: int = 0
    expert_group: object = None
    seq_group: object = None
    batch_group: object = None


def _route(logits: torch.Tensor, k: int, capacity: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dispatch [N, E, C] 0/1 fp32, weights [N, E] fp32, balance loss):
    ``topk_gating``'s combine is ``dispatch x weights`` (a token takes
    an expert in one round at most, so that product is the JAX sum of
    the rounds, bit for bit)."""
    n, e = logits.shape
    probs = torch.softmax(logits, dim=-1)

    # aux load-balance loss (Switch eq.4): E * sum_e f_e * p_e, using the
    # top-1 assignment fraction f_e and mean router prob p_e
    top1 = probs.argmax(dim=-1)
    f = F.one_hot(top1, e).float().mean(dim=0)
    p = probs.mean(dim=0)
    balance = e * (f * p).sum()

    dispatch = logits.new_zeros(n, e, capacity)
    weights = logits.new_zeros(n, e)
    # queue positions carry a running per-expert offset so later rounds
    # do not collide with slots filled by earlier rounds
    counts = logits.new_zeros(e)
    masked = probs
    for _ in range(k):
        choice = masked.argmax(dim=-1)  # [N]
        gate = masked.gather(1, choice[:, None])[:, 0]
        onehot = F.one_hot(choice, e).float()  # [N, E]
        # position of each token within its chosen expert's queue
        pos = ((onehot.cumsum(dim=0) - 1.0) + counts[None, :]) * onehot
        kept = onehot * ((pos < capacity) & (onehot > 0)).float()
        counts = counts + onehot.sum(dim=0)
        slot = F.one_hot(pos.to(torch.int32).clamp(0, capacity - 1).long(),
                         capacity).float()
        dispatch = dispatch + kept[..., None] * slot
        weights = weights + kept * gate[:, None]
        masked = masked * (1.0 - onehot)  # exclude the chosen expert
    if k > 1:
        # renormalize over the selected experts; k == 1 keeps the RAW gate
        # (Switch semantics: renormalizing would pin every weight to 1 and
        # zero the router's gradient through the LM loss)
        denom = weights.sum(dim=1, keepdim=True)
        weights = weights / torch.where(denom == 0.0, 1.0, denom)
    return dispatch, weights, balance


def topk_gating(logits: torch.Tensor, k: int, capacity: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing with per-expert capacity: (dispatch [N, E, C] 0/1
    fp32, combine [N, E, C] fp32, balance loss). Tokens over an expert's
    capacity are dropped (Switch/GShard)."""
    dispatch, weights, balance = _route(logits, k, capacity)
    return dispatch, dispatch * weights[..., None], balance


class _GatherTokens(torch.autograd.Function):
    """All-gather along ``dim`` over ``group``; the backward sums every
    rank's gradient and keeps this rank's part (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad.contiguous(), ctx.dim, ctx.group), None, \
            None


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _GatherTokens.apply(x, dim, group)


def _rank_in(group) -> int:
    import torch.distributed as dist

    return 0 if group is None else dist.get_rank(group)


def moe_mlp(
    x: torch.Tensor,  # [batch, seq, hidden] (this rank's tokens)
    gate_w: torch.Tensor,  # [hidden, experts]
    w_gate: torch.Tensor,  # [experts, hidden, mlp] (this rank's experts)
    w_up: torch.Tensor,  # [experts, hidden, mlp]
    w_down: torch.Tensor,  # [experts, mlp, hidden]
    k: int = 2,
    capacity_factor: float = 1.25,
    shard: Optional[ExpertShard] = None,
    routing: Optional[list] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE SwiGLU block: route -> expert compute -> combine. Returns
    (out [batch, seq, hidden], aux), ``aux`` fully scaled (balance and
    z-loss coefficients applied here). ``shard``: where the rank sits
    (the module docstring); None is one rank, the JAX function. A list
    ``routing`` gets the global routing appended: int32 [N, E], each
    token's slot in each expert's queue, -1 where it was not
    dispatched."""
    shard = shard or ExpertShard()
    b, s, h = x.shape
    e = gate_w.shape[-1]
    flat = x.reshape(b * s, h)

    router_logits = flat.float() @ gate_w.float()  # [n_local, E]
    # the global [batch, seq] order: the seq chunks of a row, then rows
    logits = _gather(router_logits.reshape(b, s, e), 1, shard.seq_group)
    logits = _gather(logits, 0, shard.batch_group)
    rows, seq = logits.shape[:2]
    n = rows * seq
    capacity = max(1, int(capacity_factor * n * k / e))
    logits = logits.reshape(n, e)
    # router z-loss keeps logits small (stability on bf16)
    z_loss = Z_LOSS_COEF * torch.logsumexp(logits, dim=-1).pow(2).mean()
    dispatch, weights, balance = _route(logits, k, capacity)
    aux = BALANCE_LOSS_COEF * balance + z_loss
    if routing is not None:
        slots = torch.arange(capacity, device=logits.device,
                             dtype=torch.float32)
        routing.append(torch.where(
            dispatch.sum(dim=-1) > 0, (dispatch * slots).sum(dim=-1),
            -1.0).to(torch.int32))

    # this rank's tokens (in the global order) and experts
    n_exp = w_gate.shape[0]
    experts = slice(shard.expert_start, shard.expert_start + n_exp)
    if n == b * s:
        mine = slice(None)
    else:
        row0, seq0 = _rank_in(shard.batch_group) * b, \
            _rank_in(shard.seq_group) * s
        pos = torch.arange(s, device=x.device)
        mine = ((row0 + torch.arange(b, device=x.device))[:, None] * seq
                + seq0 + pos[None, :]).reshape(-1)
    weights = copy_to_tensor(weights, shard.expert_group)
    dispatch = dispatch[mine][:, experts]
    combine = dispatch * weights[mine][:, experts][..., None]
    flat = copy_to_tensor(flat, shard.expert_group)

    xe = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), flat)  # [E, C, H]
    gate_act = F.silu(torch.einsum("ecd,edm->ecm", xe, w_gate))
    up = torch.einsum("ecd,edm->ecm", xe, w_up)
    ye = torch.einsum("ecm,emd->ecd", gate_act * up, w_down)  # [E, C, H]
    combine = combine.to(x.dtype)
    if shard.expert_group is None:
        out = torch.einsum("nec,ecd->nd", combine, ye)
    else:
        # the ranks' partial sums in fp32, rounded once after their sum,
        # as the one-rank einsum rounds its fp32 accumulation once
        out = reduce_from_tensor(torch.einsum(
            "nec,ecd->nd", combine.float(), ye.float()),
            shard.expert_group).to(x.dtype)
    return out.reshape(b, s, h), aux
