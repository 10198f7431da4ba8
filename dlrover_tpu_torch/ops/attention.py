"""Attention ops: the plain reference and the dispatch to the kernels.

Counterpart of ``dlrover_tpu/ops/attention.py``. On a CUDA tensor
``flash_attention`` launches the hand-written Hopper kernels
(``ops/cuda``) when the shape passes the kernels' gate and raises
otherwise: there is no quiet fallback on the card. On a CPU tensor it
runs the kernels' plain PyTorch versions inside the gate and
``mha_reference`` outside it, as the JAX package runs its reference off
the TPU.
"""

from typing import Optional

import torch

from dlrover_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_cuda,
    shape_error,
)

NEG_INF = -1e30


def mha_reference(
    q: torch.Tensor,  # [batch, q_len, heads, head_dim]
    k: torch.Tensor,  # [batch, kv_len, kv_heads, head_dim]
    v: torch.Tensor,  # [batch, kv_len, kv_heads, head_dim]
    causal: bool = True,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,  # bool [q_len, kv_len], True=keep
    return_lse: bool = False,
):
    """Plain attention with GQA head-group broadcast (no KV repeat).

    Softmax in float32, result in q.dtype; a causal mask is aligned to
    the bottom right (``tril(k=kv_len - q_len)``). Probabilities are hard
    zeroed under the mask, so a fully masked row gives zeros and an lse
    of ``NEG_INF``. With ``return_lse`` also returns the logsumexp
    ``[batch, heads, q_len]`` (float32).
    """
    b, qlen, h, d = q.shape
    _, klen, kvh, _ = k.shape
    if h % kvh:
        raise ValueError(f"heads {h} not a multiple of kv_heads {kvh}")
    group = h // kvh
    scale = scale if scale is not None else d ** -0.5

    qf = q.float().reshape(b, qlen, kvh, group, d) * scale
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if causal:
        tril = torch.ones(
            qlen, klen, dtype=torch.bool, device=q.device
        ).tril(klen - qlen)
        mask = tril if mask is None else (mask & tril)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p / l_safe, v.float())
    out = out.reshape(b, qlen, h, d).to(q.dtype)
    if not return_lse:
        return out
    lse = (m + torch.log(l_safe))[..., 0]  # [b, kvh, group, qlen]
    lse = torch.where(l[..., 0] == 0.0, torch.full_like(lse, NEG_INF), lse)
    return out, lse.reshape(b, h, qlen)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Memory-efficient attention in the layout [batch, seq, heads,
    head_dim]: the Hopper kernels on a CUDA tensor (ValueError outside
    their gate, ``shape_error``), their plain versions or
    ``mha_reference`` on the CPU."""
    if q.is_cuda or shape_error(q.shape, k.shape) is None:
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    return mha_reference(q, k, v, causal=causal, scale=scale)
