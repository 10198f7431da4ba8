"""Llama-family decoder transformer, dense path, in PyTorch.

Counterpart of ``dlrover_tpu/models/llama.py``. The JAX model keeps its
weights in one pytree with scan-stacked blocks and ``[in, out]``
matrices; here each block is an ``nn.Module`` in an ``nn.ModuleList``
with ``nn.Linear`` weights ``[out, in]``. ``params_from_jax`` is the one
place the layout changes. The arithmetic follows the JAX code: bf16
weights and activations, fp32 norm weights and RMSNorm accumulation,
RoPE over split halves in the activations' dtype, fp32 logits from a
bf16 product, targets < 0 masked out of the loss. Attention goes
through ``ops.attention.flash_attention`` (the Hopper kernels on the
GPU).

Activation checkpointing (``remat``), as in the JAX model:
``"dots_attn_out"`` checkpoints the segments before and after attention
and saves their matmul outputs, with the attention call outside both so
its saved tensors are kept and the backward never re-runs the forward
kernel; ``"dots"`` does the same around the whole block (attention is
recomputed); ``"minimal"`` recomputes the whole block; ``"off"`` saves
everything.
"""

import dataclasses
from functools import partial
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from dlrover_tpu_torch.auto.device_context import resolve_device
from dlrover_tpu_torch.ops.attention import flash_attention

_REMAT = ("off", "dots", "dots_attn_out", "minimal")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: str = "dots"
    # chunked cross-entropy over this many tokens at a time (0 = off)
    loss_chunk: int = 0
    # MoE is not ported: any value > 0 raises
    num_experts: int = 0

    def __post_init__(self):
        if self.remat not in _REMAT:
            raise ValueError(f"unknown remat policy {self.remat!r}")
        if self.num_experts > 0:
            raise NotImplementedError(
                "MoE Llama is not ported yet (ROADMAP.md, queue A, "
                "'Parallelism': moe.py top-k gating and the MoE Llama)"
            )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def llama2_7b(**kw) -> LlamaConfig:
    return LlamaConfig(**kw)


def llama2_13b(**kw) -> LlamaConfig:
    return LlamaConfig(
        hidden_size=5120, intermediate_size=13824, num_layers=40,
        num_heads=40, num_kv_heads=40, **kw,
    )


def llama2_70b(**kw) -> LlamaConfig:
    return LlamaConfig(
        hidden_size=8192, intermediate_size=28672, num_layers=80,
        num_heads=64, num_kv_heads=8, **kw,
    )


def llama_1b(**kw) -> LlamaConfig:
    """A ~1.1B config (TinyLlama shape) for single-chip benchmarking."""
    return LlamaConfig(
        hidden_size=2048, intermediate_size=5632, num_layers=22,
        num_heads=32, num_kv_heads=4, **kw,
    )


def llama_tiny(**kw) -> LlamaConfig:
    """Test-sized config that still exercises GQA and remat."""
    kw.setdefault("vocab_size", 256)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("intermediate_size", 128)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("num_kv_heads", 2)
    kw.setdefault("max_seq_len", 128)
    return LlamaConfig(**kw)


def param_count(cfg: LlamaConfig) -> int:
    L, h, m = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    per_layer = (
        2 * h  # norms
        + h * nh * hd + 2 * h * nkv * hd + nh * hd * h  # attention
        + 3 * h * m  # SwiGLU
    )
    return cfg.vocab_size * h * 2 + h + L * per_layer


def flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Approximate training FLOPs per token (6N + attention quadratic),
    the JAX package's formula."""
    n = param_count(cfg) - cfg.vocab_size * cfg.hidden_size
    attn = 12 * cfg.num_layers * cfg.hidden_size * seq_len
    return 6.0 * n + attn


# ---------------------------------------------------------------------------
# building blocks

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_tables(seq_len: int, head_dim: int, theta: float,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    exponent = torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    freqs = 1.0 / (theta ** exponent)
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(t, freqs)  # [seq, head_dim/2]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: [batch, seq, heads, head_dim]. Rotates the split halves
    (x[..., :d/2], x[..., d/2:]) -- what the JAX code does -- in x's own
    dtype, with the tables cast to it."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# matmul outputs, the "dots" that the JAX policy
# dots_with_no_batch_dims_saveable keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


_save_dots = partial(checkpoint, use_reentrant=False,
                     context_fn=_dots_context)
_save_nothing = partial(checkpoint, use_reentrant=False)


class Block(nn.Module):
    """One dense decoder block: RMSNorm, q/k/v projections, RoPE,
    attention, output projection, RMSNorm, SwiGLU."""

    def __init__(self, cfg: LlamaConfig, device: torch.device):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.cfg = cfg

        def linear(n_in, n_out):
            return nn.Linear(n_in, n_out, bias=False, device=device,
                             dtype=cfg.dtype)

        def norm():
            return nn.Parameter(
                torch.ones(h, device=device, dtype=torch.float32))

        self.attn_norm = norm()
        self.wq = linear(h, nh * hd)
        self.wk = linear(h, nkv * hd)
        self.wv = linear(h, nkv * hd)
        self.wo = linear(nh * hd, h)
        self.mlp_norm = norm()
        self.w_gate = linear(h, m)
        self.w_up = linear(h, m)
        self.w_down = linear(m, h)

    def _pre_attn(self, x, cos, sin):
        """Segment 1: attn-norm, q/k/v projections, RoPE."""
        cfg = self.cfg
        b, s, _ = x.shape
        y = rms_norm(x, self.attn_norm, cfg.norm_eps)
        q = self.wq(y).view(b, s, cfg.num_heads, cfg.head_dim)
        k = self.wk(y).view(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = self.wv(y).view(b, s, cfg.num_kv_heads, cfg.head_dim)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def _post_attn(self, x, attn):
        """Segment 2: output projection, residual, SwiGLU MLP."""
        b, s, _ = x.shape
        x = x + self.wo(attn.reshape(b, s, -1))
        y = rms_norm(x, self.mlp_norm, self.cfg.norm_eps)
        return x + self.w_down(F.silu(self.w_gate(y)) * self.w_up(y))

    def forward(self, x, cos, sin, attn_fn):
        q, k, v = self._pre_attn(x, cos, sin)
        return self._post_attn(x, attn_fn(q, k, v))

    def run(self, x, cos, sin, attn_fn):
        """The block under the config's remat policy."""
        remat = self.cfg.remat
        if remat == "dots_attn_out":
            q, k, v = _save_dots(self._pre_attn, x, cos, sin)
            return _save_dots(self._post_attn, x, attn_fn(q, k, v))
        if remat == "dots":
            return _save_dots(self, x, cos, sin, attn_fn)
        if remat == "minimal":
            return _save_nothing(self, x, cos, sin, attn_fn)
        return self(x, cos, sin, attn_fn)


class Llama(nn.Module):
    """The dense Llama model. Its parameters are left uninitialized:
    ``init_params`` draws them, ``params_from_jax`` loads them."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        h = cfg.hidden_size
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(
            cfg.vocab_size, h, device=device, dtype=cfg.dtype))
        self.blocks = nn.ModuleList(
            Block(cfg, device) for _ in range(cfg.num_layers))
        self.final_norm = nn.Parameter(
            torch.ones(h, device=device, dtype=torch.float32))
        self.lm_head = nn.Linear(h, cfg.vocab_size, bias=False,
                                 device=device, dtype=cfg.dtype)

    def hidden_states(self, tokens: torch.Tensor,
                      attn_fn: Optional[Callable] = None) -> torch.Tensor:
        """Final-norm hidden states [batch, seq, hidden] of int tokens
        [batch, seq]."""
        if attn_fn is None:
            attn_fn = partial(flash_attention, causal=True)
        cfg = self.cfg
        cos, sin = rope_tables(tokens.shape[1], cfg.head_dim,
                               cfg.rope_theta, device=tokens.device)
        x = F.embedding(tokens, self.embed)
        for block in self.blocks:
            x = block.run(x, cos, sin, attn_fn)
        return rms_norm(x, self.final_norm, cfg.norm_eps)

    def forward(self, tokens: torch.Tensor,
                attn_fn: Optional[Callable] = None) -> torch.Tensor:
        """fp32 logits [batch, seq, vocab] (a bf16 product, cast)."""
        return self.lm_head(self.hidden_states(tokens, attn_fn)).float()


def init_params(cfg: LlamaConfig, seed: int = 0, device=None) -> Llama:
    """A model with the JAX package's initial distributions, drawn from a
    ``torch.Generator`` seeded with ``seed`` on the model's device:
    embed N(0, 0.02), matrices N(0, 1/fan_in) drawn in fp32 and cast,
    norms 1. The numbers differ from ``jax.random``'s."""
    model = Llama(cfg, device)
    dev = model.embed.device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * std

    with torch.no_grad():
        model.embed.copy_(normal(model.embed.shape, 0.02))
        for module in model.modules():
            if isinstance(module, nn.Linear):
                w = module.weight  # [out, in]: fan_in is dim 1
                w.copy_(normal(w.shape, w.shape[1] ** -0.5))
    return model


# ---------------------------------------------------------------------------
# loss

def _masked_nll(logits: torch.Tensor, targets: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of masked nll, mask count); targets < 0 are masked out."""
    mask = (targets >= 0).float()
    nll = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]),
        targets.clamp(min=0).reshape(-1).long(), reduction="none",
    )
    return (nll * mask.reshape(-1)).sum(), mask.sum()


def _chunked_ce(x: torch.Tensor, lm_head: torch.Tensor,
                targets: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross entropy without the full [tokens, vocab] logits: each chunk
    of ``chunk`` tokens has its logits recomputed in the backward, so
    the peak is one [chunk, vocab] block. ``lm_head`` is the weight
    [vocab, hidden]."""
    h = x.shape[-1]
    xf = x.reshape(-1, h)
    tf = targets.reshape(-1)
    n = xf.shape[0]
    if n % chunk:
        # pad with masked (-1) targets rather than fall back to full logits
        pad = chunk - n % chunk
        xf = torch.cat([xf, xf.new_zeros(pad, h)])
        tf = torch.cat([tf, tf.new_full((pad,), -1)])

    def body(xs, ts):
        return _masked_nll(F.linear(xs, lm_head).float(), ts)

    nll_sum = x.new_zeros((), dtype=torch.float32)
    cnt = x.new_zeros((), dtype=torch.float32)
    for xs, ts in zip(xf.split(chunk), tf.split(chunk)):
        s, c = _save_nothing(body, xs, ts)
        nll_sum = nll_sum + s
        cnt = cnt + c
    return nll_sum, cnt


def next_token_loss(model: Llama, batch: Tuple[torch.Tensor, torch.Tensor],
                    attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Mean next-token cross entropy. batch = (tokens, targets), int
    [batch, seq]; a target < 0 masks its position out."""
    tokens, targets = batch
    x = model.hidden_states(tokens, attn_fn=attn_fn)
    if model.cfg.loss_chunk > 0:
        nll_sum, cnt = _chunked_ce(
            x, model.lm_head.weight, targets, model.cfg.loss_chunk)
    else:
        nll_sum, cnt = _masked_nll(model.lm_head(x).float(), targets)
    return nll_sum / cnt.clamp(min=1.0)


# ---------------------------------------------------------------------------
# weights from the JAX package

_MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_NORMS = ("attn_norm", "mlp_norm")


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy rejects; float32
        # holds every bf16 value exactly
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def params_from_jax(np_tree: Dict, cfg: LlamaConfig, device=None) -> Llama:
    """The port's model holding the JAX model's weights.

    ``np_tree`` is the JAX parameter pytree as numpy arrays
    (``jax.tree.map(np.asarray, params)``): the blocks are un-stacked
    from their leading layers dim, and ``[in, out]`` matrices become
    ``nn.Linear``'s ``[out, in]``."""
    blocks = np_tree["blocks"]
    state = {
        "embed": _tensor(np_tree["embed"]),
        "final_norm": _tensor(np_tree["final_norm"]),
        "lm_head.weight": _tensor(np_tree["lm_head"]).T,
    }
    for i in range(cfg.num_layers):
        for name in _NORMS:
            state[f"blocks.{i}.{name}"] = _tensor(blocks[name][i])
        for name in _MATRICES:
            state[f"blocks.{i}.{name}.weight"] = _tensor(blocks[name][i]).T
    model = Llama(cfg, device)
    model.load_state_dict(state)
    return model
