"""Llama-family decoder transformer in PyTorch, dense and MoE.

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

Under tensor parallelism (``trainer/sharded.py``'s ``tp`` and
``tp_fsdp``) each rank holds its shard of every matrix over the mesh's
``tensor`` axis -- q/k/v, gate and up column-parallel, o and down
row-parallel, the embedding and the lm_head over vocab -- and the
trainer sets ``tp_group`` on the model and its blocks: the forward then
runs on the rank's heads and MLP columns with the Megatron collectives
of ``parallel/tensor_parallel.py``, and the loss is vocab-parallel.
``param_axes`` gives each parameter its logical axes, and
``jax_coordinates`` the JAX leaf, layer and dimension order it maps to.

With ``num_experts > 0`` every block's MLP is the top-k routed expert
SwiGLU of ``parallel/moe.py``: a router ``nn.Linear`` and the experts'
stacked weights in the JAX order (``[experts, hidden, mlp]``,
``[experts, mlp, hidden]``). A block returns its MoE auxiliary loss
beside its output (None for a dense block), the model sums it over the
layers, and ``next_token_sums`` hands it to its caller, which adds it
once to the mean loss, as the JAX loss does. Under the trainer's
strategies a block's ``moe_shard`` says which experts and tokens the
rank holds.

Under the "sequence" strategy the trainer sets ``seq_shard``
(``parallel/context_parallel.py``): the rank holds one chunk of each
sequence, and its RoPE tables start at the chunk's first position, as
the slice of the JAX program's global tables does.

Under the "pipeline" strategy the trainer sets ``pipe_stage``
(``parallel/pipeline.py``), the model's stage view: the model holds the
blocks of its stage only (``layers=``; the others are
:class:`AbsentBlock`, with no parameters, so the names of the blocks it
holds stay ``blocks.<layer>``), and its forward runs the block stack as
the stage's pipeline schedule, with embed, final norm and ``lm_head``
outside it on every stage.

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
from typing import Callable, Dict, Optional, Sequence, Tuple

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
from dlrover_tpu_torch.parallel.moe import moe_mlp
from dlrover_tpu_torch.parallel.tensor_parallel import (
    copy_to_tensor,
    reduce_from_tensor,
    vocab_parallel_embedding,
    vocab_parallel_nll,
)

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
    # MoE (0 = dense): every block's MLP a top-k routed expert SwiGLU
    # (parallel/moe.py); experts shard on the expert axis
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25

    def __post_init__(self):
        if self.remat not in _REMAT:
            raise ValueError(f"unknown remat policy {self.remat!r}")

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


def llama_moe_tiny(**kw) -> LlamaConfig:
    """Test-sized MoE config (4 experts, top-2)."""
    kw.setdefault("num_experts", 4)
    return llama_tiny(**kw)


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
    if cfg.num_experts > 0:
        mlp = h * cfg.num_experts + 3 * h * m * cfg.num_experts
    else:
        mlp = 3 * h * m  # SwiGLU
    per_layer = (
        2 * h  # norms
        + h * nh * hd + 2 * h * nkv * hd + nh * hd * h  # attention
        + mlp
    )
    return cfg.vocab_size * h * 2 + h + L * per_layer


def flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Approximate training FLOPs per token (6N_active + attention
    quadratic), the JAX package's formula: under MoE only the top-k
    routed experts run per token, so N leaves the others out."""
    n = param_count(cfg) - cfg.vocab_size * cfg.hidden_size
    if cfg.num_experts > 0:
        L, h, m = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
        inactive = cfg.num_experts - min(cfg.moe_top_k, cfg.num_experts)
        n -= L * 3 * h * m * inactive
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
                device=None, start: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin [seq_len, head_dim/2] of positions ``start`` on: rows
    ``start:start + seq_len`` of the JAX tables, bit for bit."""
    exponent = torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    freqs = 1.0 / (theta ** exponent)
    t = torch.arange(start, start + seq_len, dtype=torch.float32,
                     device=device)
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


def remat_block(block: nn.Module, remat: str, x, attn_fn, *args):
    """``block(x, *args, attn_fn)`` under the remat policy ``remat``;
    ``"dots_attn_out"`` runs its two segments, ``block._pre_attn(x,
    *args) -> (q, k, v)`` and ``block._post_attn(x, attn)``, each saving
    its matmul outputs, with the attention call between them. What the
    block returns comes back as it is (the Llama block's ``(x, aux)``)."""
    if remat == "dots_attn_out":
        q, k, v = _save_dots(block._pre_attn, x, *args)
        return _save_dots(block._post_attn, x, attn_fn(q, k, v))
    if remat == "dots":
        return _save_dots(block, x, *args, attn_fn)
    if remat == "minimal":
        return _save_nothing(block, x, *args, attn_fn)
    return block(x, *args, attn_fn)


class Block(nn.Module):
    """One decoder block: RMSNorm, q/k/v projections, RoPE, attention,
    output projection, RMSNorm, SwiGLU (dense) or the routed expert
    SwiGLU (MoE)."""

    def __init__(self, cfg: LlamaConfig, device: torch.device):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.cfg = cfg
        #: the mesh's tensor group under tensor parallelism (None: the
        #: block holds its matrices whole)
        self.tp_group = None

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
        if cfg.num_experts > 0:
            E = cfg.num_experts

            def experts(*shape):
                return nn.Parameter(torch.empty(
                    E, *shape, device=device, dtype=cfg.dtype))

            self.router = linear(h, E)
            self.w_gate = experts(h, m)
            self.w_up = experts(h, m)
            self.w_down = experts(m, h)
            #: which experts and tokens this rank holds (moe.ExpertShard;
            #: None: all of them)
            self.moe_shard = None
            #: a list to append each forward's global routing to
            #: (``moe.moe_mlp``'s ``routing``), or None
            self.record_routing = None
        else:
            self.w_gate = linear(h, m)
            self.w_up = linear(h, m)
            self.w_down = linear(m, h)

    def _pre_attn(self, x, cos, sin):
        """Segment 1: attn-norm, q/k/v projections, RoPE."""
        cfg = self.cfg
        b, s, _ = x.shape
        y = copy_to_tensor(rms_norm(x, self.attn_norm, cfg.norm_eps),
                           self.tp_group)
        # this rank's heads: all of them, or its share under tp
        q = self.wq(y).view(b, s, -1, cfg.head_dim)
        k = self.wk(y).view(b, s, -1, cfg.head_dim)
        v = self.wv(y).view(b, s, -1, cfg.head_dim)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def _post_attn(self, x, attn):
        """Segment 2: output projection, residual, SwiGLU MLP (dense) or
        the expert SwiGLU. Returns (x, the MoE auxiliary loss or None)."""
        b, s, _ = x.shape
        cfg, tp = self.cfg, self.tp_group
        x = x + reduce_from_tensor(self.wo(attn.reshape(b, s, -1)), tp)
        if cfg.num_experts > 0:
            out, aux = moe_mlp(
                rms_norm(x, self.mlp_norm, cfg.norm_eps),
                self.router.weight.t(), self.w_gate, self.w_up, self.w_down,
                k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
                shard=self.moe_shard, routing=self.record_routing)
            return x + out, aux
        y = copy_to_tensor(rms_norm(x, self.mlp_norm, cfg.norm_eps), tp)
        return x + reduce_from_tensor(
            self.w_down(F.silu(self.w_gate(y)) * self.w_up(y)), tp), None

    def forward(self, x, cos, sin, attn_fn):
        q, k, v = self._pre_attn(x, cos, sin)
        return self._post_attn(x, attn_fn(q, k, v))

    def run(self, x, cos, sin, attn_fn):
        """The block under the config's remat policy: (x, aux or None)."""
        return remat_block(self, self.cfg.remat, x, attn_fn, cos, sin)


class AbsentBlock(nn.Module):
    """The place of a block another pipeline stage holds: no parameters,
    and no forward."""


def _block_draws(cfg: LlamaConfig):
    """The shapes ``init_params`` draws for a block, in its order."""
    h, m, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    attn = [(q, h), (kv, h), (kv, h), (h, q)]
    if E > 0:  # the block's experts, then its nn.Linear children
        return [(E, h, m), (E, h, m), (E, m, h)] + attn + [(E, h)]
    return attn + [(m, h), (m, h), (h, m)]


class Llama(nn.Module):
    """The Llama model. Its parameters are left uninitialized:
    ``init_params`` draws them, ``params_from_jax`` loads them.
    ``layers``: the blocks it holds (None: all of them; a pipeline
    stage's), the others :class:`AbsentBlock`."""

    def __init__(self, cfg: LlamaConfig, device=None,
                 layers: Optional[Sequence[int]] = None):
        super().__init__()
        device = resolve_device(device)
        h = cfg.hidden_size
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(
            cfg.vocab_size, h, device=device, dtype=cfg.dtype))
        held = set(range(cfg.num_layers) if layers is None else layers)
        self.blocks = nn.ModuleList(
            Block(cfg, device) if i in held else AbsentBlock()
            for i in range(cfg.num_layers))
        self.final_norm = nn.Parameter(
            torch.ones(h, device=device, dtype=torch.float32))
        self.lm_head = nn.Linear(h, cfg.vocab_size, bias=False,
                                 device=device, dtype=cfg.dtype)
        #: under tensor parallelism: the tensor group, and the first
        #: vocab row of this rank's embedding and lm_head shards
        self.tp_group = None
        self.vocab_start = 0
        #: under sequence parallelism: the rank's chunk of each sequence
        #: (context_parallel.SeqShard; None: whole sequences)
        self.seq_shard = None
        #: under pipelining: the rank's stage (pipeline.PipeStage; None:
        #: the whole stack here)
        self.pipe_stage = None

    def keep_layers(self, layers: Sequence[int]) -> None:
        """Drop every block but ``layers`` (a pipeline stage's)."""
        held = set(layers)
        for i in range(len(self.blocks)):
            if i not in held:
                self.blocks[i] = AbsentBlock()

    def hidden_states_and_aux(self, tokens: torch.Tensor,
                              attn_fn: Optional[Callable] = None,
                              schedule_stats: bool = False):
        """(final-norm hidden states [batch, seq, hidden] of int tokens
        [batch, seq], the MoE auxiliary loss summed over the layers; None
        for a dense model). Under a pipeline stage the aux is the mean
        over its microbatches, and ``schedule_stats`` appends the
        schedule's stats (``PipeStage.run``)."""
        if attn_fn is None:
            attn_fn = partial(flash_attention, causal=True)
        cfg = self.cfg
        s = tokens.shape[1]
        start = 0 if self.seq_shard is None else self.seq_shard.start(s)
        cos, sin = rope_tables(s, cfg.head_dim, cfg.rope_theta,
                               device=tokens.device, start=start)
        x = vocab_parallel_embedding(tokens, self.embed, self.vocab_start,
                                     self.tp_group)
        if self.pipe_stage is not None:
            x, aux_sum, *stats = self.pipe_stage.run(
                self.blocks, x, cos, sin, attn_fn, cfg.remat,
                schedule_stats=schedule_stats)
            return (rms_norm(x, self.final_norm, cfg.norm_eps), aux_sum,
                    *stats)
        aux_sum = None
        for block in self.blocks:
            x, aux = block.run(x, cos, sin, attn_fn)
            if aux is not None:
                aux_sum = aux if aux_sum is None else aux_sum + aux
        return rms_norm(x, self.final_norm, cfg.norm_eps), aux_sum

    def hidden_states(self, tokens: torch.Tensor,
                      attn_fn: Optional[Callable] = None) -> torch.Tensor:
        """Final-norm hidden states [batch, seq, hidden] of int tokens
        [batch, seq]."""
        return self.hidden_states_and_aux(tokens, attn_fn)[0]

    def forward(self, tokens: torch.Tensor,
                attn_fn: Optional[Callable] = None) -> torch.Tensor:
        """fp32 logits [batch, seq, vocab] (a bf16 product, cast)."""
        return self.lm_head(self.hidden_states(tokens, attn_fn)).float()


def init_params(cfg: LlamaConfig, seed: int = 0, device=None,
                layers: Optional[Sequence[int]] = None) -> Llama:
    """A model with the JAX package's initial distributions, drawn from a
    ``torch.Generator`` seeded with ``seed`` on the model's device:
    embed N(0, 0.02), matrices N(0, 1/fan_in) drawn in fp32 and cast,
    norms 1. The numbers differ from ``jax.random``'s. ``layers``: the
    blocks to hold (a pipeline stage's); an absent block's draws are made
    and dropped, so each block held has the whole model's values."""
    model = Llama(cfg, device, layers=layers)
    dev = model.embed.device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * std

    with torch.no_grad():
        model.embed.copy_(normal(model.embed.shape, 0.02))
        for module in model.modules():
            if isinstance(module, AbsentBlock):
                for shape in _block_draws(cfg):
                    normal(shape, 1.0)
            elif isinstance(module, nn.Linear):
                w = module.weight  # [out, in]: fan_in is dim 1
                w.copy_(normal(w.shape, w.shape[1] ** -0.5))
            elif isinstance(module, Block) and cfg.num_experts > 0:
                for w in (module.w_gate, module.w_up, module.w_down):
                    # [experts, in, out]: fan_in is dim 1
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


def next_token_sums(model: Llama, batch: Tuple[torch.Tensor, torch.Tensor],
                    attn_fn: Optional[Callable] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
    """(summed next-token cross entropy, count of unmasked targets, the
    MoE auxiliary loss or None for a dense model). batch = (tokens,
    targets), int [batch, seq]; a target < 0 masks its position out.
    The caller adds the auxiliary loss, already scaled, once to the mean
    (:func:`next_token_loss`, the trainer)."""
    tokens, targets = batch
    x, aux = model.hidden_states_and_aux(tokens, attn_fn=attn_fn)
    if model.tp_group is not None:
        sums = vocab_parallel_nll(
            x, model.lm_head.weight, targets, model.vocab_start,
            model.tp_group, chunk=model.cfg.loss_chunk)
    elif model.cfg.loss_chunk > 0:
        sums = _chunked_ce(
            x, model.lm_head.weight, targets, model.cfg.loss_chunk)
    else:
        sums = _masked_nll(model.lm_head(x).float(), targets)
    return sums + (aux,)


def next_token_loss(model: Llama, batch: Tuple[torch.Tensor, torch.Tensor],
                    attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Mean next-token cross entropy, plus the MoE auxiliary loss (see
    :func:`next_token_sums`)."""
    nll_sum, cnt, aux = next_token_sums(model, batch, attn_fn=attn_fn)
    loss = nll_sum / cnt.clamp(min=1.0)
    return loss if aux is None else loss + aux


def make_trainer(cfg: LlamaConfig, device=None, strategy: str = "ddp",
                 accum_steps: int = 1, optimizer=None, attn_fn=None,
                 mesh=None):
    """Trainer for the Llama model; ``device=None`` is the GPU."""
    from dlrover_tpu_torch.trainer.sharded import make_trainer_for_llama

    return make_trainer_for_llama(
        cfg, device=device, strategy=strategy, accum_steps=accum_steps,
        optimizer=optimizer, attn_fn=attn_fn, mesh=mesh)


def example_batch(cfg, global_batch: int, seq_len: int = 1):
    """Zero-filled (tokens, targets), int64 [batch, seq]; GPT's too."""
    tokens = np.zeros((global_batch, seq_len), dtype=np.int64)
    return tokens, tokens


# ---------------------------------------------------------------------------
# weights from the JAX package

_MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_NORMS = ("attn_norm", "mlp_norm")
_EXPERTS = ("w_gate", "w_up", "w_down")


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):  # e.g. read from a JAX checkpoint
        return a.detach().clone()
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
    moe = cfg.num_experts > 0
    for i in range(cfg.num_layers):
        for name in _NORMS:
            state[f"blocks.{i}.{name}"] = _tensor(blocks[name][i])
        for name in _MATRICES:
            if moe and name in _EXPERTS:  # stacked experts keep JAX's order
                state[f"blocks.{i}.{name}"] = _tensor(blocks[name][i])
            else:
                state[f"blocks.{i}.{name}.weight"] = _tensor(
                    blocks[name][i]).T
        if moe:
            state[f"blocks.{i}.router.weight"] = _tensor(
                blocks["router"][i]).T
    model = Llama(cfg, device)
    model.load_state_dict(state)
    return model


# ---------------------------------------------------------------------------
# logical axes, and the JAX coordinates of each parameter

#: a block's matrices: (logical axes in the port's [out, in] order)
_BLOCK_AXES = {
    "attn_norm": ("norm",),
    "wq.weight": ("heads", "embed"),
    "wk.weight": ("kv_heads", "embed"),
    "wv.weight": ("kv_heads", "embed"),
    "wo.weight": ("embed", "heads"),
    "mlp_norm": ("norm",),
    "w_gate.weight": ("mlp", "embed"),
    "w_up.weight": ("mlp", "embed"),
    "w_down.weight": ("embed", "mlp"),
}
#: an MoE block's router and experts (the experts in JAX's order)
_MOE_AXES = {
    "router.weight": (None, "embed"),
    "w_gate": ("expert", "embed", "mlp"),
    "w_up": ("expert", "embed", "mlp"),
    "w_down": ("expert", "mlp", "embed"),
}


def param_axes(cfg: LlamaConfig) -> Dict[str, Tuple[str, ...]]:
    """Logical axes of every parameter, keyed by the port's names and in
    the port's dimension order: the JAX ``param_axes`` without the
    stacked ``"layers"`` axis, reversed for every ``nn.Linear`` weight
    (``[out, in]`` where JAX stores ``[in, out]``)."""
    axes = {
        "embed": ("vocab", "embed"),
        "final_norm": ("norm",),
        "lm_head.weight": ("vocab", "embed"),
    }
    block = dict(_BLOCK_AXES)
    if cfg.num_experts > 0:
        for name in _EXPERTS:
            del block[f"{name}.weight"]
        block.update(_MOE_AXES)
    for i in range(cfg.num_layers):
        for name, ax in block.items():
            axes[f"blocks.{i}.{name}"] = ax
    return axes


#: the logical axes of the Megatron layout over the mesh's ``tensor``
#: axis, which the model's tensor-parallel code consumes
TP_AXES = ("heads", "kv_heads", "mlp", "vocab")


def held_axes(rules) -> set:
    """The (logical axis, mesh axis) pairs of ``rules`` that the model's
    own parallel code consumes sharded (``trainer/sharded.py`` gathers
    every other sharded dim before use): the whole Megatron layout over
    ``tensor`` -- exactly :data:`TP_AXES` there, no other logical axis --
    and the experts over ``expert``. GPT's too."""
    from dlrover_tpu_torch.parallel.sharding import spec_axes

    on_tensor = {ax for ax, rule in rules.items()
                 if ax != "batch" and "tensor" in spec_axes(rule)}
    held = set()
    if on_tensor == set(TP_AXES):
        held |= {(ax, "tensor") for ax in TP_AXES}
    if spec_axes(rules.get("expert")) == ("expert",):
        held.add(("expert", "expert"))
    return held


def check_heads(cfg, rules, mesh) -> None:
    """Raise where the held tensor layout would cut a head: the flash
    kernels take whole heads, so the Q and KV head counts must divide by
    the tensor axis (GSPMD would cut one)."""
    from dlrover_tpu_torch.parallel.mesh import axis_size

    t = axis_size(mesh, "tensor")
    kv = getattr(cfg, "kv_heads", None) or cfg.num_kv_heads
    if (t > 1 and ("heads", "tensor") in held_axes(rules)
            and (cfg.num_heads % t or kv % t)):
        raise ValueError(
            f"{cfg.num_heads} heads ({kv} kv heads) do not split over "
            f"{t} tensor ranks: the flash kernels take whole heads")


@dataclasses.dataclass(frozen=True)
class JaxLeaf:
    """Where a port parameter lives in the JAX parameter tree: the leaf's
    key path and global shape, the layer it is (None: not stacked), and
    ``dims[d]``, the JAX dimension the port's dimension ``d`` is."""

    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    layer: Optional[int]
    dims: Tuple[int, ...]

    def index(self, port_idx) -> list:
        """A ``[[start, end), ...]`` box of the port's tensor as the box
        of the JAX leaf it is."""
        out = [[0, n] for n in self.shape]
        if self.layer is not None:
            out[0] = [self.layer, self.layer + 1]
        for d, (a, b) in enumerate(port_idx):
            out[self.dims[d]] = [int(a), int(b)]
        return out

    def to_jax(self, t: torch.Tensor) -> torch.Tensor:
        """The port's tensor (or a box of it) viewed in JAX order, with
        the layer dim in front for a stacked leaf."""
        order = sorted(range(t.dim()), key=lambda d: self.dims[d])
        view = t.permute(order)
        return view.unsqueeze(0) if self.layer is not None else view

    def from_jax(self, t: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`to_jax`: a JAX-ordered box as the port's."""
        if self.layer is not None:
            t = t.squeeze(0)
        ranks = sorted(range(t.dim()), key=lambda d: self.dims[d])
        inverse = [ranks.index(d) for d in range(t.dim())]
        return t.permute(inverse)


def jax_coordinates(cfg: LlamaConfig, name: str) -> JaxLeaf:
    """The JAX leaf a port parameter comes from (``params_from_jax``'s
    mapping): blocks are layer ``i`` of a stacked leaf, matrices are
    transposed."""
    h, m, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    if name == "embed":
        return JaxLeaf(("embed",), (v, h), None, (0, 1))
    if name == "final_norm":
        return JaxLeaf(("final_norm",), (h,), None, (0,))
    if name == "lm_head.weight":
        return JaxLeaf(("lm_head",), (h, v), None, (1, 0))
    _, layer, leaf = name.split(".", 2)
    key = leaf.split(".")[0]
    L, E = cfg.num_layers, cfg.num_experts
    if key in _NORMS:
        return JaxLeaf(("blocks", key), (L, h), int(layer), (1,))
    if E > 0 and key in _EXPERTS:
        shape = (E, m, h) if key == "w_down" else (E, h, m)
        return JaxLeaf(("blocks", key), (L,) + shape, int(layer), (1, 2, 3))
    shapes = {"wq": (h, q), "wk": (h, kv), "wv": (h, kv), "wo": (q, h),
              "w_gate": (h, m), "w_up": (h, m), "w_down": (m, h),
              "router": (h, E)}
    return JaxLeaf(("blocks", key), (L,) + shapes[key], int(layer), (2, 1))
