"""GPT-2-style decoder family in PyTorch.

Counterpart of ``dlrover_tpu/models/gpt.py``: learned absolute position
embeddings, pre-LayerNorm with bias, a tanh-GELU MLP, biases on every
projection, and an lm_head tied to the embedding by default. As in the
port's Llama, each block is an ``nn.Module`` with ``nn.Linear`` weights
``[out, in]``; ``params_from_jax`` un-stacks the JAX blocks and
transposes their ``[in, out]`` matrices. The arithmetic follows the JAX
code: bf16 weights, biases and activations, LayerNorm in fp32 with fp32
scale and bias and the result cast back, separate q/k/v projections,
``jax.nn.gelu``'s default (the tanh approximation), fp32 logits from a
bf16 product, targets < 0 masked out of the loss. Attention goes through
``ops.attention.flash_attention`` (the Hopper kernels on the GPU), and
the loss reuses the Llama's cross-entropy and remat policies.

The tied head is the embedding itself (``head_weight``): one parameter,
whose gradient sums the lookup's and the head's.

On a mesh the model runs the Llama's strategies (``trainer/sharded.py``):
``param_axes`` gives each parameter its logical axes and
``jax_coordinates`` the JAX leaf it is. Under the Megatron layout over
``tensor`` (tp, tp_fsdp) each rank holds its heads of q/k/v with their
biases, its rows of ``wo``, its columns of ``w_fc`` with ``b_fc``, its
rows of ``w_proj`` and its vocab rows of the embedding (and of an untied
head); the trainer sets ``tp_group``, and the forward runs the
collectives of ``parallel/tensor_parallel.py``: ``bo`` and ``b_proj``
are added once, after the row-parallel sums, and the lookup and the loss
are vocab-parallel.
"""

import dataclasses
from functools import partial
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dlrover_tpu_torch.auto.device_context import resolve_device
from dlrover_tpu_torch.models.llama import (
    _REMAT,
    JaxLeaf,
    _chunked_ce,
    _masked_nll,
    _tensor,
    check_heads,
    example_batch as _lm_batch,
    held_axes,
    remat_block,
)
from dlrover_tpu_torch.ops.attention import flash_attention
from dlrover_tpu_torch.parallel.tensor_parallel import (
    copy_to_tensor,
    reduce_from_tensor,
    vocab_parallel_embedding,
    vocab_parallel_nll,
)


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int = 0  # 0 = MHA (GPT-2); > 0 is GQA
    max_seq_len: int = 1024
    norm_eps: float = 1e-5
    tie_lm_head: bool = True
    # the Llama's policies (models/llama.py); the JAX model has "off",
    # "dots" and "minimal"
    remat: str = "dots"
    loss_chunk: int = 0
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.remat not in _REMAT:
            raise ValueError(f"unknown remat policy {self.remat!r}")

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def gpt2_small(**kw) -> GPTConfig:
    return GPTConfig(**kw)


def gpt2_xl(**kw) -> GPTConfig:
    """GPT-2 XL: 48 layers, hidden 1600, 25 heads of 64. Its default
    remat "dots" re-runs each block's forward in the backward, so a step
    launches the flash forward twice per layer (96 at 48 layers); on the
    card choose ``remat="dots_attn_out"``, which saves the attention
    output and launches each of the three kernels once per layer, as
    ``chip_smoke.py`` runs it."""
    return GPTConfig(
        hidden_size=1600, intermediate_size=6400, num_layers=48,
        num_heads=25, **kw,
    )


def gpt_tiny(**kw) -> GPTConfig:
    kw.setdefault("remat", "off")
    return GPTConfig(
        vocab_size=256, hidden_size=64, intermediate_size=256,
        num_layers=2, num_heads=4, max_seq_len=64, **kw,
    )


def param_count(cfg: GPTConfig) -> int:
    h, m, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    per_layer = (
        4 * h  # two LayerNorms (scale + bias)
        + h * nh * hd + nh * hd  # q
        + 2 * (h * nkv * hd + nkv * hd)  # k, v
        + nh * hd * h + h  # o
        + h * m + m + m * h + h  # mlp
    )
    n = cfg.vocab_size * h + cfg.max_seq_len * h + 2 * h + L * per_layer
    if not cfg.tie_lm_head:
        n += h * cfg.vocab_size
    return n


def flops_per_token(cfg: GPTConfig, seq_len: int) -> float:
    """Training FLOPs per token (6N + attention quadratic), the JAX
    package's formula."""
    n = param_count(cfg) - cfg.vocab_size * cfg.hidden_size
    attn = 12 * cfg.num_layers * cfg.hidden_size * seq_len
    return 6.0 * n + attn


# ---------------------------------------------------------------------------
# model

def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm in fp32 with fp32 scale and bias, cast back to x's
    dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).pow(2).mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def _norm(h: int, value: float, device) -> nn.Parameter:
    return nn.Parameter(
        torch.full((h,), value, device=device, dtype=torch.float32))


class Block(nn.Module):
    """LayerNorm, q/k/v projections, attention, output projection,
    LayerNorm, GELU MLP; every projection with a bias."""

    def __init__(self, cfg: GPTConfig, device: torch.device):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        self.cfg = cfg
        #: the mesh's tensor group under tensor parallelism (None: the
        #: block holds its matrices whole)
        self.tp_group = None

        def linear(n_in, n_out):
            return nn.Linear(n_in, n_out, device=device, dtype=cfg.dtype)

        self.ln1_scale = _norm(h, 1, device)
        self.ln1_bias = _norm(h, 0, device)
        self.wq = linear(h, nh * hd)
        self.wk = linear(h, nkv * hd)
        self.wv = linear(h, nkv * hd)
        self.wo = linear(nh * hd, h)
        self.ln2_scale = _norm(h, 1, device)
        self.ln2_bias = _norm(h, 0, device)
        self.w_fc = linear(h, m)
        self.w_proj = linear(m, h)

    def _pre_attn(self, x):
        """Segment 1: LayerNorm and the q/k/v projections."""
        cfg = self.cfg
        b, s, _ = x.shape
        y = copy_to_tensor(
            layer_norm(x, self.ln1_scale, self.ln1_bias, cfg.norm_eps),
            self.tp_group)
        # this rank's heads: all of them, or its share under tp
        return (self.wq(y).view(b, s, -1, cfg.head_dim),
                self.wk(y).view(b, s, -1, cfg.head_dim),
                self.wv(y).view(b, s, -1, cfg.head_dim))

    def _row_parallel(self, linear: nn.Linear, x):
        """``linear(x)``; under tp the rank's partial product summed over
        the tensor group, then the bias added once."""
        if self.tp_group is None:
            return linear(x)
        return reduce_from_tensor(F.linear(x, linear.weight),
                                  self.tp_group) + linear.bias

    def _post_attn(self, x, attn):
        """Segment 2: output projection, residual, GELU MLP."""
        b, s, _ = x.shape
        x = x + self._row_parallel(self.wo, attn.reshape(b, s, -1))
        y = copy_to_tensor(
            layer_norm(x, self.ln2_scale, self.ln2_bias, self.cfg.norm_eps),
            self.tp_group)
        return x + self._row_parallel(
            self.w_proj, F.gelu(self.w_fc(y), approximate="tanh"))

    def forward(self, x, attn_fn):
        return self._post_attn(x, attn_fn(*self._pre_attn(x)))

    def run(self, x, attn_fn):
        """The block under the config's remat policy (models/llama.py)."""
        return remat_block(self, self.cfg.remat, x, attn_fn)


class GPT(nn.Module):
    """The GPT model. Its parameters are left uninitialized:
    ``init_params`` draws them, ``params_from_jax`` loads them."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        h = cfg.hidden_size
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(
            cfg.vocab_size, h, device=device, dtype=cfg.dtype))
        self.pos_embed = nn.Parameter(torch.empty(
            cfg.max_seq_len, h, device=device, dtype=cfg.dtype))
        self.blocks = nn.ModuleList(
            Block(cfg, device) for _ in range(cfg.num_layers))
        self.final_ln_scale = _norm(h, 1, device)
        self.final_ln_bias = _norm(h, 0, device)
        self.lm_head = (None if cfg.tie_lm_head else nn.Linear(
            h, cfg.vocab_size, bias=False, device=device, dtype=cfg.dtype))
        #: under tensor parallelism: the tensor group, and the first
        #: vocab row of this rank's embedding (and head) shard
        self.tp_group = None
        self.vocab_start = 0

    def head_weight(self) -> torch.Tensor:
        """The lm_head as ``[vocab, hidden]``: the embedding when tied."""
        return self.embed if self.lm_head is None else self.lm_head.weight

    def hidden_states(self, tokens: torch.Tensor,
                      attn_fn: Optional[Callable] = None) -> torch.Tensor:
        """Final-LayerNorm hidden states [batch, seq, hidden] of int
        tokens [batch, seq], seq <= ``max_seq_len``."""
        if attn_fn is None:
            attn_fn = partial(flash_attention, causal=True)
        cfg = self.cfg
        s = tokens.shape[1]
        if s > cfg.max_seq_len:
            raise ValueError(
                f"seq {s} is longer than max_seq_len {cfg.max_seq_len}")
        x = (vocab_parallel_embedding(tokens, self.embed, self.vocab_start,
                                      self.tp_group)
             + self.pos_embed[:s][None])
        for block in self.blocks:
            x = block.run(x, attn_fn)
        return layer_norm(x, self.final_ln_scale, self.final_ln_bias,
                          cfg.norm_eps)

    def forward(self, tokens: torch.Tensor,
                attn_fn: Optional[Callable] = None) -> torch.Tensor:
        """fp32 logits [batch, seq, vocab] (a bf16 product, cast)."""
        return F.linear(self.hidden_states(tokens, attn_fn),
                        self.head_weight()).float()


def init_params(cfg: GPTConfig, seed: int = 0, device=None) -> GPT:
    """A model with the JAX package's initial distributions, drawn from a
    ``torch.Generator`` seeded with ``seed`` on the model's device:
    embed N(0, 0.02), positions N(0, 0.01), matrices N(0, 1/fan_in)
    drawn in fp32 and cast, biases 0, LayerNorms 1 and 0. The numbers
    differ from ``jax.random``'s."""
    model = GPT(cfg, device)
    dev = model.embed.device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * std

    with torch.no_grad():
        model.embed.copy_(normal(model.embed.shape, 0.02))
        model.pos_embed.copy_(normal(model.pos_embed.shape, 0.01))
        for module in model.modules():
            if isinstance(module, nn.Linear):
                w = module.weight  # [out, in]: fan_in is dim 1
                w.copy_(normal(w.shape, w.shape[1] ** -0.5))
                if module.bias is not None:
                    module.bias.zero_()
    return model


def next_token_sums(model: GPT, batch: Tuple[torch.Tensor, torch.Tensor],
                    attn_fn: Optional[Callable] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed next-token cross entropy, count of unmasked targets).
    batch = (tokens, targets), int [batch, seq]; a target < 0 masks its
    position out."""
    tokens, targets = batch
    x = model.hidden_states(tokens, attn_fn=attn_fn)
    head = model.head_weight()
    if model.tp_group is not None:
        return vocab_parallel_nll(x, head, targets, model.vocab_start,
                                  model.tp_group, chunk=model.cfg.loss_chunk)
    if model.cfg.loss_chunk > 0:
        return _chunked_ce(x, head, targets, model.cfg.loss_chunk)
    return _masked_nll(F.linear(x, head).float(), targets)


def next_token_loss(model: GPT, batch: Tuple[torch.Tensor, torch.Tensor],
                    attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Mean next-token cross entropy (see :func:`next_token_sums`)."""
    nll_sum, cnt = next_token_sums(model, batch, attn_fn=attn_fn)
    return nll_sum / cnt.clamp(min=1.0)


def make_trainer(cfg: GPTConfig, device=None, strategy: str = "ddp",
                 accum_steps: int = 1, optimizer=None, attn_fn=None,
                 mesh=None):
    """Trainer for the GPT model; ``device=None`` is the GPU, ``mesh=None``
    the JAX default mesh, ``[(data, 1), (fsdp, world)]``. Under a held
    tensor layout the heads must divide by the tensor axis (GPT-2 XL's 25
    do not split over 2 or 4 ranks: building it raises)."""
    from dlrover_tpu_torch.parallel import mesh as mesh_lib
    from dlrover_tpu_torch.parallel.sharding import get_rules
    from dlrover_tpu_torch.trainer.sharded import family_trainer

    if mesh is None:
        mesh = mesh_lib.create_mesh([("data", 1), ("fsdp", -1)],
                                    device=resolve_device(device))
    check_heads(cfg, get_rules(strategy), mesh)
    return family_trainer(
        cfg, lambda model, batch: next_token_sums(model, batch, attn_fn),
        lambda seed, dev: init_params(cfg, seed=seed, device=dev),
        param_count(cfg), device=device, strategy=strategy,
        accum_steps=accum_steps, optimizer=optimizer, mesh=mesh,
        param_axes=lambda model: param_axes(cfg),
        jax_coordinates=lambda name: jax_coordinates(cfg, name),
        held_axes=held_axes)


#: the models contract's batch: (tokens, targets), as the Llama's
example_batch = _lm_batch


# ---------------------------------------------------------------------------
# weights from the JAX package

_LINEARS = {"wq": "bq", "wk": "bk", "wv": "bv", "wo": "bo",
            "w_fc": "b_fc", "w_proj": "b_proj"}
_NORMS = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")


def params_from_jax(np_tree: Dict, cfg: GPTConfig, device=None) -> GPT:
    """The port's model holding the JAX model's weights (``np_tree``:
    ``jax.tree.map(np.asarray, params)``): the blocks un-stacked from
    their leading layers dim, ``[in, out]`` matrices transposed to
    ``nn.Linear``'s ``[out, in]``, each bias on its projection."""
    blocks = np_tree["blocks"]
    state = {name: _tensor(np_tree[name]) for name in (
        "embed", "pos_embed", "final_ln_scale", "final_ln_bias")}
    if not cfg.tie_lm_head:
        state["lm_head.weight"] = _tensor(np_tree["lm_head"]).T
    for i in range(cfg.num_layers):
        for name in _NORMS:
            state[f"blocks.{i}.{name}"] = _tensor(blocks[name][i])
        for name, bias in _LINEARS.items():
            state[f"blocks.{i}.{name}.weight"] = _tensor(blocks[name][i]).T
            state[f"blocks.{i}.{name}.bias"] = _tensor(blocks[bias][i])
    model = GPT(cfg, device)
    model.load_state_dict(state)
    return model


# ---------------------------------------------------------------------------
# logical axes, and the JAX coordinates of each parameter

#: a block's parameters: (logical axes in the port's order; the JAX leaf)
_BLOCK = {
    "ln1_scale": (("norm",), "ln1_scale"),
    "ln1_bias": (("norm",), "ln1_bias"),
    "wq.weight": (("heads", "embed"), "wq"),
    "wq.bias": (("heads",), "bq"),
    "wk.weight": (("kv_heads", "embed"), "wk"),
    "wk.bias": (("kv_heads",), "bk"),
    "wv.weight": (("kv_heads", "embed"), "wv"),
    "wv.bias": (("kv_heads",), "bv"),
    "wo.weight": (("embed", "heads"), "wo"),
    "wo.bias": (("norm",), "bo"),
    "ln2_scale": (("norm",), "ln2_scale"),
    "ln2_bias": (("norm",), "ln2_bias"),
    "w_fc.weight": (("mlp", "embed"), "w_fc"),
    "w_fc.bias": (("mlp",), "b_fc"),
    "w_proj.weight": (("embed", "mlp"), "w_proj"),
    "w_proj.bias": (("norm",), "b_proj"),
}


def param_axes(cfg: GPTConfig) -> Dict[str, Tuple]:
    """Logical axes of every parameter, keyed by the port's names and in
    the port's dimension order: the JAX ``param_axes`` without the
    stacked ``"layers"`` axis, reversed for every ``nn.Linear`` weight."""
    axes = {"embed": ("vocab", "embed"), "pos_embed": (None, "embed"),
            "final_ln_scale": ("norm",), "final_ln_bias": ("norm",)}
    if not cfg.tie_lm_head:
        axes["lm_head.weight"] = ("vocab", "embed")
    for i in range(cfg.num_layers):
        for name, (ax, _) in _BLOCK.items():
            axes[f"blocks.{i}.{name}"] = ax
    return axes


def jax_coordinates(cfg: GPTConfig, name: str) -> JaxLeaf:
    """The JAX leaf a port parameter comes from (``params_from_jax``'s
    mapping): blocks are layer ``i`` of a stacked leaf, matrices are
    transposed, each bias its own leaf."""
    h, m, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    if name == "embed":
        return JaxLeaf(("embed",), (v, h), None, (0, 1))
    if name == "pos_embed":
        return JaxLeaf(("pos_embed",), (cfg.max_seq_len, h), None, (0, 1))
    if name in ("final_ln_scale", "final_ln_bias"):
        return JaxLeaf((name,), (h,), None, (0,))
    if name == "lm_head.weight":
        return JaxLeaf(("lm_head",), (h, v), None, (1, 0))
    _, layer, key = name.split(".", 2)
    leaf = _BLOCK[key][1]
    L = cfg.num_layers
    mats = {"wq": (h, q), "wk": (h, kv), "wv": (h, kv), "wo": (q, h),
            "w_fc": (h, m), "w_proj": (m, h)}
    if leaf in mats:
        return JaxLeaf(("blocks", leaf), (L,) + mats[leaf], int(layer),
                       (2, 1))
    vecs = {"bq": q, "bk": kv, "bv": kv, "b_fc": m}
    return JaxLeaf(("blocks", leaf), (L, vecs.get(leaf, h)), int(layer),
                   (1,))
