"""Sparse-embedding recommender family (DLRM / Wide&Deep), in PyTorch.

Counterpart of ``dlrover_tpu/models/dlrm.py``, the CRITEO click model:
13 dense features through a bottom MLP, 26 categorical features looked
up in ONE stacked table ``[padded_vocab, d]`` (per-feature row offsets,
``parallel/embedding.py``), a dot interaction of the embeddings and the
dense latent (or their concatenation), a top MLP and a click logit, plus
the wide part: a second stacked table of width 1 whose looked-up rows
sum, in fp32, into the logit. Ids are clipped into each feature's own
vocabulary before the offsets are added. The loss is the stable sigmoid
cross-entropy with label -1 masked out (tail-shard padding). The table
gradients are dense, as the JAX package's are, and the trainer's
default optimizer is ``adagrad(0.05)`` under the "rowwise" strategy on
the JAX default mesh ``[(data, 1), (fsdp, world)]``: both tables' rows
split over fsdp, each rank holding and stepping its own block, the
lookups vocab-parallel (``parallel/embedding.py``), every rank stepping
the whole batch, the MLPs replicated. A rank draws only its own rows:
the table's initial values come in blocks of ``ROW_BLOCK`` rows, each
from a generator seeded with the seed and the block, so a table sharded
over any number of ranks holds the same values as a whole one.
"""

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dlrover_tpu_torch.auto.device_context import resolve_device
from dlrover_tpu_torch.models.llama import JaxLeaf, _tensor
from dlrover_tpu_torch.parallel.embedding import (
    feature_offsets,
    stack_ids,
    vocab_parallel_lookup,
)

#: per-feature vocabulary sizes of the CRITEO categorical columns C1..C26
CRITEO_VOCAB_SIZES = (
    1036, 530, 169550, 71524, 241, 15, 10025, 458, 3, 22960, 4469,
    144780, 3034, 26, 7577, 113860, 10, 3440, 1678, 3, 130892, 11, 14,
    27189, 65, 20188,
)
CRITEO_DENSE = 13  # I1..I13
#: rows per seeded block of the table's initial values
ROW_BLOCK = 65536


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    vocab_sizes: Tuple[int, ...] = CRITEO_VOCAB_SIZES
    dense_dim: int = CRITEO_DENSE
    embed_dim: int = 16
    bottom_mlp: Tuple[int, ...] = (64, 16)
    top_mlp: Tuple[int, ...] = (64, 32)
    interaction: str = "dot"  # "dot" | "concat"
    dtype: torch.dtype = torch.float32
    #: table rows are padded up to a multiple of this, so the row dim
    #: divides any plausible shard count (ids never reach the padding)
    row_align: int = 1024

    def __post_init__(self):
        if self.interaction == "dot" and self.bottom_mlp and (
            self.bottom_mlp[-1] != self.embed_dim
        ):
            raise ValueError(
                f"dot interaction needs bottom_mlp[-1] == embed_dim "
                f"({self.bottom_mlp[-1]} != {self.embed_dim}): the "
                "dense latent joins the pairwise dot with the embeddings"
            )

    @property
    def total_vocab(self) -> int:
        return int(sum(self.vocab_sizes))

    @property
    def padded_vocab(self) -> int:
        a = max(1, self.row_align)
        return (self.total_vocab + a - 1) // a * a

    @property
    def num_features(self) -> int:
        return len(self.vocab_sizes)

    # -- the models contract's names (the auto layer reads them) ------
    @property
    def hidden_size(self) -> int:
        return self.embed_dim

    @property
    def num_layers(self) -> int:
        return len(self.bottom_mlp) + len(self.top_mlp)

    @property
    def vocab_size(self) -> int:
        return self.total_vocab


def criteo_wide_deep(**kw) -> DLRMConfig:
    """The reference workload's shape: dim-8 deep embeddings and the
    wide linear part."""
    kw.setdefault("embed_dim", 8)
    kw.setdefault("bottom_mlp", (16, 8))
    kw.setdefault("top_mlp", (16, 4))
    return DLRMConfig(**kw)


def dlrm_large(total_vocab: int = 400_000_000, embed_dim: int = 32,
               **kw) -> DLRMConfig:
    """A production-recommender scale point: the stacked fp32 tables
    take ``table_bytes`` (52.8 GB at the defaults, 51.2 GB of it the
    deep table), and with the gradient and Adagrad's accumulators more
    than one card holds: the "rowwise" strategy splits the tables' rows
    over the ranks."""
    n = 26
    base = total_vocab // n
    sizes = tuple(
        base + (total_vocab - base * n if i == n - 1 else 0)
        for i in range(n)
    )
    kw.setdefault("bottom_mlp", (64, embed_dim))
    return DLRMConfig(vocab_sizes=sizes, embed_dim=embed_dim, **kw)


def _interaction_dim(cfg: DLRMConfig, bot_out: int) -> int:
    f = cfg.num_features + 1  # +1: the dense latent joins the dot
    if cfg.interaction == "dot":
        return f * (f - 1) // 2 + bot_out
    return cfg.num_features * cfg.embed_dim + bot_out


def _widths(cfg: DLRMConfig):
    """(bottom MLP (in, out) pairs, top MLP pairs, the head's input)."""
    bottom, d = [], cfg.dense_dim
    for w in cfg.bottom_mlp:
        bottom.append((d, w))
        d = w
    top, t = [], _interaction_dim(cfg, d)
    for w in cfg.top_mlp:
        top.append((t, w))
        t = w
    return bottom, top, t


def param_count(cfg: DLRMConfig) -> int:
    bottom, top, t = _widths(cfg)
    n = cfg.padded_vocab * (cfg.embed_dim + 1)
    n += sum(i * o + o for i, o in bottom + top)
    return n + t + 1


def flops_per_token(cfg: DLRMConfig, seq_len: int = 1) -> float:
    """Forward FLOPs per example: MLPs and the interaction (lookups are
    gathers: bytes, not FLOPs), the JAX package's formula."""
    bottom, top, t = _widths(cfg)
    n = sum(2.0 * i * o for i, o in bottom + top)
    if cfg.interaction == "dot":
        f = cfg.num_features + 1
        n += 2.0 * f * f * cfg.embed_dim
    return n + 2.0 * t


def table_bytes(cfg: DLRMConfig) -> int:
    """The fp32 stacked tables' bytes with the alignment padding (the
    capacity-planning number)."""
    return 4 * cfg.padded_vocab * (cfg.embed_dim + 1)


class DLRM(nn.Module):
    """The recommender. Its parameters are left uninitialized:
    ``init_params`` draws them, ``params_from_jax`` loads them. ``rows``
    (start, end) makes both tables hold only those rows of the stacked
    table: a rank's block under the "rowwise" strategy."""

    def __init__(self, cfg: DLRMConfig, device=None,
                 rows: Optional[Tuple[int, int]] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        bottom, top, t = _widths(cfg)
        self.rows = tuple(rows) if rows is not None else (0, cfg.padded_vocab)
        v = self.rows[1] - self.rows[0]
        self.table = nn.Parameter(torch.empty(
            v, cfg.embed_dim, device=device, dtype=torch.float32))
        self.wide = nn.Parameter(torch.empty(
            v, 1, device=device, dtype=torch.float32))

        def mlp(pairs):
            return nn.ModuleList(
                nn.Linear(i, o, device=device, dtype=cfg.dtype)
                for i, o in pairs)

        self.bottom = mlp(bottom)
        self.top = mlp(top)
        self.head = nn.Linear(t, 1, device=device, dtype=cfg.dtype)
        self.register_buffer(
            "offsets", feature_offsets(cfg.vocab_sizes, device),
            persistent=False)
        self.register_buffer(
            "sizes", torch.tensor(cfg.vocab_sizes, dtype=torch.int32,
                                  device=device), persistent=False)

    @staticmethod
    def _mlp(layers, x):
        for layer in layers:
            x = F.relu(layer(x))
        return x

    def forward(self, dense: torch.Tensor, cat_ids: torch.Tensor,
                mesh=None) -> torch.Tensor:
        """dense [b, dense_dim] fp32, cat_ids [b, features] int
        per-feature indices -> fp32 click logits [b]. ``mesh``: the
        mesh whose fsdp axis splits the tables' rows (the trainer's,
        under "rowwise"); every rank of that axis passes the same
        batch."""
        cfg = self.cfg
        # clip into each feature's own vocabulary: an out-of-range id
        # must not read a neighbouring feature's rows
        ids = torch.minimum(cat_ids.clamp(min=0), self.sizes[None, :] - 1)
        rows = stack_ids(ids.to(self.offsets.dtype), self.offsets)
        mesh_kw = {} if mesh is None else {"mesh": mesh}
        emb = vocab_parallel_lookup(self.table, rows, **mesh_kw)  # [b, F, d]
        wide = vocab_parallel_lookup(self.wide, rows, **mesh_kw)  # [b, F, 1]
        wide_logit = wide[..., 0].float().sum(dim=-1)

        x = self._mlp(self.bottom, dense.to(cfg.dtype))
        if cfg.interaction == "dot":
            lat = torch.cat([emb.to(cfg.dtype), x[:, None, :]], dim=1)
            gram = torch.bmm(lat, lat.transpose(1, 2))  # [b, F+1, F+1]
            f = lat.shape[1]
            iu, ju = torch.triu_indices(f, f, 1, device=lat.device)
            z = torch.cat([gram[:, iu, ju], x], dim=-1)
        else:
            z = torch.cat([emb.reshape(emb.shape[0], -1).to(cfg.dtype), x],
                          dim=-1)
        z = self._mlp(self.top, z)
        return wide_logit + self.head(z).float()[:, 0]


def table_rows(cfg: DLRMConfig, seed: int, lo: int, hi: int,
               device=None) -> torch.Tensor:
    """Rows ``[lo, hi)`` of the table's initial values, U(-1, 1) /
    sqrt(d): each block of ``ROW_BLOCK`` rows from a ``torch.Generator``
    seeded with ``(seed << 32) + block``, so any split of the rows draws
    the same values."""
    device = resolve_device(device)
    d = cfg.embed_dim
    out = torch.empty(hi - lo, d, device=device)
    for b in range(lo // ROW_BLOCK, (hi - 1) // ROW_BLOCK + 1 if hi > lo
                   else 0):
        start, end = b * ROW_BLOCK, min((b + 1) * ROW_BLOCK,
                                        cfg.padded_vocab)
        gen = torch.Generator(device=device).manual_seed((seed << 32) + b)
        block = torch.rand((end - start, d), generator=gen, device=device)
        a, z = max(lo, start), min(hi, end)
        out[a - lo:z - lo] = (block[a - start:z - start] * 2 - 1) / d ** 0.5
    return out


def init_params(cfg: DLRMConfig, seed: int = 0, device=None,
                rows: Optional[Tuple[int, int]] = None) -> DLRM:
    """The JAX package's initial distributions from ``torch.Generator``s
    seeded with ``seed`` (the numbers differ from ``jax.random``'s):
    table rows U(-1, 1) / sqrt(d) (:func:`table_rows`; ``rows``: only
    those), the wide table 0, MLP weights N(0, 2 / fan_in), the head
    N(0, 1 / fan_in), biases 0."""
    model = DLRM(cfg, device, rows=rows)
    dev = model.table.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        model.table.copy_(table_rows(cfg, seed, *model.rows, device=dev))
        model.wide.zero_()
        for layer in [*model.bottom, *model.top, model.head]:
            w = layer.weight  # [out, in]
            gain = 1.0 if layer is model.head else 2.0
            w.copy_(torch.randn(w.shape, generator=gen, device=dev)
                    * (gain / w.shape[1]) ** 0.5)
            layer.bias.zero_()
    return model


def param_axes(cfg: DLRMConfig) -> Dict[str, Tuple]:
    """Logical axes of every parameter, keyed by the port's names and in
    the port's dimension order (the JAX table: both tables row-sharded
    on "vocab", the MLPs replicated)."""
    axes = {"table": ("vocab", None), "wide": ("vocab", None)}
    bottom, top, _ = _widths(cfg)
    names = [f"bottom.{i}" for i in range(len(bottom))]
    names += [f"top.{i}" for i in range(len(top))] + ["head"]
    for name in names:
        axes[f"{name}.weight"] = (None, None)
        axes[f"{name}.bias"] = (None,)
    return axes


def jax_coordinates(cfg: DLRMConfig, name: str) -> JaxLeaf:
    """The JAX leaf a port parameter comes from (``params_from_jax``'s
    mapping): ``bottom.i.weight`` is ``["bottom"][i]["w"]``, transposed."""
    v, d = cfg.padded_vocab, cfg.embed_dim
    if name in ("table", "wide"):
        return JaxLeaf((name,), (v, d if name == "table" else 1), None,
                       (0, 1))
    bottom, top, t = _widths(cfg)
    *layer, kind = name.split(".")
    if layer == ["head"]:
        path, (i, o) = ("head",), (t, 1)
    else:
        part, idx = layer
        path, (i, o) = (part, int(idx)), (bottom if part == "bottom"
                                           else top)[int(idx)]
    if kind == "weight":
        return JaxLeaf(path + ("w",), (i, o), None, (1, 0))
    return JaxLeaf(path + ("b",), (o,), None, (0,))


def loss_sums(model: DLRM, batch, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch = (dense [b, 13], cat_ids [b, 26], labels [b]) -> (the
    summed sigmoid cross-entropy over labels >= 0 (1 click, 0 none, -1
    padding), in its stable form; their count)."""
    dense, cat_ids, labels = batch
    logits = model(dense, cat_ids, mesh=mesh)
    labels = labels.float()
    valid = (labels >= 0).float()
    y = labels.clamp(min=0.0)
    per = logits.clamp(min=0) - logits * y + torch.log1p(
        torch.exp(-logits.abs()))
    return (per * valid).sum(), valid.sum()


def loss(model: DLRM, batch, mesh=None) -> torch.Tensor:
    """The mean sigmoid cross-entropy over labels >= 0 (see
    :func:`loss_sums`)."""
    total, cnt = loss_sums(model, batch, mesh=mesh)
    return total / cnt.clamp(min=1.0)


#: the models contract's name (its "token" is one example)
next_token_loss = loss


def make_trainer(cfg: DLRMConfig, device=None, strategy: str = "rowwise",
                 accum_steps: int = 1, optimizer=None, attn_fn=None,
                 mesh=None, value_and_grad=None):
    """Trainer for DLRM under ``adagrad(0.05)`` by default, the
    recommender's optimizer (per-row adaptive steps, no momentum
    doubling the table); ``device=None`` is the GPU. ``mesh=None`` is
    the JAX default mesh, ``[(data, 1), (fsdp, world)]`` over the
    process group's ranks. Under "rowwise" each rank draws only its own
    rows of the tables and the lookups run over the mesh."""
    from dlrover_tpu_torch.parallel import sharding as shd
    from dlrover_tpu_torch.parallel.mesh import create_mesh
    from dlrover_tpu_torch.trainer.sharded import adagrad, family_trainer

    if mesh is None:
        mesh = create_mesh([("data", 1), ("fsdp", -1)], device=device)
    rowwise = strategy == "rowwise"
    lookup_mesh = mesh if rowwise else None

    def init(seed, dev):
        rows = None
        if rowwise:
            spec = shd.spec_for_axes(("vocab", None), shd.get_rules(strategy),
                                     mesh)
            rows = shd.local_slices(spec, (cfg.padded_vocab, 1), mesh)[0]
        return init_params(cfg, seed=seed, device=dev, rows=rows)

    return family_trainer(
        cfg, lambda model, batch: loss_sums(model, batch, mesh=lookup_mesh),
        init, param_count(cfg), device=device, strategy=strategy,
        accum_steps=accum_steps, optimizer=optimizer or adagrad(0.05),
        mesh=mesh, param_axes=lambda model: param_axes(cfg),
        jax_coordinates=lambda name: jax_coordinates(cfg, name),
        value_and_grad=value_and_grad,
        # the sharded lookup consumes the tables' rows over fsdp under
        # "rowwise"; every other sharded dim is gathered before use
        held_axes=lambda rules: {("vocab", "fsdp")} if rowwise else set())


def example_batch(cfg: DLRMConfig, global_batch: int, seq_len: int = 1):
    """Zero-filled (dense, cat_ids, labels)."""
    dense = np.zeros((global_batch, cfg.dense_dim), np.float32)
    cat = np.zeros((global_batch, cfg.num_features), np.int32)
    return dense, cat, np.zeros((global_batch,), np.int32)


def params_from_jax(np_tree: Dict, cfg: DLRMConfig, device=None) -> DLRM:
    """The port's model holding the JAX model's weights (``[in, out]``
    matrices transposed)."""
    state = {"table": _tensor(np_tree["table"]),
             "wide": _tensor(np_tree["wide"])}
    layers = [(f"{part}.{i}", layer)
              for part in ("bottom", "top")
              for i, layer in enumerate(np_tree[part])]
    layers.append(("head", np_tree["head"]))
    for name, layer in layers:
        state[f"{name}.weight"] = _tensor(layer["w"]).T
        state[f"{name}.bias"] = _tensor(layer["b"])
    model = DLRM(cfg, device)
    model.load_state_dict(state)
    return model
