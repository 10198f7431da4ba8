"""Sharding strategies as logical-axis rules.

Counterpart of ``dlrover_tpu/parallel/sharding.py``, whose pure-Python
part -- the rule tables, ``STRATEGIES``, the ZeRO optimizer-state and
gradient rules and ``spec_for_axes`` -- is copied here with its
semantics: a rule maps a *logical* array axis ("embed", "mlp", "heads",
"vocab", "batch", ...) to a mesh axis, a tuple of mesh axes, or None
(replicated); mesh axes that are absent or of size 1 degrade to
replication, so one table serves every mesh shape; and a mesh axis is
used at most once per tensor, the first logical axis winning it.

Where the JAX package hands the resulting ``PartitionSpec`` to XLA, the
port's ``trainer/sharded.py`` carries each strategy out by hand over the
mesh's process groups. ``spec_for_axes`` returns the spec's content: a
tuple with one entry per tensor dimension (a mesh axis, a tuple of
them, or None). :func:`placements` turns it into DTensor placements on a
``DeviceMesh``, :func:`local_slices` into the index box a rank holds.

Logical axis conventions, as in the JAX package:
  batch, seq, embed, mlp, heads, kv_heads, head_dim (never sharded),
  vocab, expert, layers (the JAX model's stacked layer dim; the port's
  blocks are not stacked: under "pipeline" a stage holds its own blocks,
  ``parallel/pipeline.py``), norm.
"""

from typing import Dict, List, Optional, Sequence, Tuple, Union

from dlrover_tpu_torch.parallel.mesh import (
    DATA_AXIS, EXPERT_AXIS, FSDP_AXIS, PIPE_AXIS, SEQ_AXIS, TENSOR_AXIS,
    Mesh, axis_index, axis_names, axis_size,
)

# a rule maps logical axis name -> mesh axis (str), tuple of mesh axes,
# or None (replicated)
Rules = Dict[str, Union[str, Tuple[str, ...], None]]
#: one entry per tensor dimension: a mesh axis, a tuple of them, or None
Spec = Tuple[Union[str, Tuple[str, ...], None], ...]

# ---------------------------------------------------------------------------
# strategy rule tables (the JAX package's, entry for entry)


def ddp_rules() -> Rules:
    """Pure data parallelism: params replicated, batch sharded."""
    return {"batch": (DATA_AXIS, FSDP_AXIS)}


def fsdp_rules() -> Rules:
    """ZeRO-3: every param's shardable dims over fsdp (the first logical
    axis wins the mesh axis); batch over data+fsdp."""
    return {
        "batch": (DATA_AXIS, FSDP_AXIS),
        "embed": FSDP_AXIS,
        "vocab": FSDP_AXIS,
        "mlp": FSDP_AXIS,
        "heads": FSDP_AXIS,
        "kv_heads": FSDP_AXIS,
        "expert": FSDP_AXIS,
    }


def tp_rules() -> Rules:
    """Megatron TP: column-parallel on mlp/heads, row-parallel from the
    matching contraction; vocab-parallel embedding."""
    return {
        "batch": (DATA_AXIS, FSDP_AXIS),
        "mlp": TENSOR_AXIS,
        "heads": TENSOR_AXIS,
        "kv_heads": TENSOR_AXIS,
        "vocab": TENSOR_AXIS,
    }


def tp_fsdp_rules() -> Rules:
    """3D: fsdp shards the embed dim, tensor shards mlp/heads/vocab."""
    return {
        "batch": (DATA_AXIS, FSDP_AXIS),
        "embed": FSDP_AXIS,
        "mlp": TENSOR_AXIS,
        "heads": TENSOR_AXIS,
        "kv_heads": TENSOR_AXIS,
        "vocab": TENSOR_AXIS,
        "expert": EXPERT_AXIS,
    }


def sequence_rules() -> Rules:
    """Long-context: activations' seq dim over the seq axis."""
    r = tp_fsdp_rules()
    r["seq"] = SEQ_AXIS
    return r


def pipeline_rules() -> Rules:
    """Pipelining: the stacked layer dim over the pipe axis."""
    r = tp_fsdp_rules()
    r["layers"] = PIPE_AXIS
    return r


def zero1_rules() -> Rules:
    """ZeRO-1: params and grads replicated like DDP, the optimizer state
    sharded over fsdp (``opt_state_rules``)."""
    return {"batch": (DATA_AXIS, FSDP_AXIS)}


def zero2_rules() -> Rules:
    """ZeRO-2: ZeRO-1 plus the gradient (and its accumulation buffer)
    held in the fsdp layout (``grad_rules``)."""
    return {"batch": (DATA_AXIS, FSDP_AXIS)}


def rowwise_rules() -> Rules:
    """Sparse-embedding layout: table rows over fsdp, batch over data
    only."""
    return {
        "batch": DATA_AXIS,
        "vocab": FSDP_AXIS,
    }


STRATEGIES = {
    "ddp": ddp_rules,
    "zero1": zero1_rules,
    "zero2": zero2_rules,
    "fsdp": fsdp_rules,
    "tp": tp_rules,
    "tp_fsdp": tp_fsdp_rules,
    "sequence": sequence_rules,
    "pipeline": pipeline_rules,
    "rowwise": rowwise_rules,
}

#: what ``trainer/sharded.py`` cannot run yet, and the queue item that
#: brings it (ROADMAP.md, queue A)
NOT_PORTED: Dict[str, str] = {}

# the ZeRO optimizer state: every param logical axis over fsdp
_ZERO_OPT_RULES = {
    "embed": FSDP_AXIS,
    "vocab": FSDP_AXIS,
    "mlp": FSDP_AXIS,
    "heads": FSDP_AXIS,
    "kv_heads": FSDP_AXIS,
    "expert": FSDP_AXIS,
}


def opt_state_rules(strategy: str) -> Optional[Rules]:
    """Rule table for optimizer-state sharding when it differs from the
    param layout (ZeRO-1/2); None means "mirror the params"."""
    if strategy in ("zero1", "zero2"):
        return dict(_ZERO_OPT_RULES)
    return None


def grad_rules(strategy: str) -> Optional[Rules]:
    """Rule table constraining the gradient layout (ZeRO-2); None leaves
    it to the strategy."""
    if strategy == "zero2":
        return dict(_ZERO_OPT_RULES)
    return None


def get_rules(strategy: str) -> Rules:
    if strategy not in STRATEGIES:
        raise ValueError(
            f"Unknown strategy {strategy!r}; one of {sorted(STRATEGIES)}"
        )
    return STRATEGIES[strategy]()


# ---------------------------------------------------------------------------
# applying rules


def spec_for_axes(
    logical_axes: Tuple[Optional[str], ...],
    rules: Rules,
    mesh: Optional[Mesh] = None,
) -> Spec:
    """One entry per tensor dimension: the mesh axis (or tuple of them)
    its logical axis maps to, or None. Mesh axes absent from the mesh or
    of size 1 degrade to replication; a mesh axis is used at most once,
    the first logical axis winning it. The JAX ``PartitionSpec``'s
    content, with its trailing Nones kept."""
    used = set()
    parts: List = []
    for ax in logical_axes:
        rule = rules.get(ax) if ax is not None else None
        if rule is None:
            parts.append(None)
            continue
        mesh_axes = (rule,) if isinstance(rule, str) else tuple(rule)
        if mesh is not None:
            mesh_axes = tuple(
                m for m in mesh_axes
                if m in axis_names(mesh) and axis_size(mesh, m) > 1
            )
        mesh_axes = tuple(m for m in mesh_axes if m not in used)
        used.update(mesh_axes)
        if not mesh_axes:
            parts.append(None)
        elif len(mesh_axes) == 1:
            parts.append(mesh_axes[0])
        else:
            parts.append(mesh_axes)
    return tuple(parts)


def spec_in_order(logical_axes: Tuple[Optional[str], ...],
                  order: Sequence[int], rules: Rules,
                  mesh: Optional[Mesh] = None) -> Spec:
    """:func:`spec_for_axes` of a tensor whose dims sit in another order
    than the reference's: ``order[d]`` is dim ``d``'s place in the
    reference (the JAX leaf's dims, ``models/llama.py``'s
    ``JaxLeaf.dims``). The first logical axis *in the reference's order*
    wins a mesh axis -- JAX's ``wq`` is ``(embed, heads)``, so fsdp
    shards its embed dim, the port's dim 1 -- and the spec comes back in
    the tensor's own order."""
    ranked = sorted(range(len(logical_axes)), key=lambda d: order[d])
    spec = spec_for_axes(tuple(logical_axes[d] for d in ranked), rules,
                         mesh)
    out: List = [None] * len(logical_axes)
    for i, d in enumerate(ranked):
        out[d] = spec[i]
    return tuple(out)


def spec_axes(entry) -> Tuple[str, ...]:
    """A spec entry as a tuple of mesh axes (() for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh: Mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh
    dimension, ``Shard(d)`` for the tensor dim it shards, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in axis_names(mesh):
        dims = [d for d, e in enumerate(spec) if name in spec_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def local_slices(spec: Spec, shape: Sequence[int], mesh: Mesh,
                 coord: Optional[Dict[str, int]] = None
                 ) -> List[Tuple[int, int]]:
    """The ``[start, end)`` a rank holds of each tensor dim under
    ``spec`` (this rank, or the rank at the mesh coordinate ``coord``,
    axis name -> index): a dim sharded over several axes is split over
    them major to minor. A dim that does not divide is split as GSPMD
    pads it: blocks of ``ceil(n / parts)``, the last ones short or
    empty."""
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        parts, idx = 1, 0
        for a in spec_axes(entry):
            size = axis_size(mesh, a)
            at = axis_index(mesh, a) if coord is None else coord[a]
            idx = idx * size + at
            parts *= size
        out.append(block(n, parts, idx))
    return out


def block(n: int, parts: int, idx: int) -> Tuple[int, int]:
    """``[start, end)`` of part ``idx`` of a dim of ``n`` split over
    ``parts`` ranks in blocks of ``ceil(n / parts)`` (GSPMD's padded
    split: only the last parts may be short, or empty)."""
    step = -(-n // parts)
    return min(idx * step, n), min((idx + 1) * step, n)


def global_boxes(spec: Spec, shape: Sequence[int], mesh: Mesh,
                 where: Optional[Dict[str, int]] = None
                 ) -> List[Tuple[List[Tuple[int, int]], List[int]]]:
    """Every distinct box of a tensor under ``spec`` over the whole mesh
    (or over the ranks at the coordinates ``where``, axis name -> index:
    a pipeline stage's), with the ranks that hold it, in rank order:
    ``[(box, ranks)]``."""
    import numpy as np

    names = axis_names(mesh)
    ranks = mesh.mesh.cpu().numpy() if names else np.zeros((), np.int64)
    boxes: Dict[Tuple, List[int]] = {}
    for at in np.ndindex(*ranks.shape):
        coord = dict(zip(names, at))
        if any(coord.get(a, 0) != i for a, i in (where or {}).items()):
            continue
        box = tuple(local_slices(spec, shape, mesh, coord=coord))
        boxes.setdefault(box, []).append(int(ranks[at]))
    return sorted(((list(b), sorted(r)) for b, r in boxes.items()),
                  key=lambda br: br[1][0])
