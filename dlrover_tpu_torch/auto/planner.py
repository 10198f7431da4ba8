"""Shard planner: synthesize a sharding rule table for a mesh.

Counterpart of ``dlrover_tpu/auto/planner.py``: a placement is an
assignment of LOGICAL array axes to mesh axes, so the whole search space
is the set of rule tables (``parallel/sharding.py``). The planner scores
every assignment with the same memory/comm model the candidate ranker
uses and returns the argmin. Feasibility is checked per parameter leaf
against the JAX model's leaves -- the port's ``jax_coordinates`` give
each parameter's JAX leaf, shape and logical axes, so the port plans
over exactly JAX's leaves -- by the divisibility of each dim by its mesh
axis. A planned table registered in ``sharding.STRATEGIES`` trains under
``trainer/sharded.py``, which gathers every planned dim before use
except the model's own held layout (``models/llama.py``'s
``held_axes``); a sharded ``layers`` axis makes each rank own its layers
whole. The link rate and the collective latency are the card's.
"""

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

from dlrover_tpu_torch.auto import analyser
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.parallel.sharding import Rules

#: logical axes the planner may shard (activation axes "batch"/"seq"
#: are owned by the data/context-parallel layers, not planned here)
PLANNABLE_AXES = (
    "embed", "mlp", "heads", "kv_heads", "vocab", "expert", "layers",
)
#: tensor-style mesh axes whose sharding of a contraction dim implies
#: per-layer activation collectives
_ACT_COLLECTIVE_AXES = ("mlp", "heads", "kv_heads")
#: per-collective dispatch/latency cost (seconds) -- what makes many
#: small gathers lose to one fused all-reduce for models that fit: the
#: median of a 4-byte all-reduce of two gloo ranks on one NVIDIA H100
#: 80GB HBM3 at 700 W, the port's collective path there, measured by
#: ``python -m dlrover_tpu_torch.auto.probe`` (PERF.md). A module
#: constant that tests may set.
_COLLECTIVE_LATENCY = 1.1458e-3
#: fraction of HBM a plan may use: temp buffers and fragmentation need
#: headroom beyond params+opt+grad+activations (the JAX package's factor)
HBM_UTILIZATION = 0.8
#: a parameter leaf: (logical axes, JAX shape, bytes)
LeafInfo = Tuple[Tuple[Optional[str], ...], Tuple[int, ...], int]


@dataclasses.dataclass
class PlanReport:
    rules: Rules
    memory_bytes: float  # est. per-device params+opt+grad
    comm_seconds: float  # est. per-step collective time
    score: float


def leaf_infos(cfg) -> List[LeafInfo]:
    """``[(logical_axes, shape, bytes)]`` per leaf of the JAX parameter
    tree of ``cfg``, in the JAX tree's flattening order (sorted keys),
    from the port's ``param_axes`` and ``jax_coordinates`` and a model
    built on the meta device (its dtypes; nothing is allocated)."""
    from dlrover_tpu_torch.models import meta_model, model_module_for

    mod = model_module_for(cfg)
    axes = mod.param_axes(cfg)
    leaves: Dict[Tuple[str, ...], LeafInfo] = {}
    for name, p in meta_model(cfg).named_parameters():
        leaf = mod.jax_coordinates(cfg, name)
        if leaf.path in leaves:
            continue
        jax_axes: List[Optional[str]] = [None] * len(leaf.shape)
        if leaf.layer is not None:
            jax_axes[0] = "layers"
        for d, ax in enumerate(axes[name]):
            jax_axes[leaf.dims[d]] = ax
        leaves[leaf.path] = (tuple(jax_axes), tuple(leaf.shape),
                             math.prod(leaf.shape) * p.element_size())
    return [leaves[k] for k in sorted(leaves)]


def _feasible(assign: Dict[str, Optional[str]], leaf_infos,
              mesh_sizes: Dict[str, int]) -> bool:
    for axes, shape, _ in leaf_infos:
        used = set()
        for dim, ax in zip(shape, axes):
            mesh_ax = assign.get(ax) if ax else None
            if mesh_ax is None:
                continue
            if mesh_ax in used:
                continue  # spec_for_axes dedups: effectively unsharded
            used.add(mesh_ax)
            if dim % mesh_sizes[mesh_ax]:
                return False
    return True


def _score(assign, leaf_infos, mesh_sizes, *, tokens_per_step,
           hidden_size, num_layers, link_bandwidth, has_dp,
           state_bytes_multiplier):
    """(memory, comm) of one assignment -- same physics as
    auto/analyser.py, applied per leaf."""
    mem = 0.0
    comm = 0.0
    n_sharded_leaves = 0
    for axes, shape, nbytes in leaf_infos:
        shard = 1
        used = set()
        for ax in axes:
            mesh_ax = assign.get(ax) if ax else None
            if mesh_ax is None or mesh_ax in used:
                continue
            used.add(mesh_ax)
            shard *= mesh_sizes[mesh_ax]
        mem += nbytes / shard * state_bytes_multiplier
        # grad sync moves ~2x the full param volume through each link
        # per step either way: ring all-gather + reduce-scatter when
        # sharded, ring all-reduce when replicated under DP — the
        # bandwidth term is near-constant across assignments; what
        # differs is per-collective dispatch latency (below) and memory
        if shard > 1:
            n_sharded_leaves += 1
            comm += 2.0 * nbytes / link_bandwidth
        elif has_dp:
            comm += 2.0 * nbytes / link_bandwidth
    # dispatch latency: sharded leaves pay a gather + a scatter each
    # per step; replicated grads ride ONE fused all-reduce — this is
    # why DDP beats FSDP when everything fits
    comm += _COLLECTIVE_LATENCY * (
        2 * n_sharded_leaves + (1 if has_dp else 0)
    )
    # ... plus per-layer activation collectives when contraction dims
    # are tensor-sharded (the Megatron f/g ops)
    act_axes = {
        assign.get(a) for a in _ACT_COLLECTIVE_AXES if assign.get(a)
    }
    for mesh_ax in act_axes:
        comm += (
            4.0 * num_layers * tokens_per_step * hidden_size * 2
        ) / (link_bandwidth * mesh_sizes[mesh_ax])
    return mem, comm


def plan_rules(
    infos: Sequence[LeafInfo],
    mesh_sizes: Dict[str, int],
    hbm_bytes: float,
    tokens_per_step: int,
    hidden_size: int,
    num_layers: int,
    act_bytes_per_token: float = 24.0,
    link_bandwidth: Optional[float] = None,
    batch_axes: Optional[Tuple[str, ...]] = None,
    state_bytes_multiplier: float = 4.0,
) -> PlanReport:
    """Pick the cheapest feasible logical->mesh assignment.

    ``mesh_sizes`` maps shardable mesh axes (e.g. {"fsdp": 4,
    "tensor": 2}) — data/pipe axes are handled by their own layers.
    The batch rule is always data+fsdp (activations shard over them):
    since the mesh's ``data`` axis is deliberately NOT in
    ``mesh_sizes`` (it never shards params), callers on a
    data-parallel mesh must pass ``batch_axes`` naming every
    batch-sharding mesh axis; otherwise it defaults to the
    batch-capable axes found in ``mesh_sizes``.
    ``infos`` are :func:`leaf_infos`; ``link_bandwidth`` (bytes/s per
    direction) defaults to the target card's (``analyser.LINK_BANDWIDTH``).
    Raises if nothing fits ``hbm_bytes``.
    """
    if link_bandwidth is None:
        link_bandwidth = analyser.LINK_BANDWIDTH
    if batch_axes is None:
        batch_axes = tuple(
            a for a in ("data", "fsdp") if a in mesh_sizes
        )
    leaf_infos = list(infos)
    param_bytes_total = sum(b for _, _, b in leaf_infos)
    options: List[Optional[str]] = [None] + [
        a for a, s in mesh_sizes.items() if s > 1
    ]
    act_bytes = (
        act_bytes_per_token * tokens_per_step * hidden_size
        * max(num_layers, 1) ** 0.5
    )

    best: Optional[PlanReport] = None
    n_feasible = 0
    for combo in itertools.product(options, repeat=len(PLANNABLE_AXES)):
        assign = dict(zip(PLANNABLE_AXES, combo))
        if not _feasible(assign, leaf_infos, mesh_sizes):
            continue
        mem, comm = _score(
            assign, leaf_infos, mesh_sizes,
            tokens_per_step=tokens_per_step, hidden_size=hidden_size,
            num_layers=num_layers, link_bandwidth=link_bandwidth,
            has_dp=bool(batch_axes),
            state_bytes_multiplier=state_bytes_multiplier,
        )
        total_mem = mem + act_bytes
        if total_mem > hbm_bytes * HBM_UTILIZATION:
            continue
        n_feasible += 1
        # lexicographic-ish: minimize comm (param sync is ~constant
        # across assignments, so activation collectives decide), then
        # lower per-chip memory (headroom), then fewer sharded axes
        sharded_axes = sum(1 for v in assign.values() if v)
        score = comm + 1e-15 * total_mem + 1e-9 * sharded_axes
        if best is None or score < best.score:
            rules: Rules = {"batch": tuple(batch_axes) or None}
            rules.update({
                ax: mesh_ax for ax, mesh_ax in assign.items()
                if mesh_ax is not None
            })
            best = PlanReport(rules, total_mem, comm, score)
    if best is None:
        raise ValueError(
            f"no feasible sharding plan fits {hbm_bytes / 1e9:.1f} GB "
            f"at {HBM_UTILIZATION:.0%} utilization (params "
            f"{param_bytes_total / 1e9:.1f} GB, mesh {mesh_sizes})"
        )
    logger.info(
        "Planned rules over %d feasible assignments: %s "
        "(mem %.2f GB, comm %.2f ms)", n_feasible, best.rules,
        best.memory_bytes / 1e9, best.comm_seconds * 1e3,
    )
    return best


def _mesh_shape(mesh) -> List[Tuple[str, int]]:
    """``[(axis, size)]`` of a port mesh, or of a mesh shape given as
    such pairs."""
    from dlrover_tpu_torch.parallel.mesh import axis_names, axis_size

    if isinstance(mesh, (list, tuple)):
        return [(str(a), int(k)) for a, k in mesh]
    return [(a, axis_size(mesh, a)) for a in axis_names(mesh)]


def plan_rules_for_llama(cfg, mesh, global_batch: int, seq_len: int,
                         hbm_bytes: float,
                         state_bytes_multiplier: float = 4.0,
                         link_bandwidth: Optional[float] = None
                         ) -> PlanReport:
    """:func:`plan_rules` over the leaves of ``cfg`` (the flagship's, or
    any family's with ``jax_coordinates``) on ``mesh``: the port's mesh,
    or its shape as ``[(axis, size)]``."""
    shape = _mesh_shape(mesh)
    sizes = dict(shape)
    mesh_sizes = {
        name: k for name, k in shape
        if name in ("fsdp", "tensor", "expert") and k > 1
    }
    dp = 1
    for name in ("data", "fsdp"):
        dp *= sizes.get(name, 1)
    return plan_rules(
        leaf_infos(cfg), mesh_sizes, hbm_bytes,
        tokens_per_step=max(1, global_batch // max(dp, 1)) * seq_len,
        hidden_size=cfg.hidden_size, num_layers=cfg.num_layers,
        link_bandwidth=link_bandwidth,
        batch_axes=tuple(
            a for a in ("data", "fsdp") if sizes.get(a, 1) > 1
        ),
        state_bytes_multiplier=state_bytes_multiplier,
    )


def register_plan(name: str, report: PlanReport) -> None:
    """Register a planned table as a strategy (``sharding.STRATEGIES``),
    under which ``models.make_trainer_for`` then builds trainers."""
    from dlrover_tpu_torch.parallel import sharding

    rules = dict(report.rules)
    sharding.STRATEGIES[name] = lambda: dict(rules)
