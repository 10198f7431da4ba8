"""Named-dimension device mesh over the ranks of the process group.

Counterpart of ``dlrover_tpu/parallel/mesh.py``. The JAX package builds
one ``jax.sharding.Mesh`` whose named axes carry every parallelism
dimension; here the same ``[(name, size), ...]`` spec builds a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
initialized process group, with ``mesh_dim_names``. The ranks are laid
out as the JAX package lays out CPU devices: a plain row-major reshape,
so the RIGHTMOST axis varies fastest over adjacent ranks, and the ranks
of one host (``trainer/distributed.py``: ``process_id x local_world +
local_rank``) are adjacent. Each axis gets a process group of its own,
made here with the collective timeout of the default group
(``DLROVER_TPU_DIST_HEARTBEAT_TIMEOUT``), and :func:`axes_group` makes
one over several axes (the data-parallel ranks of ``batch_axes``).

A process without a process group gets a :class:`SingleRankMesh`: the
same axis names, every axis of size 1, no groups. A DeviceMesh needs an
initialized group, and one process forms none (``init_from_env``).
"""

import datetime
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from dlrover_tpu_torch.common.log import default_logger as logger

# canonical axis names, outermost -> innermost
DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
PIPE_AXIS = "pipe"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
TENSOR_AXIS = "tensor"

CANONICAL_ORDER = (DATA_AXIS, PIPE_AXIS, FSDP_AXIS, EXPERT_AXIS,
                   SEQ_AXIS, TENSOR_AXIS)


def resolve_mesh_shape(
    spec: Sequence[Tuple[str, int]], num_devices: int
) -> List[Tuple[str, int]]:
    """Resolve a ``[(name, size)]`` spec against the rank count.

    At most one size may be -1 (inferred). The product must equal
    ``num_devices``. The JAX package's function, with its errors."""
    sizes = [s for _, s in spec]
    n_infer = sum(1 for s in sizes if s == -1)
    if n_infer > 1:
        raise ValueError(f"At most one inferred (-1) dim: {spec}")
    fixed = 1
    for s in sizes:
        if s != -1:
            if s <= 0:
                raise ValueError(f"Invalid dim size in {spec}")
            fixed *= s
    if n_infer:
        if num_devices % fixed != 0:
            raise ValueError(
                f"{num_devices} devices not divisible by {fixed} ({spec})"
            )
        inferred = num_devices // fixed
        spec = [
            (name, inferred if s == -1 else s) for name, s in spec
        ]
    else:
        if fixed != num_devices:
            raise ValueError(
                f"Mesh {spec} needs {fixed} devices, have {num_devices}"
            )
    return list(spec)


class SingleRankMesh:
    """The mesh of a process without a process group: the spec's axis
    names, each of size 1. It answers the few questions this package
    asks a mesh (``mesh_dim_names``, ``size``, ``get_coordinate``,
    ``mesh``)."""

    def __init__(self, names: Sequence[str]):
        self.mesh_dim_names = tuple(names)
        self.mesh = torch.zeros([1] * len(self.mesh_dim_names),
                                dtype=torch.int64)

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return 1

    def get_coordinate(self) -> List[int]:
        return [0] * len(self.mesh_dim_names)

    def __repr__(self) -> str:
        return f"SingleRankMesh({self.mesh_dim_names})"


Mesh = Union[DeviceMesh, SingleRankMesh]

#: (mesh rank layout, axis names, axes) -> this rank's group over the axes
_GROUPS: Dict[Tuple, object] = {}


def clear_groups() -> None:
    """Forget every cached group: the process group they came from is
    gone (``trainer/distributed.reform_world``)."""
    _GROUPS.clear()


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def _device_type(device) -> str:
    from dlrover_tpu_torch.auto.device_context import resolve_device

    return resolve_device(device).type


def _group_timeout() -> datetime.timedelta:
    from dlrover_tpu_torch.trainer.distributed import heartbeat_timeout_s

    return datetime.timedelta(seconds=heartbeat_timeout_s())


def _subgroups(ranks: np.ndarray, dims: Sequence[int]):
    """This rank's group over the mesh dims ``dims``: every rank calls
    ``new_group`` for every slice, in the same order."""
    me = dist.get_rank()
    moved = np.moveaxis(ranks, list(dims), list(range(-len(dims), 0)))
    slices = moved.reshape(-1, int(np.prod([ranks.shape[d] for d in dims])))
    if len(slices) == 1 and slices.shape[1] == dist.get_world_size():
        return dist.group.WORLD  # every rank: the default group
    mine = None
    for row in slices:
        group = dist.new_group([int(r) for r in row],
                               timeout=_group_timeout())
        if me in row:
            mine = group
    return mine


def _build(names: Tuple[str, ...], shape: Tuple[int, ...],
           device_type: str) -> Mesh:
    if not _grouped():
        if int(np.prod(shape)) != 1:
            raise ValueError(
                f"mesh {dict(zip(names, shape))} needs a process group of "
                f"{int(np.prod(shape))} ranks; none is initialized")
        return SingleRankMesh(names)
    ranks = np.arange(dist.get_world_size()).reshape(shape)
    groups = [_subgroups(ranks, [d]) for d in range(len(names))]
    mesh = DeviceMesh.from_group(groups, device_type,
                                 mesh=torch.as_tensor(ranks),
                                 mesh_dim_names=names)
    for d, name in enumerate(names):
        _GROUPS[_group_key(ranks, names, (name,))] = groups[d]
    return mesh


def _group_key(ranks: np.ndarray, names: Tuple[str, ...],
               axes: Tuple[str, ...]) -> Tuple:
    ranks = np.asarray(ranks, dtype=np.int64)
    return ranks.tobytes(), ranks.shape, tuple(names), tuple(axes)


def create_mesh(spec: Sequence[Tuple[str, int]], device=None) -> Mesh:
    """A mesh from ``[(axis_name, size), ...]`` over the ranks of the
    process group (one -1 size is inferred). ``device`` is the ranks'
    device (``None``: the GPU; ``"cpu"`` for CPU ranks): the DeviceMesh's
    device type. Without a process group the spec must resolve to one
    rank and the mesh is a :class:`SingleRankMesh`."""
    world = dist.get_world_size() if _grouped() else 1
    spec = resolve_mesh_shape(spec, world)
    names = tuple(n for n, _ in spec)
    if len(set(names)) != len(names):
        raise ValueError(f"Duplicate axis names: {names}")
    mesh = _build(names, tuple(s for _, s in spec), _device_type(device))
    logger.info("Mesh %s over %d ranks", dict(spec), world)
    return mesh


def create_hybrid_mesh(
    ici_spec: Sequence[Tuple[str, int]],
    dcn_spec: Sequence[Tuple[str, int]],
    device=None,
) -> Mesh:
    """Multi-host mesh: the DCN axes over hosts, outermost; the ICI axes
    over the ranks of one host. On GPUs that is NVLink within a host
    and the network across hosts: put data (or pipeline) parallelism on
    the DCN axes and fsdp/tensor on the ICI ones. The ICI axes resolve
    against the ranks per DCN index; since the ranks of one host are
    adjacent (``LOCAL_WORLD_SIZE`` of them), an ICI product of at most
    one host's ranks keeps each ICI group inside a host."""
    world = dist.get_world_size() if _grouped() else 1
    dcn_total = 1
    for _, s in dcn_spec:
        dcn_total *= s
    ici_spec = resolve_mesh_shape(ici_spec, world // max(dcn_total, 1))
    names = tuple(n for n, _ in dcn_spec) + tuple(n for n, _ in ici_spec)
    if len(set(names)) != len(names):
        raise ValueError(f"Duplicate axis names: {names}")
    shape = tuple(s for _, s in dcn_spec) + tuple(s for _, s in ici_spec)
    if int(np.prod(shape)) != world:
        raise ValueError(f"Mesh dcn={dcn_spec} ici={ici_spec} needs "
                         f"{int(np.prod(shape))} ranks, have {world}")
    import os

    local = int(os.getenv("LOCAL_WORLD_SIZE", "1") or 1)
    ici = int(np.prod([s for _, s in ici_spec]))
    if local > 1 and local % ici and ici % local:
        logger.warning("hybrid mesh: ICI axes of %d ranks straddle hosts "
                       "of %d ranks", ici, local)
    mesh = _build(names, shape, _device_type(device))
    logger.info("Hybrid mesh dcn=%s ici=%s over %d ranks",
                dict(dcn_spec), dict(ici_spec), world)
    return mesh


def axis_names(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh: Mesh, name: str) -> int:
    """Size of a mesh axis; 1 when absent (axes are optional)."""
    names = axis_names(mesh)
    return mesh.size(names.index(name)) if name in names else 1


def axis_index(mesh: Mesh, name: str) -> int:
    """This rank's coordinate on a mesh axis (0 when absent)."""
    names = axis_names(mesh)
    if name not in names:
        return 0
    return int(mesh.get_coordinate()[names.index(name)])


def mesh_info(mesh: Mesh) -> Dict[str, int]:
    return {n: axis_size(mesh, n) for n in axis_names(mesh)}


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes over which the global batch is sharded: data-like dims."""
    return tuple(
        a for a in (DATA_AXIS, FSDP_AXIS) if axis_size(mesh, a) > 1
        or a in axis_names(mesh)
    )


def data_parallel_size(mesh: Mesh) -> int:
    return axis_size(mesh, DATA_AXIS) * axis_size(mesh, FSDP_AXIS)


def axes_group(mesh: Mesh, axes: Sequence[str]):
    """This rank's process group over the mesh axes ``axes`` (those of
    size 1 and the absent ones left out): None when that is one rank.
    Groups over several axes are made at the first call, which every
    rank of the mesh must make."""
    axes = tuple(a for a in axes if axis_size(mesh, a) > 1)
    if not axes:
        return None
    ranks = mesh.mesh.cpu().numpy()
    names = axis_names(mesh)
    key = _group_key(ranks, names, axes)
    if key not in _GROUPS:
        _GROUPS[key] = _subgroups(ranks, [names.index(a) for a in axes])
    return _GROUPS[key]
