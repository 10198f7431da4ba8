"""Training-process bootstrap: env contract -> torch.distributed.

Counterpart of ``dlrover_tpu/trainer/distributed.py``. The agent fills
the NodeEnv vars after each rendezvous; the training process calls
``init_from_env()`` first thing. Where the JAX package starts
``jax.distributed`` with one process per host, the port runs one process
per GPU: a host's processes share its ``DLROVER_TPU_PROCESS_ID`` and
tell themselves apart by ``LOCAL_RANK`` among ``LOCAL_WORLD_SIZE``
(torchrun's names), so the global rank is ``process_id x local_world +
local_rank`` over ``num_processes x local_world`` ranks. The process
group meets at the coordinator address: nccl for ranks with a card each,
gloo on the CPU, or gloo when the caller asks for it (ranks that share
one card: NCCL refuses two ranks on one device). One process forms no
group.

A rank blocked in a collective on a dead or stuck peer raises after
``DLROVER_TPU_DIST_HEARTBEAT_TIMEOUT`` seconds (default 45, the JAX
package's), so its agent can re-rendezvous inside the recovery budget;
the rendezvous itself may wait ``timeout_s``. Collectives on host
tensors (the checkpoint's consensus, the example's barriers) run on
:func:`host_group`, a gloo group beside an nccl one. The JAX package's
persistent compile cache has no counterpart yet.

The sharding strategies (``trainer/sharded.py``) move their tensors
through one collective layer on a mesh axis's group
(``parallel/mesh.py``), along any tensor dimension: :func:`all_reduce_`,
:func:`reduce_scatter` and :func:`all_gather`, and for context
parallelism and pipelining :func:`ppermute` (JAX's ``lax.ppermute``
over an explicit permutation, or a shift around the group's ring) and
:func:`all_to_all` (JAX's tiled ``lax.all_to_all``). The last two are
differentiable: the backward of each is its transpose, the reverse
permutation and the inverse all-to-all. How an op moves CUDA tensors is a
constant per backend and op, :func:`collective_route`, written from
``trainer/collective_probe.py``'s answers on an H100 (torch 2.11): nccl
takes them by design; gloo takes them for all_reduce,
``reduce_scatter_tensor``, ``all_gather_into_tensor`` and
``all_to_all_single`` (copying through the host inside the call), and
refuses them for send and recv, so a ppermute on gloo stages its
tensor through a host buffer. Nothing falls back by catching an
exception. Every collective of the layer adds its seconds to
:func:`collective_seconds`, the device synchronized on both sides, as
the ddp step's ``reduce_seconds``; ppermute and all_to_all add the
bytes this rank sends to :func:`collective_bytes`, and an all-reduce
given a ``label`` adds its tensor's bytes there under that label.
"""

import datetime
import os
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from dlrover_tpu_torch.auto.device_context import resolve_device
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.log import set_process_index
from dlrover_tpu_torch.telemetry import record

#: the GPU processes of one host (torchrun's env names)
LOCAL_RANK = "LOCAL_RANK"
LOCAL_WORLD_SIZE = "LOCAL_WORLD_SIZE"
#: seconds a collective may block on a dead or stuck peer
ENV_HEARTBEAT_TIMEOUT = "DLROVER_TPU_DIST_HEARTBEAT_TIMEOUT"
BACKENDS = ("nccl", "gloo")

#: the gloo group for collectives on host tensors (None: no group)
_HOST_GROUP = None


@dataclass
class DistributedEnv:
    coordinator_addr: str
    process_id: int
    num_processes: int
    node_rank: int
    node_num: int
    restart_count: int
    master_addr: str
    local_rank: int = 0
    local_world_size: int = 1

    @property
    def rank(self) -> int:
        return self.process_id * self.local_world_size + self.local_rank

    @property
    def world_size(self) -> int:
        return self.num_processes * self.local_world_size

    @property
    def is_distributed(self) -> bool:
        return self.world_size > 1


def read_dist_env() -> DistributedEnv:
    return DistributedEnv(
        coordinator_addr=os.getenv(NodeEnv.COORDINATOR_ADDR, ""),
        process_id=int(os.getenv(NodeEnv.PROCESS_ID, "0")),
        num_processes=int(os.getenv(NodeEnv.NUM_PROCESSES, "1")),
        node_rank=int(os.getenv(NodeEnv.NODE_RANK, "0")),
        node_num=int(os.getenv(NodeEnv.NODE_NUM, "1")),
        restart_count=int(os.getenv(NodeEnv.RESTART_COUNT, "0")),
        master_addr=os.getenv(NodeEnv.MASTER_ADDR, ""),
        local_rank=int(os.getenv(LOCAL_RANK, "0")),
        local_world_size=int(os.getenv(LOCAL_WORLD_SIZE, "1")),
    )


def heartbeat_timeout_s() -> float:
    """``DLROVER_TPU_DIST_HEARTBEAT_TIMEOUT``: how long a collective
    may block on a dead or stuck peer (default 45 s, as in JAX)."""
    return float(os.getenv(ENV_HEARTBEAT_TIMEOUT, "45") or 45)


def host_group():
    """The group for collectives on CPU tensors: the default group when
    it is gloo, else the gloo group :func:`init_from_env` made beside
    it. None without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return _HOST_GROUP if _HOST_GROUP is not None else dist.group.WORLD


def init_from_env(timeout_s: int = 300, device=None,
                  backend: Optional[str] = None) -> DistributedEnv:
    """Form the process group from the agent-provided env (no-op for a
    single process). ``device`` is where this process trains: the GPU
    (``None``, the default; raises without one) takes this process's
    ``LOCAL_RANK`` card, which must exist, ``"cpu"`` takes gloo.
    ``backend`` (``None``: nccl on a card, gloo on the CPU) may name
    gloo for ranks that share one card. ``timeout_s`` bounds the
    rendezvous; collectives time out after
    :func:`heartbeat_timeout_s`."""
    global _HOST_GROUP
    env = read_dist_env()
    if env.is_distributed:
        if not env.coordinator_addr:
            raise ValueError(
                f"{env.world_size} ranks but no {NodeEnv.COORDINATOR_ADDR}"
            )
        dev = resolve_device(device)
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
        if backend == "nccl" and dev.type != "cuda":
            raise ValueError("nccl runs on cards; a CPU rank takes gloo")
        if dev.type == "cuda":
            count = torch.cuda.device_count()
            if env.local_rank >= count:
                raise RuntimeError(
                    f"LOCAL_RANK {env.local_rank} but {count} card(s) on "
                    "this host: one process per card, and never two "
                    "ranks of one host on one card")
            torch.cuda.set_device(env.local_rank)
        hb = heartbeat_timeout_s()
        host, _, port = env.coordinator_addr.rpartition(":")
        logger.info(
            "init_process_group(%s, tcp://%s, world_size=%d, rank=%d, "
            "collective timeout=%.0fs)",
            backend, env.coordinator_addr, env.world_size, env.rank, hb,
        )
        # the store waits timeout_s for the ranks to arrive; the group's
        # own timeout bounds every collective
        store = dist.TCPStore(
            host or "localhost", int(port), env.world_size,
            is_master=env.rank == 0,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        dist.init_process_group(
            backend, store=store, world_size=env.world_size,
            rank=env.rank, timeout=datetime.timedelta(seconds=hb),
        )
        _HOST_GROUP = None
        if backend != "gloo":
            _HOST_GROUP = dist.new_group(
                backend="gloo", timeout=datetime.timedelta(seconds=hb))
    # the authoritative index is now known: tag log lines and the
    # journal envelope with it, then journal the init
    set_process_index(env.rank)
    record(
        "distributed.init", process_id=env.process_id,
        num_processes=env.num_processes, node_rank=env.node_rank,
        restart_count=env.restart_count,
        coordinator=env.coordinator_addr, rank=env.rank,
        world_size=env.world_size,
    )
    return env


# ------------------------------------------------------- collective layer

#: seconds spent in the layer's collectives since the last reset
_COLLECTIVE_S = [0.0]
#: bytes this rank sent to other ranks by ppermute and all_to_all, and
#: the bytes of the labelled all-reduces
_COLLECTIVE_BYTES = {"ppermute": 0, "all_to_all": 0}
#: how each op of the layer moves CUDA tensors under gloo ("direct": as
#: they are; "host": through a host buffer), from collective_probe.py on
#: an H100 (torch 2.11)
GLOO_CUDA_ROUTES = {
    "all_reduce": "direct",
    "reduce_scatter": "direct",
    "all_gather": "direct",
    "all_to_all": "direct",
    "ppermute": "host",
}


def collective_route(group, op: str = "all_reduce",
                     device_type: str = "cuda") -> str:
    """How the layer moves ``op``'s tensors of ``device_type`` on a
    group: ``"direct"`` -- as they are, to the collective -- or
    ``"host"`` -- copied to a host buffer and back around it. The
    backend decides it, never a caught exception: nccl and the CPU take
    every op direct, gloo takes CUDA tensors as
    :data:`GLOO_CUDA_ROUTES` says."""
    if op not in GLOO_CUDA_ROUTES:
        raise ValueError(f"no collective {op!r}; one of "
                         f"{sorted(GLOO_CUDA_ROUTES)}")
    backend = dist.get_backend(group) if group is not None else "none"
    if backend not in BACKENDS + ("none",):
        raise ValueError(f"no collective route for backend {backend!r}")
    if backend == "gloo" and device_type == "cuda":
        return GLOO_CUDA_ROUTES[op]
    return "direct"


def collective_seconds(reset: bool = False) -> float:
    """Seconds the layer's collectives took (device synchronized before
    and after each) since the last reset; ``reset`` starts anew."""
    total = _COLLECTIVE_S[0]
    if reset:
        _COLLECTIVE_S[0] = 0.0
    return total


def collective_bytes(reset: bool = False) -> dict:
    """{op: bytes this rank sent to other ranks} of ppermute and
    all_to_all, and {label: bytes} of the labelled all-reduces, since
    the last reset; ``reset`` starts anew."""
    out = dict(_COLLECTIVE_BYTES)
    if reset:
        _COLLECTIVE_BYTES.clear()
        _COLLECTIVE_BYTES.update(ppermute=0, all_to_all=0)
    return out


class _Timed:
    def __init__(self, tensors: List[torch.Tensor]):
        self.cuda = [t.device for t in tensors if t.is_cuda][:1]

    def __enter__(self):
        for d in self.cuda:
            torch.cuda.synchronize(d)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        for d in self.cuda:
            torch.cuda.synchronize(d)
        _COLLECTIVE_S[0] += time.perf_counter() - self.t0


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM,
                label: Optional[str] = None) -> torch.Tensor:
    """``t`` reduced over ``group`` in place (nothing for no group);
    ``label`` counts its bytes in :func:`collective_bytes`."""
    if group is None:
        return t
    with _Timed([t]):
        dist.all_reduce(t, op=op, group=group)
    if label is not None:
        _COLLECTIVE_BYTES[label] = (_COLLECTIVE_BYTES.get(label, 0)
                                    + t.numel() * t.element_size())
    return t


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` summed over ``group``, and this rank's chunk of the sum
    along ``dim`` (the group's ranks own consecutive chunks). A dim that
    does not divide is split as GSPMD pads it
    (``parallel/sharding.block``): the sum is padded with zeros to equal
    chunks, and this rank's chunk cut back to its length."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    total = src.shape[0]
    step = -(-total // n)
    if step * n != total:
        src = torch.cat([src, src.new_zeros(
            (step * n - total,) + tuple(src.shape[1:]))])
    out = src.new_empty((step,) + tuple(src.shape[1:]))
    with _Timed([x]):
        dist.reduce_scatter_tensor(out, src, group=group)
    me = dist.get_rank(group)
    out = out[:max(0, min(step, total - me * step))]
    return out.movedim(0, dim).contiguous()


def all_gather(x: torch.Tensor, dim: int, group,
               size: Optional[int] = None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order.
    ``size``: the gathered length of ``dim`` where the ranks' chunks are
    GSPMD's padded split of it (``parallel/sharding.block``), the last
    ones short or empty; None: every rank's chunk is as long as ``x``'s."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    step = src.shape[0] if size is None else -(-size // n)
    if src.shape[0] < step:
        src = torch.cat([src, src.new_zeros(
            (step - src.shape[0],) + tuple(src.shape[1:]))])
    out = src.new_empty((step * n,) + tuple(src.shape[1:]))
    with _Timed([x]):
        dist.all_gather_into_tensor(out, src, group=group)
    if size is not None:
        out = out[:size]
    return out.movedim(0, dim).contiguous()


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank of ``group`` (the other
    ranks pass a tensor of its shape and dtype): an all-reduce of ``x``
    on ``src`` and zeros elsewhere, which gloo takes for CUDA tensors
    (:data:`GLOO_CUDA_ROUTES`)."""
    if group is None:
        return x
    x = x.clone() if dist.get_rank(group) == src else torch.zeros_like(x)
    return all_reduce_(x, group)


#: a permutation of a group's ranks: (source, destination) pairs in
#: group-rank order, or a shift around the group's ring
Perm = Union[int, Sequence[Tuple[int, int]]]


def _pairs(group, perm: Perm) -> List[Tuple[int, int]]:
    """``perm`` as (source, destination) pairs, each rank at most once
    on either side."""
    n = dist.get_world_size(group)
    if isinstance(perm, int):
        return [] if perm % n == 0 else [(i, (i + perm) % n)
                                          for i in range(n)]
    pairs = [(int(a), int(b)) for a, b in perm]
    srcs, dsts = [a for a, _ in pairs], [b for _, b in pairs]
    if (len(set(srcs)) < len(srcs) or len(set(dsts)) < len(dsts)
            or not all(0 <= r < n for r in srcs + dsts)):
        raise ValueError(f"not a permutation of {n} ranks: {perm}")
    return pairs


def exchange(x: Optional[torch.Tensor], group, pairs, like: torch.Tensor
             ) -> Optional[torch.Tensor]:
    """One round of point-to-point sends over ``group``: this rank
    sends ``x`` where ``pairs`` (group ranks) make it a source, and
    returns what its source sent, shaped as ``like`` (None when no rank
    sends to it). A rank in no pair moves nothing."""
    me = dist.get_rank(group)
    dst = next((b for a, b in pairs if a == me), None)
    src = next((a for a, b in pairs if b == me), None)
    if dst is None and src is None:
        return None
    ranks = dist.get_process_group_ranks(group)
    host = collective_route(group, "ppermute", like.device.type) == "host"
    with _Timed([like]):
        req = None
        if dst is not None:
            send = (x.cpu() if host else x).contiguous()
            req = dist.isend(send, ranks[dst], group=group)
            _COLLECTIVE_BYTES["ppermute"] += (send.numel()
                                              * send.element_size())
        got = None
        if src is not None:
            got = torch.empty(like.shape, dtype=like.dtype,
                              device="cpu" if host else like.device)
            dist.recv(got, ranks[src], group=group)
            got = got.to(like.device) if host else got
        if req is not None:
            req.wait()
    return got


def _ppermute(x: torch.Tensor, group, perm: Perm) -> torch.Tensor:
    got = exchange(x, group, _pairs(group, perm), x)
    if isinstance(perm, int) and perm % dist.get_world_size(group) == 0:
        return x
    return got if got is not None else torch.zeros_like(x)


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
                group) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = x.movedim(split_dim, 0)
    if src.shape[0] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    host = collective_route(group, "all_to_all", x.device.type) == "host"
    with _Timed([x]):
        send = src.reshape((n, src.shape[0] // n) + tuple(src.shape[1:]))
        send = (send.cpu() if host else send).contiguous()
        got = torch.empty_like(send)
        dist.all_to_all_single(got, send, group=group)
        got = got.to(x.device) if host else got
    _COLLECTIVE_BYTES["all_to_all"] += (
        send.numel() * send.element_size() * (n - 1) // n)
    # got[i] is rank i's chunk for this rank, split dim in front
    return torch.cat([p.movedim(0, split_dim) for p in got.unbind(0)],
                     dim=concat_dim)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _ppermute(x, group, perm)

    @staticmethod
    def backward(ctx, grad):
        perm = ctx.perm
        back = (-perm if isinstance(perm, int)
                else [(b, a) for a, b in _pairs(ctx.group, perm)])
        return _ppermute(grad, ctx.group, back), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(grad, concat_dim, split_dim, ctx.group), None,
                None, None)


def ppermute(x: torch.Tensor, group, perm: Perm = 1) -> torch.Tensor:
    """JAX's ``lax.ppermute`` over ``group``: ``perm`` is JAX's list of
    (source, destination) pairs of group ranks -- each rank sends ``x``
    to its destination, if it has one, and returns what its source
    sent, or zeros where no rank sends to it -- or an int shift around
    the ring (rank i sends to ``i + shift``). Nothing moves for no
    group. Differentiable: the gradient goes back by the reverse
    permutation. Only the ranks named in ``perm`` communicate."""
    if group is None:
        return x
    return _PPermute.apply(x, group, perm)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
               group) -> torch.Tensor:
    """JAX's tiled ``lax.all_to_all`` over ``group``: ``x`` split into
    group-size chunks along ``split_dim``, chunk j sent to rank j, the
    chunks that arrive concatenated along ``concat_dim`` in group-rank
    order. Differentiable: the gradient takes the inverse all-to-all
    (``concat_dim`` split, ``split_dim`` concatenated)."""
    if group is None:
        return x
    return _AllToAll.apply(x, split_dim, concat_dim, group)
