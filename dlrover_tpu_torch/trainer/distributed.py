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
through one collective layer: :func:`all_reduce_`, :func:`reduce_scatter`
and :func:`all_gather` on a mesh axis's group (``parallel/mesh.py``),
along any tensor dimension. Each takes the ranks' tensors as they are,
CUDA tensors included, under nccl and under gloo alike:
:func:`collective_route` says so for a group's backend, and the mesh's
user prints it. Whether gloo takes CUDA tensors for
``reduce_scatter_tensor`` and ``all_gather_into_tensor`` was probed on
an H100 (torch 2.11): it does, so nothing is staged through host buffers
(gloo copies through the host inside the call). Every collective of the
layer adds its seconds to :func:`collective_seconds`, the device
synchronized on both sides, as the ddp step's ``reduce_seconds``.
"""

import datetime
import os
import time
from dataclasses import dataclass
from typing import List, Optional

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


def collective_route(group) -> str:
    """How the layer moves a group's tensors: ``"direct"`` -- the ranks'
    tensors, on the card or not, go to the collective as they are. The
    backend decides it, never a caught exception: nccl takes CUDA
    tensors by design, gloo takes them for all_reduce, reduce_scatter
    and all_gather (probed on an H100, torch 2.11), and copies through
    the host inside the call."""
    backend = dist.get_backend(group) if group is not None else "none"
    if backend not in BACKENDS + ("none",):
        raise ValueError(f"no collective route for backend {backend!r}")
    return "direct"


def collective_seconds(reset: bool = False) -> float:
    """Seconds the layer's collectives took (device synchronized before
    and after each) since the last reset; ``reset`` starts anew."""
    total = _COLLECTIVE_S[0]
    if reset:
        _COLLECTIVE_S[0] = 0.0
    return total


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


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """``t`` reduced over ``group`` in place (nothing for no group)."""
    if group is None:
        return t
    with _Timed([t]):
        dist.all_reduce(t, op=op, group=group)
    return t


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` summed over ``group``, and this rank's chunk of the sum
    along ``dim`` (the group's ranks own consecutive chunks)."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    with _Timed([x]):
        dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] * n,) + tuple(src.shape[1:]))
    with _Timed([x]):
        dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()
