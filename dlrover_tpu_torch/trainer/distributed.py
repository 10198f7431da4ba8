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
"""

import datetime
import os
from dataclasses import dataclass
from typing import Optional

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
