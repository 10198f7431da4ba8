"""Training-process bootstrap: env contract -> torch.distributed.

Counterpart of ``dlrover_tpu/trainer/distributed.py``. The agent fills
the NodeEnv vars after each rendezvous; the training process calls
``init_from_env()`` first thing. Where the JAX package starts
``jax.distributed`` with one process per host, the port runs one process
per GPU: a host's processes share its ``DLROVER_TPU_PROCESS_ID`` and
tell themselves apart by ``LOCAL_RANK`` among ``LOCAL_WORLD_SIZE``
(torchrun's names), so the global rank is ``process_id x local_world +
local_rank`` over ``num_processes x local_world`` ranks. The process
group meets at ``tcp://<coordinator address>``: nccl for GPUs, gloo on
the CPU. One process forms no group. The JAX package's persistent
compile cache has no counterpart yet.
"""

import datetime
import os
from dataclasses import dataclass

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


def init_from_env(timeout_s: int = 300, device=None) -> DistributedEnv:
    """Form the process group from the agent-provided env (no-op for a
    single process). ``device`` picks the backend: the GPU (``None``,
    the default; raises without one) takes nccl and this process's
    ``LOCAL_RANK`` card, ``"cpu"`` takes gloo."""
    env = read_dist_env()
    if env.is_distributed:
        if not env.coordinator_addr:
            raise ValueError(
                f"{env.world_size} ranks but no {NodeEnv.COORDINATOR_ADDR}"
            )
        dev = resolve_device(device)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(env.local_rank)
        logger.info(
            "init_process_group(%s, tcp://%s, world_size=%d, rank=%d)",
            backend, env.coordinator_addr, env.world_size, env.rank,
        )
        dist.init_process_group(
            backend, init_method=f"tcp://{env.coordinator_addr}",
            world_size=env.world_size, rank=env.rank,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
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
