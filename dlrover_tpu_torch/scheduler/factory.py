"""Platform factory: JobArgs -> (scaler, watcher).

Parity reference: the reference picks its platform in
dlrover/python/master/dist_master.py + scheduler/factory.py; here one
function owns the mapping:

  process -> ProcessScaler + its InMemoryWatcher (one host, or a fake
             cluster of processes in tests)
  local   -> no scaler: the local master runs the job

Counterpart of ``dlrover_tpu/scheduler/factory.py``. ``tpu_vm`` and
``gke`` raise: their scalers drive the TPU-VM and GKE APIs, which have no
counterpart this round (ROADMAP.md). Without a Brain (ROADMAP.md, queue
A.2.4) there is no host blacklist to fetch.
"""

from typing import Optional, Tuple

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.scaler.base_scaler import Scaler
from dlrover_tpu_torch.master.watcher.base_watcher import NodeWatcher


def fetch_avoid_hosts(brain_client) -> Optional[list]:
    """The Brain's host blacklist: None without a brain client, as in
    JAX; a client raises (ROADMAP.md, queue A.2.4)."""
    if brain_client is None:
        return None
    raise NotImplementedError(
        "a brain client waits for the port of brain/ "
        "(ROADMAP.md, queue A.2.4)")


def build_platform(
    job_args, master_addr: str, brain_client=None,
    avoid_hosts: Optional[list] = None,
) -> Tuple[Optional[Scaler], Optional[NodeWatcher]]:
    platform = getattr(job_args, "platform", "local")
    job_name = getattr(job_args, "job_name", "job")
    if avoid_hosts is None:
        avoid_hosts = fetch_avoid_hosts(brain_client)
    if avoid_hosts:
        # pod anti-affinity is the gke backend's mechanism; the process
        # platform has no placement to steer
        logger.info(
            "host blacklist %s: placement avoidance is gke-only; "
            "platform %r allocates fresh machines", avoid_hosts,
            platform,
        )
    if platform in ("tpu_vm", "gke"):
        raise NotImplementedError(
            f"platform {platform!r}: its scaler and watcher drive a "
            "cloud API, which has no counterpart this round (ROADMAP.md, "
            "\"No counterpart this round\")")
    if platform == "process":
        from dlrover_tpu_torch.master.scaler.process_scaler import (
            ProcessScaler,
        )

        command = list(getattr(job_args, "worker_command", []) or [])
        if not command:
            logger.warning(
                "process platform needs spec worker.command to launch "
                "agents; no fleet automation"
            )
            return None, None
        commands = {}
        envs = {}
        eval_cmd = list(
            getattr(job_args, "evaluator_command", []) or []
        )
        if eval_cmd:
            commands["evaluator"] = eval_cmd
            envs["evaluator"] = dict(
                getattr(job_args, "evaluator_env", {}) or {}
            )
        scaler = ProcessScaler(
            job_name, master_addr, command=command,
            env=dict(getattr(job_args, "worker_env", {}) or {}),
            commands=commands, envs=envs,
        )
        return scaler, scaler.watcher
    if platform != "local":
        logger.warning(
            "platform %r has no scaler/watcher implementation; no fleet "
            "automation (agents must be started manually)", platform,
        )
    return None, None
