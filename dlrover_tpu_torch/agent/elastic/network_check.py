"""Pre-flight network and accelerator check before training starts.

Counterpart of ``dlrover_tpu/agent/elastic/network_check.py`` (parity
reference: dlrover/python/elastic_agent/torch/training.py:579,
NetworkCheckElasticAgent, and dlrover/trainer/torch/
run_network_check.py:24). The nodes rendezvous under the NETWORK_CHECK
name; each probe group runs a torch probe, one process per node: a bf16
matmul on the node's first card (``DLROVER_TPU_PROBE_DEVICE=cpu`` asks
for the CPU) and, in a group of several nodes, an all-gather over a gloo
group between them (the host network the ranks' process group meets
over). A node whose matmul or gather fails, or whose probe times out,
fails its round. Two rounds: round 0 pairs neighbours, round 1 pairs
each failed or slow node with a known-good partner, which lets the
master localize faults and stragglers
(``master/elastic_training/rdzv_manager.py``).
``DLROVER_TPU_PROBE_DELAY`` (``rank:seconds[:gate_file],...``) delays a
node's probe, the JAX package's drill hook.
"""

import os
import subprocess
import sys
import time

from dlrover_tpu_torch.agent.elastic.training import (
    ElasticLaunchConfig,
    MasterRendezvousHandler,
)
from dlrover_tpu_torch.common.constants import NodeEnv, RendezvousName
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import record

CHECK_ROUNDS = 2
#: where the probe's matmul runs: ``cuda`` (the default) or ``cpu``
ENV_PROBE_DEVICE = "DLROVER_TPU_PROBE_DEVICE"

#: the head of the probe script: the drill hook's delay
_DELAY_HOOK = r"""
import datetime, os, time

# fault-injection hook: "rank:seconds[:gate_file][,...]" delays THIS
# node's probe so the master records it as a straggler; with a gate
# file the delay applies only while that file exists
_delay_spec = os.environ.get("DLROVER_TPU_PROBE_DELAY", "")
_own_rank = os.environ.get("{NODE_RANK}", "")
for _part in _delay_spec.split(","):
    _fields = _part.split(":")
    if len(_fields) < 2:
        continue
    _r, _secs = _fields[0], _fields[1]
    _gate = _fields[2] if len(_fields) > 2 else ""
    try:
        _delay = float(_secs)
    except ValueError:
        continue  # a malformed entry must not fail the probe itself
    if _r and _r == _own_rank and (not _gate or os.path.exists(_gate)):
        time.sleep(_delay)
"""

_PROBE_SCRIPT = _DELAY_HOOK + r"""
import torch
import torch.distributed as dist

device = torch.device(os.environ.get("{DEVICE}") or "cuda")
# the card's compute: a bf16 matmul of ones has every entry n
n = 2048
a = torch.ones((n, n), dtype=torch.bfloat16, device=device)
c = a @ a
if device.type == "cuda":
    torch.cuda.synchronize(device)
if not bool((c == n).all()):
    raise SystemExit("matmul probe gave a wrong result")

num_processes = int(os.environ.get("{NPROC}", "1"))
if num_processes > 1:
    # the host network between the group's nodes: an all-gather
    rank = int(os.environ["{PID}"])
    host, _, port = os.environ["{COORD}"].rpartition(":")
    timeout = datetime.timedelta(seconds=60)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=rank == 0, timeout=timeout)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=num_processes, timeout=timeout)
    mine = torch.full((1 << 20,), float(rank + 1))
    rows = [torch.empty_like(mine) for _ in range(num_processes)]
    dist.all_gather(rows, mine)
    if not all(bool((r == i + 1).all()) for i, r in enumerate(rows)):
        raise SystemExit("all-gather probe gave a wrong result")
    dist.destroy_process_group()
print("NETWORK_CHECK_OK", flush=True)
"""


class NetworkCheckElasticAgent:
    """Runs CHECK_ROUNDS probe rounds and reports each to the master."""

    def __init__(self, config: ElasticLaunchConfig, master_client,
                 probe_timeout: float = 180.0):
        self._config = config
        self._client = master_client
        self._probe_timeout = probe_timeout

    def run(self) -> bool:
        success = False
        for r in range(CHECK_ROUNDS):
            handler = MasterRendezvousHandler(
                self._client, self._config.node_rank,
                self._config.nproc_per_node,
                rdzv_name=RendezvousName.NETWORK_CHECK,
                rdzv_params=(
                    self._config.min_nodes, self._config.max_nodes,
                    self._config.rdzv_timeout, self._config.node_unit,
                ),
            )
            rdzv_round, world, _, _, coordinator = handler.next_rendezvous()
            # one probe process per node of the group
            nodes = sorted(world)
            start = time.time()
            normal = self._run_probe(
                coordinator, nodes.index(self._config.node_rank),
                len(nodes))
            elapsed = time.time() - start
            self._client.report_node_check_status(
                rdzv_round, normal, elapsed)
            # wait for every peer's report, then ask the verdict
            reason = ""
            deadline = time.time() + 60
            while time.time() < deadline:
                success, reason = self._client.network_check_success()
                if success or (reason and reason != "waiting_node"):
                    break
                time.sleep(0.5)
            record("network_check.round", round=r, rdzv_round=rdzv_round,
                   group=nodes, normal=normal, elapsed_s=round(elapsed, 3),
                   node_rank=self._config.node_rank, success=success,
                   reason=reason)
            # every round runs even after a green verdict: the probe is
            # collective, so one round cannot tell a straggler from the
            # members it slowed; the re-paired round gives the evidence
            # the master's straggler localization intersects
            if not success:
                logger.warning(
                    "Network check round %d failed (%s)", r, reason)
        if success:
            return True
        fault_nodes = self._client.get_fault_nodes()
        if self._config.node_rank in fault_nodes:
            logger.error("This node localized as faulty: %s", fault_nodes)
            return False
        return success

    def _run_probe(self, coordinator: str, process_id: int,
                   num_processes: int) -> bool:
        script = _PROBE_SCRIPT.format(
            COORD=NodeEnv.COORDINATOR_ADDR, NPROC=NodeEnv.NUM_PROCESSES,
            PID=NodeEnv.PROCESS_ID, NODE_RANK=NodeEnv.NODE_RANK,
            DEVICE=ENV_PROBE_DEVICE,
        )
        env = dict(os.environ)
        env.update(self._config.env)
        env[NodeEnv.COORDINATOR_ADDR] = coordinator
        env[NodeEnv.PROCESS_ID] = str(process_id)
        env[NodeEnv.NUM_PROCESSES] = str(num_processes)
        env[NodeEnv.NODE_RANK] = str(self._config.node_rank)
        try:
            out = subprocess.run(
                [sys.executable, "-c", script], env=env,
                timeout=self._probe_timeout, capture_output=True, text=True,
            )
        except subprocess.TimeoutExpired:
            logger.warning("Probe timed out after %ss", self._probe_timeout)
            return False
        ok = out.returncode == 0 and "NETWORK_CHECK_OK" in out.stdout
        if not ok:
            logger.warning("Probe failed rc=%s stderr=%s",
                           out.returncode, out.stderr[-500:])
        return ok
