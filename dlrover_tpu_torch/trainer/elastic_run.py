"""``dlrover-tpu-torch-run`` — elastic launcher CLI.

Parity reference: dlrover/trainer/torch/elastic_run.py:189 (main),
elastic_launch:58, _launch_dlrover_local_master:106. torchrun-compatible
surface where it makes sense (``--nnodes MIN:MAX``, ``--max_restarts``,
``--standalone``, ``--node_unit``).

Counterpart of ``dlrover_tpu/trainer/elastic_run.py``: ``--standalone``
starts the port's local master (``python -m
dlrover_tpu_torch.master.main``) as a subprocess, then this process runs
the node's agent (agent/elastic/training.py), which supervises the
training process::

    python -m dlrover_tpu_torch.trainer.elastic_run --standalone \
        --nnodes 1:1 dlrover_tpu_torch/examples/llama_train.py -- \
        --steps 20 --ckpt-dir /tmp/ckpt

``--nproc_per_node N`` starts N workers on the node, one per GPU
(``LOCAL_RANK`` 0..N-1); ``--network-check`` runs the pre-flight probe
rounds first (agent/elastic/network_check.py). Exit code: 0 when the
workers succeeded, else the last failing exit code (a signal death as
``128 + signal``), 1 for a configuration error or a failed network
check. Not ported yet (ROADMAP.md, queue A): the relay tier
(``--relay_fanout`` above 0 raises) and the compile cache.
"""

import argparse
import atexit
import os
import re
import subprocess
import sys
import time
from typing import Optional, Tuple

from dlrover_tpu_torch.agent.elastic.training import (
    ElasticLaunchConfig,
    launch_agent,
)
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.grpc_utils import addr_connected
from dlrover_tpu_torch.common.log import default_logger as logger

#: agents per aggregator relay (the JAX launcher's env default)
ENV_RELAY_FANOUT = "DLROVER_TPU_RELAY_FANOUT"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Elastic training launcher"
    )
    parser.add_argument("--nnodes", type=str, default="1:1",
                        help="MIN:MAX nodes, e.g. 2:4")
    parser.add_argument("--nproc_per_node", type=int, default=1,
                        help="training processes per node, one per GPU "
                             "(LOCAL_RANK 0..N-1)")
    parser.add_argument("--node_rank", type=int,
                        default=int(os.getenv(NodeEnv.NODE_RANK, "0")))
    parser.add_argument("--max_restarts", type=int, default=3)
    parser.add_argument("--monitor_interval", type=float, default=3.0)
    parser.add_argument("--heartbeat_interval", type=float, default=15.0,
                        help="agent liveness heartbeat period to the "
                             "master (the master's watchdog timeout "
                             "should be >= 3x this)")
    parser.add_argument("--rdzv_timeout", type=float, default=30.0)
    parser.add_argument("--node_unit", type=int, default=1,
                        help="world sizes stay multiples of this")
    parser.add_argument("--network-check", action="store_true",
                        dest="network_check",
                        help="pre-flight check: a matmul on the card and "
                             "an all-gather between nodes, two rounds")
    parser.add_argument("--standalone", action="store_true",
                        help="self-host a local master subprocess")
    parser.add_argument("--master_addr", type=str,
                        default=os.getenv(NodeEnv.MASTER_ADDR, ""))
    parser.add_argument("--relay_fanout", type=int,
                        default=int(os.getenv(ENV_RELAY_FANOUT, "0") or 0),
                        help="agents per aggregator relay (not ported: "
                             "above 0 raises)")
    parser.add_argument("entrypoint", type=str, help="training script/cmd")
    parser.add_argument("entry_args", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def _parse_nnodes(spec: str) -> Tuple[int, int]:
    if ":" in spec:
        lo, _, hi = spec.partition(":")
        return int(lo), int(hi)
    return int(spec), int(spec)


def launch_local_master(node_num: int = 1) -> Tuple[subprocess.Popen, str]:
    """Start a standalone master subprocess and discover its port
    (parity: elastic_run.py:106)."""
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "dlrover_tpu_torch.master.main",
            "--platform", "local", "--port", "0",
            "--node_num", str(node_num),
        ],
        stdout=subprocess.PIPE,
        text=True,
    )
    port = None
    deadline = time.time() + 30
    while time.time() < deadline:
        line = proc.stdout.readline()
        m = re.match(r"DLROVER_TPU_MASTER_PORT=(\d+)", line or "")
        if m:
            port = int(m.group(1))
            break
        if proc.poll() is not None:
            raise RuntimeError("local master exited during startup")
    if port is None:
        proc.kill()
        raise RuntimeError("local master did not report its port")
    addr = f"localhost:{port}"
    logger.info("Standalone local master at %s", addr)
    return proc, addr


def run(args) -> int:
    if args.relay_fanout > 0:
        raise NotImplementedError(
            f"--relay_fanout {args.relay_fanout}: the relay tier "
            "(dlrover_tpu/agent/relay.py) is not ported (ROADMAP.md, "
            "queue A)"
        )
    min_nodes, max_nodes = _parse_nnodes(args.nnodes)
    master_proc: Optional[subprocess.Popen] = None
    master_addr = args.master_addr
    if args.standalone and not master_addr:
        master_proc, master_addr = launch_local_master(max_nodes)
        atexit.register(master_proc.kill)
    if not master_addr:
        raise SystemExit(
            "No master: pass --standalone or --master_addr / "
            f"set {NodeEnv.MASTER_ADDR}"
        )
    if not addr_connected(master_addr, timeout=10):
        raise SystemExit(f"Cannot reach master at {master_addr}")

    client = MasterClient(
        master_addr, node_id=args.node_rank, node_type="worker"
    )
    if args.node_rank == 0:
        client.report_rdzv_params(
            min_nodes, max_nodes, args.rdzv_timeout, args.node_unit
        )
    entry_args = list(args.entry_args)
    if entry_args and entry_args[0] == "--":
        entry_args = entry_args[1:]
    config = ElasticLaunchConfig(
        min_nodes=min_nodes,
        max_nodes=max_nodes,
        nproc_per_node=args.nproc_per_node,
        node_rank=args.node_rank,
        rdzv_timeout=args.rdzv_timeout,
        node_unit=args.node_unit,
        max_restarts=args.max_restarts,
        monitor_interval=args.monitor_interval,
        heartbeat_interval=args.heartbeat_interval,
        network_check=args.network_check,
        entrypoint=args.entrypoint,
        args=entry_args,
        env={NodeEnv.MASTER_ADDR: master_addr},
    )
    result = launch_agent(config, client)
    if master_proc is not None:
        master_proc.terminate()
    if result.state == "succeeded":
        return 0
    rc = result.return_code
    if rc < 0:
        # signal deaths propagate shell-style (SIGKILL -> 137): a raw
        # negative rc would be truncated mod 256 by the OS (-9 -> 247)
        # and the platform scaler's OOM/KILLED exit mapping
        # (process_scaler.py, pod exit codes) would read UNKNOWN —
        # silently disabling the master's OOM grow-and-relaunch for
        # the real kernel-OOM-killer case
        rc = 128 - rc
    return rc


def main(argv=None) -> int:
    return run(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
