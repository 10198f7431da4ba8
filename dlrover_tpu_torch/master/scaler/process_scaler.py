"""Process scaler: the "local platform" — nodes are agent subprocesses.

Parity reference: dlrover/python/master/scaler/pod_scaler.py:71
(PodScaler: creates pods with the env contract injected, periodic
creation thread) — here the platform is the local host, so a "node" is a
``dlrover_tpu_torch.agent`` process. This is both the single-host production
path (one TPU VM) and the multi-node-without-a-cluster test platform
(SURVEY §4: the reference's strongest system-test trick).

A k8s/GKE scaler for real TPU-VM fleets implements the same Scaler
interface against the cloud API; it is pluggable via
scheduler/factory (not shipped in this image: no cluster to talk to).

A copy of ``dlrover_tpu/master/scaler/process_scaler.py``: a node is a
process of the spec's ``worker.command``, launched with the ``NodeEnv``
contract, and its exit code becomes the exit reason as JAX maps it
(-9/137 OOM, -15/143 KILLED, any other UNKNOWN), so a SIGKILLed worker
reads as OOM.
"""

import os
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.constants import (
    NodeEnv,
    NodeEventType,
    NodeExitReason,
    NodeStatus,
    NodeType,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.master.scaler.base_scaler import ScalePlan, Scaler
from dlrover_tpu_torch.master.watcher.base_watcher import (
    InMemoryWatcher,
    NodeEvent,
)


class ProcessScaler(Scaler):
    """Launch/kill per-node agent subprocesses and feed their lifecycle
    into an InMemoryWatcher (so the job manager sees the same event
    stream a pod watcher would produce)."""

    def __init__(
        self,
        job_name: str,
        master_addr: str,
        command: Optional[List[str]] = None,
        env: Optional[Dict[str, str]] = None,
        watcher: Optional[InMemoryWatcher] = None,
        commands: Optional[Dict[str, List[str]]] = None,
        envs: Optional[Dict[str, Dict[str, str]]] = None,
    ):
        super().__init__(job_name)
        self._master_addr = master_addr
        self._command = command
        #: per-role command override (evaluator side-jobs run a
        #: different entrypoint than workers); non-worker roles REQUIRE
        #: an entry here (supports_role) — falling back to the training
        #: command would launch a rogue trainer under the wrong role
        self._commands = dict(commands or {})
        #: per-role env override; falls back to env
        self._envs = dict(envs or {})
        self._env = env or {}
        self.watcher = watcher or InMemoryWatcher()
        # keyed by (node_type, node_id): roles allocate ids
        # independently, so worker 0 and evaluator 0 coexist
        self._procs: Dict[tuple, subprocess.Popen] = {}
        self._nodes: Dict[tuple, Node] = {}
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._monitor = threading.Thread(
            target=self._monitor_procs, daemon=True,
            name="process-scaler-monitor",
        )
        self._monitor.start()

    def supports_role(self, node_type: str) -> bool:
        return node_type == NodeType.WORKER or node_type in self._commands

    def scale(self, plan: ScalePlan) -> None:
        for node in plan.remove_nodes:
            self._kill_node(node)
        for node in plan.launch_nodes:
            self._launch_node(node)

    def _launch_node(self, node: Node):
        env = dict(os.environ)
        env.update(self._envs.get(node.type, self._env))
        env[NodeEnv.MASTER_ADDR] = self._master_addr
        env[NodeEnv.NODE_TYPE] = node.type
        env[NodeEnv.NODE_ID] = str(node.id)
        env[NodeEnv.NODE_RANK] = str(node.rank_index)
        env[NodeEnv.RESTART_COUNT] = str(node.relaunch_count)
        command = self._commands.get(node.type) or (
            self._command if node.type == NodeType.WORKER else None
        )
        if not command:
            logger.error(
                "no command configured for role %r (node %s); "
                "declare spec.%s.command", node.type, node.name,
                node.type,
            )
            node.set_exit_reason(NodeExitReason.FATAL_ERROR)
            self._emit(node, NodeStatus.FAILED)
            return
        cmd = list(command)
        try:
            proc = subprocess.Popen(cmd, env=env)
        except Exception as e:
            logger.error("launch %s failed: %s", node.name, e)
            node.set_exit_reason(NodeExitReason.FATAL_ERROR)
            self._emit(node, NodeStatus.FAILED)
            return
        with self._lock:
            self._procs[(node.type, node.id)] = proc
            self._nodes[(node.type, node.id)] = node
        node.create_time = time.time()
        node.start_time = time.time()
        self._emit(node, NodeStatus.RUNNING)
        logger.info("Launched %s (pid %d)", node.name, proc.pid)

    def _kill_node(self, node: Node):
        with self._lock:
            proc = self._procs.pop((node.type, node.id), None)
            self._nodes.pop((node.type, node.id), None)
        if proc and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
        self._emit(node, NodeStatus.DELETED,
                   event_type=NodeEventType.DELETED)

    def _monitor_procs(self):
        while not self._stopped.wait(0.5):
            with self._lock:
                finished = [
                    (key, p) for key, p in self._procs.items()
                    if p.poll() is not None
                ]
                ended = []
                for key, proc in finished:
                    self._procs.pop(key, None)
                    ended.append((proc, self._nodes.pop(key, None)))
            # status emission (journal + callbacks) happens outside the
            # lock, on the snapshot taken above
            for proc, node in ended:
                if node is None:
                    continue
                rc = proc.returncode
                if rc == 0:
                    self._emit(node, NodeStatus.SUCCEEDED)
                else:
                    # exit-code -> exit-reason mapping (parity:
                    # k8s_watcher.py:49 classifying OOM/killed/fatal)
                    if rc in (-9, 137):
                        node.set_exit_reason(NodeExitReason.OOM)
                    elif rc in (-15, 143):
                        node.set_exit_reason(NodeExitReason.KILLED)
                    else:
                        node.set_exit_reason(NodeExitReason.UNKNOWN)
                    self._emit(node, NodeStatus.FAILED)

    def _emit(self, node: Node, status: str,
              event_type: str = NodeEventType.MODIFIED):
        snap = Node(
            node.type, node.id, name=node.name, status=status,
            rank_index=node.rank_index,
            relaunch_count=node.relaunch_count,
        )
        snap.exit_reason = node.exit_reason
        self.watcher.push(NodeEvent(event_type, snap))

    def stop(self):
        self._stopped.set()
        with self._lock:
            procs = list(self._procs.values())
            self._procs.clear()
        for p in procs:
            if p.poll() is None:
                p.terminate()
