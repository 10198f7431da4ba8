"""Elastic training agent: one per node, supervising its training process.

Parity reference: dlrover/python/elastic_agent/torch/training.py:215
(ElasticTrainingAgent, _rendezvous:251, _invoke_run:365,
_membership_changed:446, launch_agent:465).

Counterpart of ``dlrover_tpu/agent/elastic/training.py``. The agent
  1. joins the master rendezvous,
  2. derives the process group's bootstrap (coordinator address, the
     host's index and the number of hosts) from the sorted comm world —
     the lowest-rank node elects a coordinator address and publishes it
     via the master KV store; the training processes meet there with
     ``torch.distributed`` (``trainer/distributed.init_from_env``),
  3. spawns ``nproc_per_node`` training processes with the bootstrap in
     env vars (the ``NodeEnv`` set, with ``DLROVER_TPU_PROCESS_ID`` the
     host's index, plus ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``, so that
     a process's global rank is ``process_id x local_world +
     local_rank``). The JAX agent runs one process per host, which
     drives all of the host's chips; the torch way is one process per
     GPU, and ``init_from_env`` gives each its ``LOCAL_RANK`` card (a
     rank without one raises, never sharing a card unasked),
  4. monitors them, and on membership change (a waiting node appears),
     the exit of any one of them, or the master's restart action (a
     reported hang) kills the whole local group and restarts it; the
     new processes restore from the flash checkpoint. A worker that
     drained after a preemption notice (exit code ``DRAIN_EXIT_CODE``,
     21) is reported PREEMPTED and not restarted: the host is being
     reclaimed, and the restart budget is not charged. The master's
     DRAIN action sends every worker's group SIGTERM.

With ``network_check`` set, :func:`launch_agent` first runs the
pre-flight check (``network_check.py``): two probe rounds through the
master's network-check rendezvous; a node that fails them reports
BREAKDOWN and the launch ends with rc 1. A replacement node (relaunched,
``DLROVER_TPU_RESTART_COUNT`` above 0) skips it.

The agent serves its host's ``/metrics``, ``/goodput`` and ``/healthz``
(telemetry/http.py; an ephemeral port unless
``DLROVER_TPU_METRICS_PORT`` pins or disables it) and arms its own
goodput ledger, whose phases follow the events it journals.
Not ported yet (ROADMAP.md, queue A): the relay tier's report lane and
the persistent compile cache.
"""

import os
import signal
import socket
import subprocess
import threading
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.constants import (
    NodeAction,
    NodeEnv,
    NodeExitReason,
    NodeStatus,
    RendezvousConstant,
    RendezvousName,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common.grpc_utils import find_free_port
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.fault_tolerance.drain import DRAIN_EXIT_CODE
from dlrover_tpu_torch.telemetry import counter, goodput, record
from dlrover_tpu_torch.telemetry.http import start_metrics_server


@dataclass
class ElasticLaunchConfig:
    """Launch config (parity: torchelastic LaunchConfig + dlrover extras)."""

    min_nodes: int = 1
    max_nodes: int = 1
    nproc_per_node: int = 1
    node_rank: int = 0
    rdzv_timeout: float = 30.0
    node_unit: int = 1
    max_restarts: int = 3
    monitor_interval: float = 3.0
    heartbeat_interval: float = 15.0
    network_check: bool = False
    entrypoint: str = ""
    args: List[str] = field(default_factory=list)
    env: Dict[str, str] = field(default_factory=dict)


class WorkerState:
    HEALTHY = "healthy"
    FAILED = "failed"
    SUCCEEDED = "succeeded"
    RESTARTING = "restarting"


@dataclass
class RunResult:
    state: str
    return_code: int = 0


def _local_ip(master_addr: str) -> str:
    """This host's address on the interface that reaches the master —
    the one its peers, which reach the same master, can dial."""
    host, _, port = master_addr.rpartition(":")
    if not host:
        return "127.0.0.1"
    try:
        with socket.create_connection((host, int(port)), timeout=5) as s:
            return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"


class MasterRendezvousHandler:
    """Join/poll the master rendezvous and derive the process group's
    bootstrap (parity: training.py:75 MasterRendezvousHandler)."""

    def __init__(self, master_client: MasterClient, node_rank: int,
                 local_world_size: int,
                 rdzv_name: str = RendezvousName.TRAINING,
                 join_timeout: float = RendezvousConstant.JOIN_TIMEOUT,
                 rdzv_params: Optional[tuple] = None):
        self._client = master_client
        self._node_rank = node_rank
        self._local_world_size = local_world_size
        self._rdzv_name = rdzv_name
        self._join_timeout = join_timeout
        #: (min_nodes, max_nodes, waiting_timeout, node_unit) —
        #: re-reported before EVERY join so a relaunched (HA) master
        #: relearns them; no round can complete against the defaults
        #: (rdzv_manager._params_reported), so a single startup-time
        #: report from rank 0 would deadlock a master restart
        self._rdzv_params = rdzv_params

    def next_rendezvous(self):
        """Block until a world forms. Returns
        (round, world, process_id, num_processes, coordinator_addr)."""
        start = time.time()

        def _hello():
            if self._rdzv_params is not None:
                try:
                    self._client.report_rdzv_params(*self._rdzv_params)
                except Exception as e:
                    logger.warning("rdzv params report failed: %s", e)
            return self._client.join_rendezvous(
                self._node_rank, self._local_world_size, self._rdzv_name
            )

        rdzv_round = _hello()
        # a master replaced DURING the poll below lost our join (the
        # waiting set is not part of its durable state) — re-hello on
        # every reconnect or the poll spins on an empty world until
        # join_timeout. Scoped to the poll: re-joining outside a
        # rendezvous would signal a spurious membership change.
        add_hook = getattr(self._client, "add_reconnect_hook", None)
        if add_hook is not None:
            add_hook(f"rdzv:{self._rdzv_name}", _hello)
        try:
            while True:
                rdzv_round, group, world = self._client.get_comm_world(
                    self._rdzv_name, self._node_rank
                )
                if world and self._node_rank in world:
                    break
                if time.time() - start > self._join_timeout:
                    raise TimeoutError(
                        f"Rendezvous {self._rdzv_name} timed out after "
                        f"{self._join_timeout}s; world={world}"
                    )
                time.sleep(RendezvousConstant.POLL_INTERVAL)
        finally:
            remove = getattr(self._client, "remove_reconnect_hook", None)
            if remove is not None:
                remove(f"rdzv:{self._rdzv_name}")

        sorted_ranks = sorted(world)
        # processes are laid out host-major in join order of node rank
        process_id = 0
        for r in sorted_ranks:
            if r == self._node_rank:
                break
            process_id += world[r]
        num_processes = sum(world.values())
        coordinator = self._elect_coordinator(
            rdzv_round, group, sorted_ranks[0] == self._node_rank
        )
        return rdzv_round, world, process_id, num_processes, coordinator

    def _elect_coordinator(self, rdzv_round: int, group: int,
                           is_rank0: bool) -> str:
        """The lowest-rank node of this round's (group-scoped) world
        publishes a fresh coordinator host:port via the master KV store;
        everyone else polls it. Keyed by round AND group so concurrent
        network-check pair groups never cross-connect."""
        key = f"{self._rdzv_name}/coordinator/{rdzv_round}/{group}"
        if is_rank0:
            master_addr = getattr(self._client, "master_addr", "")
            addr = f"{_local_ip(master_addr)}:{find_free_port()}"
            self._client.kv_store_set(key, addr.encode())
            return addr
        start = time.time()
        while True:
            value = self._client.kv_store_get(key)
            if value:
                return value.decode()
            if time.time() - start > self._join_timeout:
                raise TimeoutError("Waiting for coordinator address timeout")
            time.sleep(0.5)


class ElasticTrainingAgent:
    """Supervises one node's training process through elastic restarts."""

    def __init__(self, config: ElasticLaunchConfig,
                 master_client: MasterClient,
                 start_method: str = "subprocess"):
        if config.nproc_per_node < 1:
            raise ValueError(
                f"nproc_per_node={config.nproc_per_node}: at least one "
                "worker per node")
        self._config = config
        self._client = master_client
        self._rdzv_handler = MasterRendezvousHandler(
            master_client, config.node_rank, config.nproc_per_node,
            rdzv_params=(
                config.min_nodes, config.max_nodes,
                config.rdzv_timeout, config.node_unit,
            ),
        )
        self._restart_count = 0
        #: the node's workers, LOCAL_RANK order
        self._procs: List[subprocess.Popen] = []
        self._stopped = False
        self._remaining_restarts = config.max_restarts
        self._status_reporter = None
        self._restart_requested = threading.Event()
        # per-host scrape point (the master serves its own): ephemeral
        # port unless DLROVER_TPU_METRICS_PORT pins/disables it
        self._metrics_server = start_metrics_server()
        # per-process goodput ledger: phases derive from the events
        # this agent already journals (scale.restart,
        # rendezvous.joined, agent.master_lost/_reconnected) via the
        # journal tap — no extra calls needed here
        self._goodput = goodput.install()

    @property
    def _proc(self) -> Optional[subprocess.Popen]:
        """The first worker (LOCAL_RANK 0), None before any start: the
        JAX agent's one worker process, which the JAX package's agent
        tests read (tests/test_torch_master_service.py runs them against
        this agent)."""
        return self._procs[0] if self._procs else None

    def _handle_master_action(self, action: str):
        """Act on the directive the master piggybacks on the report ack
        (parity: the reference agent's DiagnosisAction handling). A
        ``restart`` action recycles the training process on the monitor
        loop without charging the restart budget — the node stays
        RUNNING and the reporter keeps heartbeating throughout."""
        if action == NodeAction.RESTART_WORKER:
            logger.info("Master heartbeat action: restart workers")
            self._restart_requested.set()
        elif action == NodeAction.DRAIN:
            logger.warning(
                "Master heartbeat action: drain (platform "
                "reclaim ahead) — SIGTERM worker group"
            )
            record(
                "preempt.drain_action",
                node_rank=self._config.node_rank,
            )
            # SIGTERM only: the worker's DrainCoordinator
            # runs its notice-window sequence and exits
            # rc 21; this agent stays up to classify it
            self._signal_worker_group(signal.SIGTERM)
        elif action == NodeAction.STOP:
            logger.info("Master heartbeat action: stop")
            # full stop: end the monitor loop AND kill the
            # training process (an orphaned trainer would
            # keep the GPU busy after the node "succeeded")
            self.stop()

    def _start_heartbeat(self, interval: float = 15.0):
        """Feed the master's liveness watchdog via the coalesced
        ``report_node_status`` path (agent/status_reporter.py): one
        delta rpc per interval carrying the heartbeat,
        ±20% jittered so a master restart doesn't face the whole
        fleet's reports back in phase."""
        from dlrover_tpu_torch.agent.status_reporter import StatusReporter

        self._status_reporter = StatusReporter(
            self._client, interval,
            incarnation=self._restart_count,
            on_action=self._handle_master_action,
        )
        # a replaced master has no delta baseline for this agent; it
        # will reply resync=True on first contact, but re-sending full
        # proactively on reconnect saves that round-trip
        add_hook = getattr(self._client, "add_reconnect_hook", None)
        if add_hook is not None:
            add_hook(
                "report-resync",
                self._status_reporter._tracker.request_full,
            )
        self._status_reporter.start()

    # ------------------------------------------------------------ lifecycle

    def run(self) -> RunResult:
        """The agent main loop (parity: _invoke_run training.py:365)."""
        self._client.update_node_status(NodeStatus.RUNNING)
        # re-hello: a replaced master rebuilds its node table from agent
        # traffic — re-announce RUNNING on every reconnect so the
        # heartbeat watchdog doesn't declare this live node dead
        add_hook = getattr(self._client, "add_reconnect_hook", None)
        if add_hook is not None:
            add_hook(
                "node-status",
                lambda: self._client.update_node_status(
                    NodeStatus.RUNNING, "", self._restart_count
                ),
            )
        self._start_heartbeat(self._config.heartbeat_interval)
        try:
            result = self._invoke_run()
        except Exception as e:
            logger.exception("Agent error: %s", e)
            self._client.report_failure(
                str(e), TrainingExceptionLevel.NODE_ERROR,
                self._restart_count,
            )
            self._remove_rehello_hook()
            self._client.update_node_status(NodeStatus.FAILED, str(e))
            return RunResult(WorkerState.FAILED, 1)
        finally:
            # the worker is gone: so is this node's liveness signal
            self._status_reporter.stop()
        status = (
            NodeStatus.SUCCEEDED
            if result.state == WorkerState.SUCCEEDED
            else NodeStatus.FAILED
        )
        # drop the hook BEFORE the terminal status report: a reconnect
        # after SUCCEEDED must not resurrect the node as RUNNING
        self._remove_rehello_hook()
        self._client.update_node_status(status)
        return result

    def _remove_rehello_hook(self):
        remove = getattr(self._client, "remove_reconnect_hook", None)
        if remove is not None:
            remove("node-status")

    def _invoke_run(self) -> RunResult:
        self._initialize_workers()
        while not self._stopped:
            time.sleep(self._config.monitor_interval)
            if self._stopped:
                # stop() raced in during the sleep (heartbeat STOP
                # action): the worker it killed must NOT be relaunched
                break
            result = self._monitor_workers()
            if self._stopped:
                # stop() landed while we were inspecting the worker it
                # just SIGTERM'd: the FAILED verdict *is* the stop —
                # reporting it or relaunching would orphan a fresh
                # trainer past loop exit
                break
            if result.state == WorkerState.SUCCEEDED:
                logger.info("Training process succeeded")
                return result
            if result.state == WorkerState.FAILED:
                if result.return_code == DRAIN_EXIT_CODE:
                    # graceful drain (fault_tolerance/drain.py): the
                    # worker already checkpointed, relinquished its
                    # shards and reported PREEMPTED. A local relaunch
                    # is pointless — the host is being reclaimed.
                    # Report PREEMPTED (idempotent with the worker's
                    # own report_preemption; covers the race where
                    # that RPC was lost) and exit so the master
                    # relaunches the NODE without charging its budget.
                    logger.warning(
                        "Worker drained gracefully (rc=%d); node is "
                        "being preempted", DRAIN_EXIT_CODE,
                    )
                    record(
                        "preempt.worker_exit",
                        node_rank=self._config.node_rank,
                        restart_count=self._restart_count,
                    )
                    self._client.update_node_status(
                        NodeStatus.FAILED, NodeExitReason.PREEMPTED,
                        self._restart_count,
                    )
                    return result
                self._report_failure(result)
                if result.return_code in (137, -9):
                    # OOM-class death: a LOCAL relaunch cannot help —
                    # the same memory limit kills it again. Escalate to
                    # the master (parity: the reference never restarts
                    # an OOM pod in place; the job manager relaunches
                    # the NODE with a grown allocation,
                    # dist_job_manager adjust_oom_resource): report the
                    # reason and exit with the OOM code so the platform
                    # scaler maps it (process_scaler.py rc 137 -> OOM)
                    logger.error(
                        "Worker died with OOM-class rc=%d; escalating "
                        "to the master for a grown relaunch",
                        result.return_code,
                    )
                    self._client.update_node_status(
                        NodeStatus.FAILED, NodeExitReason.OOM,
                        self._restart_count,
                    )
                    return result
                if self._remaining_restarts > 0:
                    self._remaining_restarts -= 1
                    logger.info(
                        "Restarting workers (%d restarts left)",
                        self._remaining_restarts,
                    )
                    self._restart_workers(
                        "process_failure", rc=result.return_code
                    )
                else:
                    return result
            elif self._restart_requested.is_set():
                self._restart_requested.clear()
                logger.info(
                    "Restarting workers on master action (hang recovery)"
                )
                self._restart_workers("master_action")
            elif self._membership_changed():
                logger.info(
                    "Membership changed; re-rendezvous without job restart"
                )
                self._restart_workers("membership_change")
        return RunResult(WorkerState.SUCCEEDED)

    def _initialize_workers(self):
        rdzv_round, world, process_id, num_processes, coordinator = (
            self._rdzv_handler.next_rendezvous()
        )
        logger.info(
            "Round %d world=%s -> process_id=%d/%d coordinator=%s",
            rdzv_round, world, process_id, num_processes, coordinator,
        )
        record(
            "rendezvous.joined", round=rdzv_round,
            node_rank=self._config.node_rank, world=sorted(world),
            process_id=process_id, num_processes=num_processes,
            restart_count=self._restart_count,
        )
        nproc = self._config.nproc_per_node
        if any(n != nproc for n in world.values()):
            raise ValueError(
                f"workers per node differ across the world {world}: the "
                "global rank process_id x local_world + local_rank needs "
                "one count")
        env = dict(os.environ)
        env.update(self._config.env)
        env[NodeEnv.COORDINATOR_ADDR] = coordinator
        # the host's index among the world's hosts; its workers tell
        # themselves apart by LOCAL_RANK
        env[NodeEnv.PROCESS_ID] = str(process_id // nproc)
        env[NodeEnv.NUM_PROCESSES] = str(num_processes // nproc)
        env[NodeEnv.NODE_RANK] = str(self._config.node_rank)
        env[NodeEnv.NODE_ID] = str(self._config.node_rank)
        env[NodeEnv.NODE_NUM] = str(len(world))
        env[NodeEnv.RESTART_COUNT] = str(self._restart_count)
        env[NodeEnv.RDZV_ROUND] = str(rdzv_round)
        env[NodeEnv.MASTER_ADDR] = self._client.master_addr
        # torchrun's names, read by trainer/distributed.read_dist_env
        env["LOCAL_WORLD_SIZE"] = str(nproc)
        if nproc > 1:
            # as torchrun does: several workers of one host would each
            # start a thread per core, and their CPU collectives starve
            env.setdefault("OMP_NUM_THREADS", "1")
        # Make the framework importable in the spawned process even when it
        # is not pip-installed and the entrypoint lives in another directory
        # (``python script.py`` puts the script's dir on sys.path, not cwd).
        pkg_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))))
        parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
        if pkg_root not in parts:
            # appended, so user PYTHONPATH overrides still take precedence
            env["PYTHONPATH"] = os.pathsep.join(parts + [pkg_root])
        cmd = [self._config.entrypoint] + list(self._config.args)
        if cmd[0].endswith(".py"):
            cmd = [sys.executable] + cmd
        # own session per worker: each trainer and its children form one
        # process group, so group-wide signals hit its whole training
        # tree without touching the agent or launcher above it
        self._procs = [
            subprocess.Popen(cmd, env={**env, "LOCAL_RANK": str(local)},
                             start_new_session=True)
            for local in range(nproc)
        ]
        self._restart_count += 1

    def _monitor_workers(self) -> RunResult:
        """HEALTHY while every worker runs (or some finished with 0 and
        the others run), SUCCEEDED once all exited 0, and FAILED with
        the first non-zero code as soon as any worker exits with one:
        the whole local group is then ended."""
        if not self._procs:
            return RunResult(WorkerState.FAILED, 1)
        rcs = [p.poll() for p in self._procs]
        failed = [rc for rc in rcs if rc not in (None, 0)]
        if not failed and None in rcs:
            return RunResult(WorkerState.HEALTHY)
        # a worker is gone, crashed or drained: its peers and its
        # coworkers are not (os._exit leaves daemon children running)
        # -- end them, and unlink its rings, before anything reports or
        # relaunches
        self._kill_workers()
        if not failed:
            return RunResult(WorkerState.SUCCEEDED, 0)
        return RunResult(WorkerState.FAILED, failed[0])

    def _membership_changed(self) -> bool:
        """A node is waiting for a new round -> re-rendezvous
        (parity: training.py:446)."""
        return self._client.num_nodes_waiting() > 0

    def _restart_workers(self, reason: str = "unspecified", **extra):
        counter(
            "dlrover_agent_worker_restarts_total",
            "Training-process restarts by trigger", ["reason"],
        ).labels(reason=reason).inc()
        record(
            "scale.restart", reason=reason,
            node_rank=self._config.node_rank,
            restart_count=self._restart_count, **extra,
        )
        self._kill_workers()
        self._initialize_workers()

    def _kill_workers(self, grace: float = 10.0):
        """End every worker's whole session group, leaders first, and
        unlink the shm rings each leader left. A group outlives its
        leader: a crash (``os._exit``) or a drain (rc 21) leaves the
        coworker producers alive under a dead trainer, fetching shards
        for it and blocked on a ring nobody reads. The JAX agent returns
        once the leader has exited
        (``dlrover_tpu/agent/elastic/training.py:505-507``) and never
        signals them; this one does, and waits for every group to be
        gone before a successor starts."""
        if not self._procs:
            return
        running = [p for p in self._procs if p.poll() is None]
        for proc in running:
            _signal_group(proc, signal.SIGTERM)
        deadline = time.monotonic() + grace
        for proc in running:
            try:
                proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                _signal_group(proc, signal.SIGKILL)
                proc.wait()
        for proc in self._procs:
            _end_group(proc, grace)

    def _signal_worker_group(self, sig):
        """Signal each worker's own session group (start_new_session at
        spawn: its id is the leader's pid, and stays valid while any
        member lives, the leader gone or not) so coworker children die
        with the trainer."""
        for proc in self._procs:
            _signal_group(proc, sig)

    def _report_failure(self, result: RunResult):
        self._client.report_failure(
            f"training process exited rc={result.return_code}",
            TrainingExceptionLevel.PROCESS_ERROR,
            self._restart_count,
        )

    def stop(self):
        self._stopped = True
        if self._status_reporter is not None:
            self._status_reporter.stop()
        self._kill_workers()
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None


def _signal_group(proc: subprocess.Popen, sig) -> None:
    """Signal ``proc``'s session group; fall back to the single pid if
    the group is already gone."""
    try:
        os.killpg(proc.pid, sig)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            proc.send_signal(sig)
        except (ProcessLookupError, OSError):
            pass


def _end_group(proc: subprocess.Popen, grace: float) -> None:
    """End what is left of an exited worker's session group (its
    coworkers), then unlink the shm rings the worker left."""
    pgid = proc.pid
    left = _group_members(pgid)
    if left:
        logger.info("Ending %d processes left in the worker's group "
                    "%d: %s", len(left), pgid, left)
        _signal_group(proc, signal.SIGTERM)
        deadline = time.monotonic() + grace
        while left and time.monotonic() < deadline:
            time.sleep(0.05)
            left = _group_members(pgid)
        if left:
            _signal_group(proc, signal.SIGKILL)
            deadline = time.monotonic() + grace
            while _group_members(pgid) and time.monotonic() < deadline:
                time.sleep(0.05)
    from dlrover_tpu_torch.data.shm_ring import unlink_segments_of

    unlinked = unlink_segments_of(pgid)
    if unlinked:
        logger.info("Unlinked the rings of worker %d: %s", pgid, unlinked)


def _group_members(pgid: int) -> List[int]:
    """Live (not zombie) processes of process group ``pgid``, from
    ``/proc``; where there is no ``/proc``, ``[pgid]`` while a signal
    can still reach the group."""
    if not os.path.isdir("/proc"):
        try:
            os.killpg(pgid, 0)
            return [pgid]
        except OSError:
            return []
    members = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        # after the command: state, ppid, pgrp
        if fields[0] not in ("Z", "X") and int(fields[2]) == pgid:
            members.append(int(entry))
    return members


def launch_agent(config: ElasticLaunchConfig,
                 master_client: MasterClient) -> RunResult:
    """Run the network check (optional), then the elastic agent
    (parity: launch_agent training.py:465)."""
    relaunched = int(os.getenv(NodeEnv.RESTART_COUNT, "0") or 0) > 0
    if config.network_check and relaunched:
        # a REPLACEMENT node joining a running job skips the pre-flight
        # check: its rendezvous needs min_nodes checkers at once, and
        # the healthy survivors, who passed it already, never re-join
        logger.info(
            "Replacement node (relaunch %s): skipping the pre-flight "
            "network check", os.getenv(NodeEnv.RESTART_COUNT, "0"))
    elif config.network_check:
        from dlrover_tpu_torch.agent.elastic.network_check import (
            NetworkCheckElasticAgent,
        )

        if not NetworkCheckElasticAgent(config, master_client).run():
            logger.error("Network check failed; node unhealthy")
            master_client.update_node_status(
                NodeStatus.BREAKDOWN, "network check failed")
            return RunResult(WorkerState.FAILED, 1)
    agent = ElasticTrainingAgent(config, master_client)
    return agent.run()
