"""Standalone job master: servicer + task manager + rendezvous in one process.

Parity reference: dlrover/python/master/local_master.py:37 (LocalJobMaster).
Used both by ``--standalone`` launches (subprocess) and by tests as an
in-process fixture with a real loopback RPC server (the reference's
start_local_master pattern, dlrover/python/tests/test_utils.py:256).

Counterpart of ``dlrover_tpu/master/local_master.py``, with its
goodput aggregator (served at ``/goodput`` of the metrics server it
starts; ``DLROVER_TPU_METRICS_PORT`` pins the port, ``off`` disables)
and the job metric collector that the JAX package's distributed master
builds; like the JAX distributed master, it journals the job's final
account (``goodput.job_summary``) when it stops, and with a state dir
(``DLROVER_TPU_MASTER_STATE_DIR``) it checkpoints the aggregator through
the durable state journal (``master/state_journal.py``) and resumes a
prior incarnation's account from it, the gap counted as the master's
downtime, as the JAX distributed master does. Left out until they are
ported (ROADMAP.md, queue A): the
serving request router, the fleet aggregator (``/fleet`` answers 404)
and the resource advisor. Its run loop is the JAX master's.
"""

import time

from dlrover_tpu_torch.common.constants import JobExitReason, RendezvousName
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.elastic_training.rdzv_manager import (
    ElasticTrainingRendezvousManager,
    NetworkCheckRendezvousManager,
)
from dlrover_tpu_torch.master.elastic_training.sync_service import SyncService
from dlrover_tpu_torch.master.monitor.error_monitor import ErrorMonitor
from dlrover_tpu_torch.master.monitor.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.master.node.local_job_manager import LocalJobManager
from dlrover_tpu_torch.master.servicer import create_master_service
from dlrover_tpu_torch.master.state_journal import build_master_state_journal
from dlrover_tpu_torch.master.shard.task_manager import TaskManager
from dlrover_tpu_torch.master.stats import (
    JobMeta,
    JobMetricCollector,
    LocalStatsReporter,
)
from dlrover_tpu_torch.telemetry import goodput as goodput_mod
from dlrover_tpu_torch.telemetry import record
from dlrover_tpu_torch.telemetry.http import start_metrics_server


class LocalJobMaster:
    def __init__(self, port: int = 0, job_args=None):
        self.speed_monitor = SpeedMonitor()
        self.job_manager = LocalJobManager(
            job_args=job_args, speed_monitor=self.speed_monitor
        )
        self.task_manager = TaskManager(speed_monitor=self.speed_monitor)
        self.rdzv_managers = {
            RendezvousName.TRAINING: ElasticTrainingRendezvousManager(),
            RendezvousName.NETWORK_CHECK: NetworkCheckRendezvousManager(),
        }
        self.sync_service = SyncService(self.job_manager)
        self.error_monitor = ErrorMonitor()
        # durable job state (None unless a state dir is configured): the
        # goodput account survives a master restart through it
        self.state_journal = build_master_state_journal(
            getattr(job_args, "job_name", "") or "job")
        journal = self.state_journal
        self.goodput_aggregator = goodput_mod.GoodputAggregator(
            persist_fn=journal.save_goodput if journal else None,
            # with the commit lane on, a persist is one staged dict
            # update: the aggregator's 1/s throttle would only add
            # staleness
            persist_interval=0.0 if journal and journal.coalescing
            else 1.0)
        if journal is not None:
            prior = journal.load_goodput()
            if prior:
                # the window since the prior incarnation's last persist
                # is the master's own downtime, one more recovered fault
                self.goodput_aggregator.restore_state(prior)
        # a reporter of its own, as the JAX distributed master builds
        # it: the class-level registry of new_stats_reporter would let
        # two masters in one process share what they store
        self.stats_reporter = LocalStatsReporter(JobMeta())
        self.job_metric_collector = JobMetricCollector(
            reporter=self.stats_reporter)
        self._server, self.servicer = create_master_service(
            port,
            task_manager=self.task_manager,
            job_manager=self.job_manager,
            speed_monitor=self.speed_monitor,
            rdzv_managers=self.rdzv_managers,
            sync_service=self.sync_service,
            error_monitor=self.error_monitor,
            job_metric_collector=self.job_metric_collector,
            goodput_aggregator=self.goodput_aggregator,
        )
        self.port = self._server.port
        self._exit_code = 0
        self._exit_reason = ""
        self._metrics_server = None

    @property
    def addr(self) -> str:
        return f"localhost:{self.port}"

    @property
    def metrics_port(self) -> int:
        return self._metrics_server.port if self._metrics_server else 0

    def prepare(self):
        self.job_manager.start()
        self.task_manager.start()
        self._server.start()
        # /goodput serves this master's aggregation
        goodput_mod.set_job_provider(self.goodput_aggregator.summary)
        # Prometheus /metrics + /journal (telemetry/http.py);
        # DLROVER_TPU_METRICS_PORT pins the port, "off" disables
        self._metrics_server = start_metrics_server()
        logger.info("Local master serving on port %d", self.port)

    def run(self, check_interval: float = 3.0) -> int:
        """Block until all workers exit or all tasks complete."""
        try:
            while True:
                if self.job_manager.all_workers_exited():
                    if self.job_manager.all_workers_failed():
                        self._exit_code = 1
                        self._exit_reason = JobExitReason.UNKNOWN_ERROR
                    break
                if self.task_manager.finished():
                    # drain, don't slam the door: workers are about to
                    # see end-of-dataset and exit, and their agents
                    # still need the server up to report node status —
                    # stopping immediately turns a clean finish into
                    # 60s of connection-refused retries and rc 1
                    logger.info(
                        "All data tasks finished; draining workers"
                    )
                    deadline = time.time() + 30
                    while (
                        time.time() < deadline
                        and not self.job_manager.all_workers_exited()
                    ):
                        time.sleep(0.2)
                    break
                time.sleep(check_interval)
        except KeyboardInterrupt:
            logger.info("Master interrupted")
        finally:
            self.stop()
        return self._exit_code

    def stop(self):
        self.task_manager.stop()
        self.job_manager.stop()
        # journal the final job account before the server goes away, as
        # the JAX distributed master does: a post-mortem compares the
        # offline `dump --goodput` replay with this live total
        summary = self.goodput_aggregator.summary()
        if summary["job"]["procs"]:
            record("goodput.job_summary", **summary["job"])
        goodput_mod.set_job_provider(None)
        if self.state_journal is not None:
            self.state_journal.save_goodput(
                self.goodput_aggregator.to_state())
            self.state_journal.close()
        self._server.stop(grace=1.0)
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None
