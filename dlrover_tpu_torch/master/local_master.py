"""Standalone job master: servicer + task manager + rendezvous in one process.

Parity reference: dlrover/python/master/local_master.py:37 (LocalJobMaster).
Used both by ``--standalone`` launches (subprocess) and by tests as an
in-process fixture with a real loopback RPC server (the reference's
start_local_master pattern, dlrover/python/tests/test_utils.py:256).

Counterpart of ``dlrover_tpu/master/local_master.py`` without the
serving request router, the fleet and goodput aggregators, the resource
advisor and the metrics HTTP server, none of which is ported yet
(ROADMAP.md, queue A); its run loop is the JAX master's.
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
from dlrover_tpu_torch.master.shard.task_manager import TaskManager


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
        self._server, self.servicer = create_master_service(
            port,
            task_manager=self.task_manager,
            job_manager=self.job_manager,
            speed_monitor=self.speed_monitor,
            rdzv_managers=self.rdzv_managers,
            sync_service=self.sync_service,
            error_monitor=self.error_monitor,
        )
        self.port = self._server.port
        self._exit_code = 0
        self._exit_reason = ""

    @property
    def addr(self) -> str:
        return f"localhost:{self.port}"

    def prepare(self):
        self.job_manager.start()
        self.task_manager.start()
        self._server.start()
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
        self._server.stop(grace=1.0)
