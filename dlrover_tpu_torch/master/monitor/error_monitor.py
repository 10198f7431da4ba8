"""Error-log monitor: classify worker-reported failures.

Parity reference: dlrover/python/master/monitor/error_monitor.py:31.
A copy of ``dlrover_tpu/master/monitor/error_monitor.py``.
"""

from dlrover_tpu_torch.common.constants import TrainingExceptionLevel
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import record


class ErrorMonitor:
    def __init__(self, quarantine=None):
        self._restart_errors = {}
        #: QuarantineManager (master/node/quarantine.py) when the
        #: master arms one: the servicer reaches it through here, and
        #: the job manager consults it at relaunch placement
        self.quarantine = quarantine

    def process_error(self, node, restart_count: int, error_data: str,
                      level: str) -> bool:
        """Returns True if the error is critical (node should not relaunch)."""
        # worker-reported failures must reach the telemetry substrate,
        # not just the master's log file: the journal timeline is what
        # post-mortems and `dump` replay
        record(
            "node.error", node=str(getattr(node, "name", node)),
            restart_count=restart_count, level=level,
            error=str(error_data)[:500],
        )
        if level == TrainingExceptionLevel.PROCESS_ERROR:
            return self._handle_process_error(node, restart_count, error_data)
        if level == TrainingExceptionLevel.NODE_ERROR:
            logger.error("Node error on %s: %s", node, error_data)
            return True
        if level == TrainingExceptionLevel.RDZV_ERROR:
            logger.error("Rendezvous error: %s", error_data)
        elif level == TrainingExceptionLevel.WARNING:
            logger.warning("Worker warning: %s", error_data)
        else:
            logger.info("Worker report: %s", error_data)
        return False

    def _handle_process_error(self, node, restart_count: int,
                              error_data: str) -> bool:
        node_key = getattr(node, "id", node)
        prev = self._restart_errors.get(node_key)
        self._restart_errors[node_key] = (restart_count, error_data)
        # dedup on (restart_count, error_data): a second DIFFERENT
        # error inside the same restart is new information, only the
        # byte-identical re-report of the same incident is suppressed
        if prev == (restart_count, error_data):
            return False
        logger.error(
            "Process error on node %s (restart %d): %s",
            node_key, restart_count, error_data,
        )
        return False
