"""Singleton runtime configuration.

Parity reference: dlrover/python/common/global_context.py:54 (Context) — the
master's tunable knobs, overridable from env or an external optimizer service.
"""

import os
import threading
from typing import Any, Dict


class DefaultValues:
    SERVER_PORT = 0
    TRAIN_SPEED_RECORD_NUM = 50
    SECONDS_TO_START_AUTOSCALE_WORKER = 90
    STEP_TO_ADJUST_WORKER = 200
    OPTIMIZE_WORKER_CPU_THRESHOLD = 20
    SECONDS_FOR_STABLE_WORKER_COUNT = 60
    SECONDS_INTERVAL_TO_OPTIMIZE = 300
    FACTOR_TO_CUT_PENDING_CPU = 2
    FACTOR_TO_CUT_PENDING_MEM = 2
    SECONDS_TO_WAIT_FAILED_PS = 600
    HANG_CPU_USAGE_RATE = 0.05
    HANG_DETECTION_INTERVAL = 1800
    SECONDS_TO_WAIT_PENDING_POD = 900
    SECONDS_INTERVAL_TO_CHANGE_WORKER = 300
    RELAUNCH_ERROR_MAX_COUNT = 3
    RDZV_JOIN_TIMEOUT = 600
    NODE_HEARTBEAT_TIMEOUT = 180
    TASK_PROCESS_TIMEOUT = 1800


class Context:
    """Process-wide config singleton with env overrides."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        self.master_port = DefaultValues.SERVER_PORT
        self.train_speed_record_num = DefaultValues.TRAIN_SPEED_RECORD_NUM
        self.seconds_to_autoscale_worker = (
            DefaultValues.SECONDS_TO_START_AUTOSCALE_WORKER
        )
        self.step_to_adjust_worker = DefaultValues.STEP_TO_ADJUST_WORKER
        self.hang_cpu_usage_percentage = DefaultValues.HANG_CPU_USAGE_RATE
        self.hang_detection_interval = DefaultValues.HANG_DETECTION_INTERVAL
        self.seconds_to_wait_pending_pod = (
            DefaultValues.SECONDS_TO_WAIT_PENDING_POD
        )
        self.seconds_interval_to_optimize = (
            DefaultValues.SECONDS_INTERVAL_TO_OPTIMIZE
        )
        self.relaunch_error_max_count = DefaultValues.RELAUNCH_ERROR_MAX_COUNT
        self.rdzv_join_timeout = DefaultValues.RDZV_JOIN_TIMEOUT
        self.node_heartbeat_timeout = DefaultValues.NODE_HEARTBEAT_TIMEOUT
        self.task_process_timeout = DefaultValues.TASK_PROCESS_TIMEOUT
        self.relaunch_always = False
        self.auto_worker_enabled = False
        self.auto_ps_enabled = False
        self.is_tfv1_ps = False
        self.user_defined = {}  # type: Dict[str, Any]
        self._load_env_overrides()

    def _load_env_overrides(self):
        prefix = "DLROVER_TPU_CTX_"
        for key, value in os.environ.items():
            if not key.startswith(prefix):
                continue
            attr = key[len(prefix):].lower()
            if hasattr(self, attr):
                cur = getattr(self, attr)
                if isinstance(cur, bool):
                    setattr(self, attr, value.lower() in ("1", "true", "yes"))
                elif isinstance(cur, int):
                    setattr(self, attr, int(value))
                elif isinstance(cur, float):
                    setattr(self, attr, float(value))
                else:
                    setattr(self, attr, value)

    def set_params_from_optimizer(self, params: Dict[str, Any]):
        """Apply cluster-optimizer-tuned params (parity:
        global_context.py:95 set_params_from_brain)."""
        for key, value in params.items():
            if hasattr(self, key):
                setattr(self, key, value)
            else:
                self.user_defined[key] = value

    @classmethod
    def singleton_instance(cls) -> "Context":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance
