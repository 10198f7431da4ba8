"""Training metric records stored by the stats pipeline.

Parity reference: dlrover/python/master/stats/training_metrics.py:22-160
(TrainingHyperParams, DatasetMetric, TensorStats, OpStats, ModelMetric,
RuntimeMetric). A copy of ``dlrover_tpu/master/stats/training_metrics.py``:
OpStats carries the step profile's numbers (trainer/profiler.py: the
FLOPs ``torch.utils.flop_counter`` counts in one forward and backward)
where the reference counts TF graph ops.
"""

import time
from dataclasses import dataclass, field
from typing import Dict, List


class CustomMetricKey:
    INIT_TRAINING_TIME = "init_training_time"
    RECOVERY_SECONDS = "recovery_seconds"


@dataclass
class TrainingHyperParams:
    batch_size: int = 0
    epoch: int = 0
    max_steps: int = 0


@dataclass
class DatasetMetric:
    name: str = ""
    size: int = 0
    ds_type: str = "text"
    storage_size: int = 0


@dataclass
class TensorStats:
    """Parameter statistics of the model (parity: TensorStats)."""

    variable_count: int = 0
    total_variable_size: int = 0  # elements
    max_variable_size: int = 0


@dataclass
class OpStats:
    """Compiled-program statistics (parity: OpStats — the reference
    counts TF ops; XLA exposes flops + bytes via cost analysis)."""

    op_count: int = 0
    flops: float = 0.0  # per train step
    hbm_bytes: float = 0.0  # bytes accessed per step
    peak_memory_bytes: float = 0.0
    input_fetch_dur: float = 0.0


@dataclass
class ModelMetric:
    tensor_stats: TensorStats = field(default_factory=TensorStats)
    op_stats: OpStats = field(default_factory=OpStats)
    batch_size: int = 0
    seq_len: int = 0


@dataclass
class RuntimeMetric:
    """One sample of the job's runtime state (parity: RuntimeMetric)."""

    running_nodes: List[Dict] = field(default_factory=list)
    worker_num: int = 0
    global_step: int = 0
    speed: float = 0.0  # steps/sec
    timestamp: float = 0.0

    def clear(self):
        self.running_nodes = []
        self.worker_num = 0
        self.global_step = 0
        self.speed = 0.0
        self.timestamp = 0.0
