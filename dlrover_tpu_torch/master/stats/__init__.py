"""Stats pipeline: collector -> reporters -> metric records.

A copy of ``dlrover_tpu/master/stats`` (parity reference:
dlrover/python/master/stats/ job_collector.py, reporter.py,
training_metrics.py), with ``TeeStatsReporter`` exported too.
"""

from dlrover_tpu_torch.master.stats.job_collector import JobMetricCollector
from dlrover_tpu_torch.master.stats.reporter import (
    JobMeta,
    LocalStatsReporter,
    StatsReporter,
    TeeStatsReporter,
)
from dlrover_tpu_torch.master.stats.training_metrics import (
    CustomMetricKey,
    DatasetMetric,
    ModelMetric,
    OpStats,
    RuntimeMetric,
    TensorStats,
    TrainingHyperParams,
)

__all__ = [
    "JobMetricCollector", "JobMeta", "LocalStatsReporter",
    "StatsReporter", "TeeStatsReporter", "CustomMetricKey", "DatasetMetric", "ModelMetric",
    "OpStats", "RuntimeMetric", "TensorStats", "TrainingHyperParams",
]
