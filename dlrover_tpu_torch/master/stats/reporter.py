"""Stats reporters: where collected metrics go.

Parity reference: dlrover/python/master/stats/reporter.py:55
(StatsReporter ABC, LocalStatsReporter:100, new_stats_reporter:87).
A copy of ``dlrover_tpu/master/stats/reporter.py`` without its
``brain`` reporter, which comes with the brain service (ROADMAP.md,
queue A item 7).
"""

import threading
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Dict, List

from dlrover_tpu_torch.master.stats.training_metrics import (
    DatasetMetric,
    ModelMetric,
    RuntimeMetric,
    TrainingHyperParams,
)


@dataclass
class JobMeta:
    uuid: str = ""
    name: str = ""
    namespace: str = "default"
    cluster: str = ""
    user: str = ""


class StatsReporter(ABC):
    """parity: reporter.py:55."""

    _reporters: Dict[str, "StatsReporter"] = {}
    _lock = threading.Lock()

    def __init__(self, job_meta: JobMeta):
        self._job_meta = job_meta

    @abstractmethod
    def report_dataset_metric(self, metric: DatasetMetric): ...

    @abstractmethod
    def report_training_hyper_params(self, params: TrainingHyperParams): ...

    @abstractmethod
    def report_model_metrics(self, metric: ModelMetric): ...

    @abstractmethod
    def report_runtime_stats(self, stats: RuntimeMetric): ...

    @abstractmethod
    def report_job_exit_reason(self, reason: str): ...

    @abstractmethod
    def report_customized_data(self, data): ...

    @classmethod
    def new_stats_reporter(cls, job_meta: JobMeta,
                           reporter: str = "local") -> "StatsReporter":
        """One reporter per job uuid (parity: new_stats_reporter:87).
        ``local`` keeps stats in master memory; the JAX package's
        ``brain`` reporter is not ported."""
        if reporter == "brain":
            raise NotImplementedError(
                "the brain stats reporter is not ported (ROADMAP.md, "
                "queue A item 7)")
        key = f"{reporter}/{job_meta.uuid}"
        with cls._lock:
            if key not in cls._reporters:
                cls._reporters[key] = LocalStatsReporter(job_meta)
            return cls._reporters[key]


class LocalStatsReporter(StatsReporter):
    """In-memory store (parity: reporter.py:100) — the source the local
    resource optimizer reads its speed window from."""

    def __init__(self, job_meta: JobMeta):
        super().__init__(job_meta)
        self._lock = threading.Lock()
        self.dataset_metric: DatasetMetric = DatasetMetric()
        self.hyper_params: TrainingHyperParams = TrainingHyperParams()
        self.model_metric: ModelMetric = ModelMetric()
        self.runtime_stats: List[RuntimeMetric] = []
        self.exit_reason: str = ""
        self.custom_data: Dict = {}
        self.max_runtime_samples = 200

    def report_dataset_metric(self, metric: DatasetMetric):
        self.dataset_metric = metric

    def report_training_hyper_params(self, params: TrainingHyperParams):
        self.hyper_params = params

    def report_model_metrics(self, metric: ModelMetric):
        self.model_metric = metric

    def report_runtime_stats(self, stats: RuntimeMetric):
        with self._lock:
            self.runtime_stats.append(stats)
            if len(self.runtime_stats) > self.max_runtime_samples:
                self.runtime_stats.pop(0)

    def report_job_exit_reason(self, reason: str):
        self.exit_reason = reason

    def report_customized_data(self, data):
        self.custom_data.update(data or {})

    # -- queries (resource optimizer) ------------------------------------

    def speed_samples_by_worker_num(self) -> Dict[int, List[float]]:
        """worker_num -> positive speed samples, for scaling decisions."""
        out: Dict[int, List[float]] = {}
        with self._lock:
            for rec in self.runtime_stats:
                if rec.speed > 0 and rec.worker_num > 0:
                    out.setdefault(rec.worker_num, []).append(rec.speed)
        return out


class TeeStatsReporter(StatsReporter):
    """Fan one collector's reports out to several reporters (e.g. the
    in-memory window the resource optimizer reads AND the durable brain
    archive). A failing secondary never breaks the primary path."""

    def __init__(self, job_meta: JobMeta, reporters: List[StatsReporter]):
        super().__init__(job_meta)
        self._targets = list(reporters)

    def _fan(self, method: str, *args):
        for r in self._targets:
            try:
                getattr(r, method)(*args)
            except Exception:  # archive outage must not stop stats
                pass

    def report_dataset_metric(self, metric: DatasetMetric):
        self._fan("report_dataset_metric", metric)

    def report_training_hyper_params(self, params: TrainingHyperParams):
        self._fan("report_training_hyper_params", params)

    def report_model_metrics(self, metric: ModelMetric):
        self._fan("report_model_metrics", metric)

    def report_runtime_stats(self, stats: RuntimeMetric):
        self._fan("report_runtime_stats", stats)

    def report_job_exit_reason(self, reason: str):
        self._fan("report_job_exit_reason", reason)

    def report_customized_data(self, data):
        self._fan("report_customized_data", data)
