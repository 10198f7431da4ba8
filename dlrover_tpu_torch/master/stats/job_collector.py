"""Job metric collector: RPC-fed metrics -> reporter.

Parity reference: dlrover/python/master/stats/job_collector.py:78
(JobMetricCollector: collect_dataset_metric, collect_model_metric,
collect_runtime_stats + the periodic report thread). A copy of
``dlrover_tpu/master/stats/job_collector.py``: model metrics arrive as
one ModelInfo message per training process (the FLOPs of the step
profile, dlrover_tpu_torch/trainer/profiler.py) instead of TF
tensor/op scans, and runtime sampling is gated on global-step advance
rather than a wall-clock thread.
"""

import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.stats.reporter import JobMeta, StatsReporter
from dlrover_tpu_torch.master.stats.training_metrics import (
    CustomMetricKey,
    DatasetMetric,
    ModelMetric,
    OpStats,
    RuntimeMetric,
    TensorStats,
    TrainingHyperParams,
)


def _catch(fn):
    def wrapper(self, *args, **kwargs):
        try:
            return fn(self, *args, **kwargs)
        except Exception as e:
            logger.warning("JobMetricCollector.%s failed: %s",
                           fn.__name__, e)

    return wrapper


class JobMetricCollector:
    """parity: job_collector.py:78."""

    def __init__(self, job_meta: Optional[JobMeta] = None, reporter=None,
                 min_sample_interval: float = 1.0):
        self._job_meta = job_meta or JobMeta()
        self._reporter = reporter or StatsReporter.new_stats_reporter(
            self._job_meta
        )
        self._last_sampled_step = 0
        # event-driven feeds (per-task completions) would otherwise
        # snapshot+serialize every running node on EVERY report RPC;
        # the reference samples on a 15s clock
        self._min_sample_interval = min_sample_interval
        self._last_sample_time = 0.0
        self._custom = {}

    @property
    def reporter(self):
        return self._reporter

    @_catch
    def collect_dataset_metric(self, name: str, size: int,
                               ds_type: str = "text"):
        self._reporter.report_dataset_metric(
            DatasetMetric(name=name, size=size, ds_type=ds_type)
        )

    @_catch
    def collect_training_hyper_params(self, epoch: int, batch_size: int):
        self._reporter.report_training_hyper_params(
            TrainingHyperParams(batch_size=batch_size, epoch=epoch)
        )

    @_catch
    def collect_model_metric(self, info):
        """``info``: comm.ModelInfo from rpc_report_model_info."""
        extra = dict(getattr(info, "extra", {}) or {})
        metric = ModelMetric(
            tensor_stats=TensorStats(
                variable_count=int(extra.get("variable_count", 0)),
                total_variable_size=int(info.param_count),
                max_variable_size=int(extra.get("max_variable_size", 0)),
            ),
            op_stats=OpStats(
                flops=float(info.flops_per_step),
                hbm_bytes=float(extra.get("hbm_bytes", 0.0)),
                peak_memory_bytes=float(
                    extra.get("peak_memory_bytes", 0.0)),
                input_fetch_dur=float(extra.get("input_fetch_dur", 0.0)),
            ),
            batch_size=int(info.batch_size),
            seq_len=int(info.seq_len),
        )
        self._reporter.report_model_metrics(metric)

    @_catch
    def collect_runtime_stats(self, speed_monitor, running_nodes):
        """Sample once per global-step advance (parity:
        collect_runtime_stats + report_runtime_stats_periodically — the
        step gate replaces the reference's 15s thread).

        ``running_nodes`` may be a list OR a zero-arg callable returning
        one: callers on hot RPC paths (every accepted task report) pass
        the callable so the node-list snapshot is only materialized when
        the rate limiter actually takes a sample."""
        if speed_monitor is None:
            return
        now = time.time()
        if now - self._last_sample_time < self._min_sample_interval:
            return
        speed = speed_monitor.running_speed()
        step = speed_monitor.completed_global_step
        if step < self._last_sampled_step:
            # the monitor's step counter went BACKWARD: its source
            # switched (batch feed -> real global steps, which resets
            # the window) — follow it or sampling stalls until the new
            # unit outruns the old count
            self._last_sampled_step = step
        if speed <= 0 or step <= self._last_sampled_step:
            return
        self._last_sampled_step = step
        self._last_sample_time = now
        if callable(running_nodes):
            running_nodes = running_nodes() or []
        def node_dict(n):
            d = n.to_dict() if hasattr(n, "to_dict") else dict(n)
            used = getattr(n, "used_resource", None)
            if used is not None and "used_memory_mb" not in d:
                d["used_memory_mb"] = getattr(used, "memory", 0)
            return d

        metric = RuntimeMetric(
            running_nodes=[node_dict(n) for n in running_nodes],
            worker_num=len(speed_monitor.running_workers),
            global_step=step,
            speed=speed,
            timestamp=time.time(),
        )
        self._reporter.report_runtime_stats(metric)
        init_t = getattr(speed_monitor, "start_training_time", 0)
        if init_t and CustomMetricKey.INIT_TRAINING_TIME not in self._custom:
            self._custom[CustomMetricKey.INIT_TRAINING_TIME] = (
                init_t - getattr(speed_monitor, "_init_time", init_t)
            )
            self._reporter.report_customized_data(self._custom)

    @_catch
    def collect_custom_data(self, key: str, value):
        self._custom[key] = value
        self._reporter.report_customized_data({key: value})

    @_catch
    def collect_custom_metrics(self, data: Dict):
        """One report = one row: keys that belong together (an eval
        step with its metrics) stay together in the archive."""
        self._custom.update(data)
        self._reporter.report_customized_data(dict(data))

    @_catch
    def collect_job_exit_reason(self, reason: str):
        self._reporter.report_job_exit_reason(reason)
