"""Utilization from a step's FLOPs, time and the card's peak.

Counterpart of ``utilization`` in ``dlrover_tpu/trainer/profiler.py``;
the rest of that module (XLA cost analysis, step profiles) is not ported
yet.
"""


def utilization(flops_per_step: float, step_time_s: float,
                peak_flops: float) -> float:
    """Percent of peak: ``100 * (flops/step / step_time) / peak``. Feed it
    the analytic model FLOPs for MFU."""
    if step_time_s <= 0 or peak_flops <= 0:
        return 0.0
    return 100.0 * (flops_per_step / step_time_s) / peak_flops
