"""Per-host resource monitor thread.

Parity reference: dlrover/python/elastic_agent/monitor/resource.py:88 — psutil
CPU/mem plus device memory stats reported to the master every interval.

Counterpart of ``dlrover_tpu/agent/monitor/resource.py``. Its TPU probe
(``get_tpu_stats``, over jax's ``memory_stats``) becomes
:func:`get_device_stats` over ``torch.cuda.memory_stats``, with the same
fields: the caching allocator's bytes in use and their peak
(``torch.cuda.memory_allocated`` and ``max_memory_allocated``), and the
card's memory as the limit. torch is imported inside that probe only,
which only a training process calls (``collect_device=True``): the agent
and the master import no torch.

Every sample is also exported as labeled gauges in the telemetry
registry, under the JAX package's names, so this host's ``/metrics``
shows live device-memory watermarks
(``dlrover_tpu_hbm_bytes_in_use{device=...}`` and the monotonic
``dlrover_tpu_hbm_peak_bytes``) alongside CPU/RSS; a new per-device
peak journals a ``resource.hbm_peak`` event, putting OOM-adjacent
high-water marks on the same timeline as the saves/rescales that
caused them.
"""

import threading
from typing import Dict, List

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import gauge, record

try:
    import psutil
except ImportError:  # pragma: no cover
    psutil = None


def get_process_cpu_percent() -> float:
    if psutil is None:
        return 0.0
    try:
        return psutil.cpu_percent(interval=None)
    except Exception:
        return 0.0


def get_used_memory_mb() -> int:
    if psutil is None:
        return 0
    try:
        return int(psutil.virtual_memory().used / 1024 / 1024)
    except Exception:
        return 0


def get_device_stats() -> List[Dict]:
    """Memory of each visible CUDA device, from the caching allocator's
    counters: bytes in use, their peak since the last reset, and the
    card's memory. Empty without a CUDA device."""
    import torch

    stats = []
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        m = torch.cuda.memory_stats(i)
        stats.append({
            "device": f"cuda:{i}",
            "bytes_in_use": int(m.get("allocated_bytes.all.current", 0)),
            "bytes_limit": int(
                torch.cuda.get_device_properties(i).total_memory),
            "peak_bytes_in_use": int(
                m.get("allocated_bytes.all.peak", 0)),
        })
    return stats


class ResourceMonitor:
    """Background thread reporting host usage to the master."""

    def __init__(self, master_client, interval: float = 15.0,
                 collect_device: bool = False):
        self._master_client = master_client
        self._interval = interval
        self._collect_device = collect_device
        self._stopped = threading.Event()
        self._thread = None
        self.total_cpu_percent = 0.0
        self.total_memory_mb = 0
        # per-device memory high-water marks (bytes); a new peak is a
        # journaled event, not just a gauge move
        self._hbm_peaks: Dict[str, int] = {}

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._report_loop, daemon=True, name="resource-monitor"
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()

    def _report_loop(self):
        while not self._stopped.is_set():
            try:
                self.report_resource()
            except Exception as e:
                logger.warning("Resource report failed: %s", e)
            self._stopped.wait(self._interval)

    def report_resource(self):
        self.total_cpu_percent = get_process_cpu_percent()
        self.total_memory_mb = get_used_memory_mb()
        devices = get_device_stats() if self._collect_device else []
        self._export_metrics(devices)
        # the wire field keeps the JAX message's name
        self._master_client.report_used_resource(
            self.total_cpu_percent, self.total_memory_mb, devices
        )
        return devices

    def _export_metrics(self, device_stats: List[Dict]):
        """Mirror the sample into the telemetry registry (this host's
        /metrics) and journal new per-device memory peaks. Never raises
        — monitoring must not take the report loop down."""
        try:
            gauge(
                "dlrover_node_cpu_percent",
                "Host CPU utilization sampled by the resource monitor",
            ).set(float(self.total_cpu_percent))
            gauge(
                "dlrover_node_memory_used_mb",
                "Host memory in use (MB)",
            ).set(float(self.total_memory_mb))
            for s in device_stats:
                device = str(s.get("device", "?"))
                in_use = int(s.get("bytes_in_use", 0) or 0)
                limit = int(s.get("bytes_limit", 0) or 0)
                gauge(
                    "dlrover_tpu_hbm_bytes_in_use",
                    "Accelerator HBM bytes currently in use",
                    ["device"],
                ).labels(device=device).set(in_use)
                if limit:
                    gauge(
                        "dlrover_tpu_hbm_bytes_limit",
                        "Accelerator HBM capacity in bytes",
                        ["device"],
                    ).labels(device=device).set(limit)
                peak = max(
                    in_use, int(s.get("peak_bytes_in_use", 0) or 0)
                )
                prev = self._hbm_peaks.get(device, 0)
                if peak > prev:
                    self._hbm_peaks[device] = peak
                    gauge(
                        "dlrover_tpu_hbm_peak_bytes",
                        "High-water mark of HBM bytes in use",
                        ["device"],
                    ).labels(device=device).set(peak)
                    record(
                        "resource.hbm_peak", device=device,
                        bytes=peak, bytes_limit=limit,
                        prev_bytes=prev,
                    )
        except Exception as e:
            logger.warning("resource metric export failed: %s", e)
