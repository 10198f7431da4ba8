"""Repeat-offender host quarantine for silent-corruption attribution.

A single anomaly report is weak evidence — a loss spike can come from
the data or the optimizer as easily as from a flaky host. The same
physical host implicated *repeatedly* (across worker incarnations —
the count survives relaunches because it is keyed by host, not by node
id or pid) is the SDC signature the fleet papers describe, and the
response is surgical: evict the host's rank from rendezvous, keep the
host out of relaunch placement (the same ``avoid_hosts`` path the
Brain blacklist feeds), and let the job finish on the remaining nodes.

``DLROVER_TPU_QUARANTINE_THRESHOLD`` anomalies attributed to one host
impose the quarantine (default 2 — the second strike; 0 disables).

A copy of ``dlrover_tpu/master/node/quarantine.py``. The port's local
master arms none, as the JAX local master arms none; the distributed
job manager's ``handle_quarantine`` and relaunch placement wait for the
distributed master (ROADMAP.md, queue A).
"""

import os
import threading
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import gauge, record


class QuarantineManager:
    """Per-physical-host anomaly attribution and quarantine verdicts.

    ``placement_sink`` (optional) receives the full quarantined-host
    list whenever it grows — wired to the platform API's
    ``set_avoid_hosts`` (scheduler/gke.py) so pod placement schedules
    around the host exactly like a Brain-blacklisted one.
    """

    def __init__(
        self,
        threshold: Optional[int] = None,
        placement_sink: Optional[Callable[[List[str]], None]] = None,
    ):
        if threshold is None:
            threshold = int(os.environ.get(
                "DLROVER_TPU_QUARANTINE_THRESHOLD", "2"
            ))
        self._threshold = threshold
        self._placement_sink = placement_sink
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._quarantined: Dict[str, dict] = {}

    def set_placement_sink(
        self, sink: Callable[[List[str]], None]
    ) -> None:
        self._placement_sink = sink

    def note_anomaly(self, host: str, kind: str = "",
                     step: int = -1) -> bool:
        """Attribute one anomaly to ``host``; True when this report
        newly imposes the quarantine (the caller evicts the host's
        rank from rendezvous)."""
        if not host or self._threshold <= 0:
            return False
        with self._lock:
            self._counts[host] = self._counts.get(host, 0) + 1
            count = self._counts[host]
            if host in self._quarantined or count < self._threshold:
                return False
            self._quarantined[host] = {
                "anomalies": count, "kind": kind, "step": step,
            }
            hosts = sorted(self._quarantined)
        logger.error(
            "QUARANTINE: host %s implicated in %d anomalies "
            "(threshold %d, last kind=%s step=%d)", host, count,
            self._threshold, kind, step,
        )
        record(
            "quarantine.imposed", host=host, anomalies=count,
            threshold=self._threshold, anomaly=kind, step=step,
        )
        gauge(
            "dlrover_quarantined_hosts",
            "Hosts quarantined for repeated anomaly attribution",
        ).set(float(len(hosts)))
        if self._placement_sink is not None:
            try:
                self._placement_sink(hosts)
            except Exception as e:
                logger.warning(
                    "quarantine placement sink failed: %s", e
                )
        return True

    def is_quarantined(self, host: str) -> bool:
        with self._lock:
            return host in self._quarantined

    def quarantined_hosts(self) -> List[str]:
        with self._lock:
            return sorted(self._quarantined)

    def anomaly_count(self, host: str) -> int:
        with self._lock:
            return self._counts.get(host, 0)
