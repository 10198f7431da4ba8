from dlrover_tpu_torch.fault_tolerance.hanging_detector import HangingDetector
from dlrover_tpu_torch.fault_tolerance.injection import FaultInjector

__all__ = [
    "HangingDetector",
    "FaultInjector",
]
