"""What card the port runs on: its peak dense bf16 rate, memory, memory
rate and link rate, and the snapshot the strategy search reads.

Counterpart of ``dlrover_tpu/auto/device_context.py`` (the TPU chip
table and ``DeviceContext``), for NVIDIA cards read from
``torch.cuda.get_device_name()``. The peak is the MFU denominator; the
link rate is the analyser's and the planner's collective bandwidth
(``auto/analyser.py``, ``auto/planner.py``). Also resolves the port's
default device: the GPU, unless the caller names another.
"""

import dataclasses
import os
from typing import Optional, Union

import torch

#: (name fragment, peak dense bf16 FLOP/s, memory bytes, memory bytes/s,
#: NVLink bytes/s per direction), most specific first; NVIDIA data
#: sheets, dense rates without sparsity (NVLink: 900 GB/s both ways on
#: the SXM card, 600 GB/s over the PCIe card's bridge)
_CARDS = (
    ("h100 pcie", 756e12, 80e9, 2.0e12, 300e9),
    ("h100", 989e12, 80e9, 3.35e12, 450e9),  # SXM: "NVIDIA H100 80GB HBM3"
)
#: the card the port targets: a search ranked on the CPU (the tests)
#: ranks for it
TARGET_CARD = "NVIDIA H100 80GB HBM3"


def _card(name: Optional[str]):
    if name is None:
        name = torch.cuda.get_device_name()
    key = name.lower()
    for fragment, *numbers in _CARDS:
        if fragment in key:
            return numbers
    raise ValueError(
        f"no peak rate known for {name!r}; add it to "
        "dlrover_tpu_torch.auto.device_context._CARDS"
    )


def peak_flops_per_chip(name: Optional[str] = None) -> float:
    """Peak dense bf16 FLOP/s of the card called ``name`` (default: the
    current CUDA device)."""
    return _card(name)[0]


def hbm_bytes_per_chip(name: Optional[str] = None) -> float:
    """Device memory bytes of the card called ``name`` (default: the
    current CUDA device)."""
    return _card(name)[1]


def hbm_bytes_per_second(name: Optional[str] = None) -> float:
    """Device memory rate (bytes/s) of the card called ``name`` (default:
    the current CUDA device); the byte side of a roofline bound."""
    return _card(name)[2]


def link_bytes_per_second(name: Optional[str] = None) -> float:
    """NVLink rate (bytes/s, one direction) of the card called ``name``
    (default: the current CUDA device)."""
    return _card(name)[3]


@dataclasses.dataclass(frozen=True)
class DeviceContext:
    """Snapshot of the ranks the strategy search targets."""

    platform: str
    device_kind: str
    num_devices: int  # the world's ranks
    num_hosts: int
    devices_per_host: int
    hbm_bytes: float  # per device
    peak_flops: float  # per device, dense bf16
    link_bandwidth: float  # bytes/s per direction
    host_cpu_count: int
    host_memory_mb: int

    @property
    def total_hbm_bytes(self) -> float:
        return self.hbm_bytes * self.num_devices

    @property
    def total_peak_flops(self) -> float:
        return self.peak_flops * self.num_devices


def build_device_context(device=None) -> DeviceContext:
    """The context of ``device`` (None: the GPU) across the process
    group's ranks: the card's numbers from :data:`_CARDS`; on the CPU
    those of :data:`TARGET_CARD`, the card a CPU search ranks for."""
    import torch.distributed as dist

    device = resolve_device(device)
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else device.type
    peak, hbm, _, link = _card(kind if cuda else TARGET_CARD)
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.getenv("LOCAL_WORLD_SIZE", "1") or 1)
    hosts = max(1, world // max(local, 1))
    host_mem_mb = int(os.sysconf("SC_PAGE_SIZE")
                      * os.sysconf("SC_PHYS_PAGES") / 2**20)
    return DeviceContext(
        platform="gpu" if cuda else device.type, device_kind=kind,
        num_devices=world, num_hosts=hosts,
        devices_per_host=world // hosts, hbm_bytes=hbm, peak_flops=peak,
        link_bandwidth=link, host_cpu_count=os.cpu_count() or 1,
        host_memory_mb=host_mem_mb)


_CONTEXTS = {}


def get_device_context(device=None) -> DeviceContext:
    """:func:`build_device_context`, cached per device and world size."""
    import torch.distributed as dist

    device = resolve_device(device)
    key = (str(device),
           dist.get_world_size() if dist.is_initialized() else 1)
    if key not in _CONTEXTS:
        _CONTEXTS[key] = build_device_context(device)
    return _CONTEXTS[key]


def resolve_device(
    device: Union[None, str, torch.device] = None,
) -> torch.device:
    """``None`` means the GPU: it raises where there is none, and never
    carries on quietly on the CPU. Pass ``"cpu"`` to ask for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; "
                "pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
