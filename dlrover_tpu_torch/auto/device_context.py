"""What card the port runs on: its peak dense bf16 rate and memory.

Counterpart of ``dlrover_tpu/auto/device_context.py`` (the TPU chip
table), for NVIDIA cards read from ``torch.cuda.get_device_name()``. The
peak is the MFU denominator. Also resolves the port's default device:
the GPU, unless the caller names another.
"""

from typing import Optional, Union

import torch

#: (name fragment, peak dense bf16 FLOP/s, memory bytes, memory
#: bytes/s), most specific first; NVIDIA data sheets, dense rates
#: without sparsity
_CARDS = (
    ("h100 pcie", 756e12, 80e9, 2.0e12),
    ("h100", 989e12, 80e9, 3.35e12),  # SXM: "NVIDIA H100 80GB HBM3"
)


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
