"""Phases "sequence" and "moe" of chip_smoke.py on the card, at 2 layers:
the "sequence" strategy on (seq 2) -- ring attention with the flash
kernels per chunk (a ring that drops every chunk but the diagonal must
fail the gates), then Ulysses -- against the one-process step at 16,384
tokens, with the ring Function alone against its plain version; the MoE
Llama under tp_fsdp on (expert 2) against the one process; and the
flash kernels at the ring's chunk shape (causal and non-causal) and at
Ulysses' shape against their plain versions. Two gloo ranks share
``cuda:0``. Marked ``gpu``: it skips on a machine without one; run it
on a GPU with ``python -m pytest --noconftest
tests/test_torch_context_parallel_gpu.py -m gpu -s``."""

import json
import os
import sys

import pytest
import torch

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels and the ranks' card")
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("shape", ["RING_CHUNK", "RING_FULL", "ULYSSES"])
def test_kernels_at_the_sequence_shapes(shape):
    chip_smoke = _chip_smoke()
    out = chip_smoke.check_kernels(getattr(chip_smoke, shape), timed=False)
    assert set(out) == {"fwd", "dq", "dkv"}


def test_sequence_phase_at_two_layers():
    chip_smoke = _chip_smoke()
    got = chip_smoke.run_sequence(layers=2)
    print(json.dumps({k: v["loss_rel"] for k, v in
                      got["readings"]["runs"].items()}))
    assert got["failed"] == [], got["failed"]
    assert got["readings"]["routes"]["ppermute"] == "host"
    assert all(r["ok"] for r in got["readings"]["ring_alone"])


def test_moe_phase_at_two_layers():
    chip_smoke = _chip_smoke()
    got = chip_smoke.run_moe(layers=2)
    assert got["failed"] == [], got["failed"]
    assert all(r["routing_equal"] for r in got["readings"]["ranks"])
