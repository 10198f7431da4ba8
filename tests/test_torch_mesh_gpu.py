"""Phase "mesh" of chip_smoke.py on the card: the sharding strategies
across gloo ranks on ``cuda:0`` -- zero1, zero2, fsdp and tp at two
ranks, tp_fsdp at four -- against the port's one-process step on the
card, with the fsdp save restored into fresh ranks and into one rank
(at 2 layers); and the phase's gates against planted faults (at the
phase's 4 layers): a zero1 step without the sum over the data-parallel
ranks and an fsdp step without the update must each fail the parameter
gate. Marked ``gpu``: it skips on a machine without one; run it on a GPU
with ``python -m pytest --noconftest tests/test_torch_mesh_gpu.py -m gpu
-s`` (``-s`` shows the planted runs' readings)."""

import json
import os
import sys

import pytest
import torch

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ranks share the card")
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def test_mesh_phase_at_two_layers():
    chip_smoke = _chip_smoke()
    got = chip_smoke.run_mesh(layers=2)
    assert got["failed"] == [], got["failed"]
    readings = got["readings"]
    assert readings["route"] == ["direct"]
    assert set(readings["strategies"]) == {
        "zero1", "zero2", "fsdp", "tp", "tp_fsdp"}
    for name, line in readings["strategies"].items():
        assert all(ms > 0 for ms in line["step_ms"]), name


def test_mesh_gates_fail_planted_faults():
    chip_smoke = _chip_smoke()
    plants = {"zero1": "no_reduce", "fsdp": "no_step"}
    spec = [("fsdp", 2)]
    got = chip_smoke.run_mesh(
        runs={2: [("zero1", spec), ("fsdp", spec)]}, plants=plants)
    keys = ("plant", "loss_rel", "param_within_2lr_share",
            "param_equal_share", "update_rel_err", "param_diff_lr")
    print(json.dumps({"planted": {
        s: {k: line[k] for k in keys}
        for s, line in got["readings"]["strategies"].items()},
        "failed": got["failed"]}))
    for strategy in plants:
        assert any(f.startswith(f"{strategy} rank ")
                   and "parameters" in f for f in got["failed"]), (
            strategy, got["failed"])
    # what a plant leaves sound still holds: the bytes, the launches, the
    # save's restores
    assert all("parameters" in f or "losses" in f for f in got["failed"]), (
        got["failed"])
