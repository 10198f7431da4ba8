"""Phase "mesh"'s "rowwise" run of chip_smoke.py on the card: two gloo
ranks on ``cuda:0`` train criteo_wide_deep with the tables' rows split
over (data 1, fsdp 2) against the port's one-process step from the same
seed, and a planted control: the same ranks with the lookup's sum over
fsdp left out must fail the parity gate. Marked ``gpu``: it skips on a
machine without one; run it on a GPU with ``python -m pytest
--noconftest tests/test_torch_rowwise_gpu.py -m gpu -s`` (``-s`` shows
the readings)."""

import json

import pytest

from tests.test_torch_mesh_gpu import _chip_smoke

pytestmark = pytest.mark.gpu

SPEC = [("data", 1), ("fsdp", 2)]


@pytest.mark.parametrize("plant", [None, "no_allreduce"],
                         ids=["sound", "no_allreduce"])
def test_rowwise_parity_gate(plant):
    chip_smoke = _chip_smoke()
    got = chip_smoke.run_mesh(runs={2: [("rowwise", SPEC)]},
                              plants={"rowwise": plant} if plant else None,
                              rowwise_scale=False)
    line = got["readings"]["rowwise"]
    print(json.dumps({"plant": plant, "loss_rel": line["loss_rel"],
                      "param_err_max": line["param_err_max"],
                      "failed": got["failed"]}))
    if plant is None:
        assert got["failed"] == [], got["failed"]
    else:
        assert any(f.startswith("rowwise rank ") for f in got["failed"]), (
            got["failed"])
