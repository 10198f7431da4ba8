"""Phase "pipeline" of chip_smoke.py on the card: llama_1b at full width
cut to 4 layers, batch 4 x 2048 in 4 pipeline microbatches, under the
"pipeline" strategy on (pipe 2) -- GPipe, then the interleaved schedule
with two chunks a stage -- against the one-process step, and a GPipe
run with the planted fault (the embedding's gradient not summed over
pipe), which must fail the parameter gate (less than 99.9% of a rank's
kept elements within 2 lr and one ulp) while the sound runs pass every
gate; and the flash kernels at the microbatch's shape against their
plain versions. Two gloo ranks share ``cuda:0``. Marked ``gpu``: it
skips on a machine without one; run it on a GPU with ``python -m pytest
--noconftest tests/test_torch_pipeline_gpu.py -m gpu -s``."""

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


def test_kernels_at_the_microbatch_shape():
    chip_smoke = _chip_smoke()
    out = chip_smoke.check_kernels(chip_smoke.PIPE_MB, timed=False)
    assert set(out) == {"fwd", "dq", "dkv"}


def test_pipeline_phase_sound_and_planted():
    chip_smoke = _chip_smoke()
    got = chip_smoke.run_pipeline(layers=4)
    runs = got["readings"]["runs"]
    print(json.dumps({k: [v["loss_rel"], v["param_within_2lr_share"]]
                      for k, v in runs.items()}))
    assert got["failed"] == [], got["failed"]
    for kind in ("gpipe", "interleaved"):
        assert min(runs[kind]["param_within_2lr_share"]) >= \
            chip_smoke.MESH_WITHIN_SHARE
        assert runs[kind]["replicated_equal"]
    assert min(runs["gpipe_planted"]["param_within_2lr_share"]) < \
        chip_smoke.MESH_WITHIN_SHARE
