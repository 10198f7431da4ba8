"""Phase "auto" of chip_smoke.py on the card: the flash kernels at
gpt2_small's heads over two tensor ranks (B=8, S=1024, H=KVH=6, D=64)
against their plain versions, planted faults failing; the one-process
search over llama_1b at batch 3 x 2048 (the top 2 dryrun, the winner's
steps bitwise ``make_trainer_for_llama``'s, ``dryrun_abstract``'s bytes,
no dryrun error but out of memory or an indivisible split); one step at
batch 1 x ``SINGLE_CHIP_MAX_SEQ`` under 0.9 x the card's memory; and the
two-rank group (two gloo ranks on ``cuda:0``): the search over llama_1b
at 4 layers with BO, both ranks on the same winner and seconds, a
planned table, gpt2_small under tp at its 50,257 vocab and the CNN
under fsdp, each against its one-process
step. Marked ``gpu``: it skips on a machine without one; run it on a GPU
with ``python -m pytest --noconftest tests/test_torch_auto_gpu.py -m gpu
-s``."""

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


def test_kernels_at_gpt2_small_tp_shape():
    chip_smoke = _chip_smoke()
    out = chip_smoke.check_kernels(chip_smoke.GPT_TP, timed=False)
    assert set(out) == {"fwd", "dq", "dkv"}


def test_one_process_search_and_envelope():
    chip_smoke = _chip_smoke()
    search = chip_smoke.run_auto_search()
    print(json.dumps(search["readings"]["estimates_on_the_card"]))
    assert search["failed"] == [], search["failed"]
    envelope = chip_smoke.run_auto_envelope()
    assert envelope["failed"] == [], envelope["failed"]


def test_two_rank_search_and_layouts():
    chip_smoke = _chip_smoke()
    got = chip_smoke.run_auto_mesh(layers=4)
    print(json.dumps(got["readings"]["search"]["strategy"]))
    assert got["failed"] == [], got["failed"]
