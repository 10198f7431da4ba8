"""Reshard-in-place on the card (``gpu`` marker; skips without one):
phase "reshard"'s logic at llama_tiny with head_dim 64 (the flash
kernels' width), two gloo ranks on ``cuda:0``: rank 1 lost after step 3
and the survivor's shrink, then a joiner's grow, every step through the
flash kernels, each migrated state bitwise the fresh
``restore(step=pinned)``, the steps after it against the one-process
step, and the planted stale-live migration caught.

    python -m pytest --noconftest tests/test_torch_reshard_gpu.py -m gpu -q -s
"""

import os
import sys

import pytest
import torch

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_shrink_and_grow_on_the_card_through_the_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ranks share the card")
    sys.path.insert(0, REPO)
    import chip_smoke

    got = chip_smoke.run_reshard(2, tiny=True)
    r = got["readings"]
    print({k: r[k] for k in ("adopt_to_completed_ms", "moves",
                             "launches", "losses")})
    assert got["failed"] == []
    assert r["moves"]["shrink"]["live"] > 0
    assert r["moves"]["shrink"]["store"] > 0
    assert r["moves"]["grow node 2"]["peer"] > 0
    assert r["planted_caught"]
    # every step of every rank launched the kernels (gated per step)
    assert all(v > 0 for v in r["launches"].values())
