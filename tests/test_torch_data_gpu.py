"""DevicePrefetch and the elastic shm feed on the card: batches staged
on a copy stream from page-locked memory land intact while each step is
held behind a long device spin (staging overlaps the step's reads, and
a staged batch's memory is not handed on while a step still reads it),
on the device asked for, and an error of the transform reaches the
consumer. Marked ``gpu``: they skip on a machine without one; run them
on a GPU with ``python -m pytest --noconftest tests/test_torch_*gpu*.py
-m gpu`` (the repo's conftest imports JAX, which a GPU machine need not
have)."""

import os

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.data import shm_ring, synth
from dlrover_tpu_torch.data.elastic_shm import ElasticShmDataLoader
from dlrover_tpu_torch.data.shm_dataloader import DevicePrefetch

pytestmark = pytest.mark.gpu

#: cycles of the spin that stands for a step (about 5 ms at 2 GHz)
SPIN = 10_000_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: staging copies run on the card")
    return torch.device("cuda", 0)


def _batches(n, shape=(3, 2048)):
    for i in range(n):
        yield np.random.default_rng(i).integers(
            0, 32000, shape, dtype=np.int32)


def test_contents_hold_while_steps_overlap_the_staging(cuda):
    """Each "step" spins on the current stream, then reads its batch;
    the reference is taken on the card after the spin, and each batch
    is dropped at once, so its memory goes back to the allocator while
    the step's reads are still queued."""
    n = 24
    copies = []
    for batch in DevicePrefetch(_batches(n), depth=2, device=cuda):
        assert batch.device == cuda and batch.dtype == torch.int32
        torch.cuda._sleep(SPIN)
        copies.append(batch.to(torch.int64) + 0)  # read after the spin
        del batch
    torch.cuda.synchronize()
    want = list(_batches(n))
    assert len(copies) == n
    for got, ref in zip(copies, want):
        assert torch.equal(got.cpu(), torch.from_numpy(ref).long())


def test_default_device_is_the_current_gpu_and_host_leaves_stay(cuda):
    def transform(batch):
        return batch.astype(np.int64), ("rows", int(batch[0, 0]))

    pre = DevicePrefetch(_batches(3), transform=transform)
    assert pre.device == cuda
    for batch, (tag, first) in pre:
        assert batch.device == cuda and batch.dtype == torch.int64
        assert tag == "rows" and int(batch[0, 0]) == first


def test_a_transform_error_reaches_the_consumer(cuda):
    def bad(batch):
        if int(batch[0, 0]) == int(list(_batches(3))[2][0, 0]):
            raise ValueError("planted at the third batch")
        return batch

    got = []
    with pytest.raises(ValueError, match="planted"):
        for batch in DevicePrefetch(_batches(5), device=cuda,
                                    transform=bad):
            got.append(batch)
    assert len(got) == 2


def test_elastic_shm_feed_on_the_card(cuda):
    from dlrover_tpu_torch.master.local_master import LocalJobMaster

    master = LocalJobMaster(port=0)
    master.prepare()
    try:
        loader = ElasticShmDataLoader(
            synth.ShardBatch(2048, 32000), dataset_name="gpu",
            batch_size=3, dataset_size=24, num_workers=2,
            master_addr=master.addr, slot_bytes=1 << 20)
        seen = []
        for tokens, targets, rows in loader:
            assert tokens.device == cuda
            start, end = rows.tolist()
            torch.cuda._sleep(SPIN)
            ref = torch.from_numpy(synth.synth_batch(
                start, end, 2048, 32000)[0])
            assert torch.equal(tokens.cpu(), ref)
            seen.extend(range(start, end))
        loader.shutdown()
    finally:
        master.stop()
    assert sorted(seen) == list(range(24))
    assert not shm_ring.segments_of(os.getpid())
