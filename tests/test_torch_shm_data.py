"""The port's shm ring and coworker loader on the CPU: the cases of
``tests/test_shm_data.py`` run against ``dlrover_tpu_torch.data``, the
batch framing byte-equal to the JAX package's both ways, rings shared
across the two packages, the library's place under ``build/native/``,
and DevicePrefetch's contract on the host (errors of the source, the
transform and a producer reach the consumer; no GPU, no default)."""

import multiprocessing as mp
import os
import pickle

import numpy as np
import pytest
import torch

from dlrover_tpu.data import shm_dataloader as jax_shm_dataloader
from dlrover_tpu.data import shm_ring as jax_shm_ring
from dlrover_tpu_torch.data import shm_ring, synth
from dlrover_tpu_torch.data.shm_dataloader import (
    DevicePrefetch,
    ShmDataLoader,
    _producer_main,
)
from dlrover_tpu_torch.data.shm_ring import RingClosed, ShmRing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _name(tag):
    return f"/dlrover_torch_test_{tag}_{os.getpid()}"


def test_ring_roundtrip_bytes():
    ring = ShmRing(_name("rt"), slot_bytes=1 << 16, num_slots=4)
    try:
        ring.push_bytes(b"hello tpu")
        assert len(ring) == 1
        assert ring.pop_bytes() == b"hello tpu"
        assert len(ring) == 0
    finally:
        ring.destroy()


def test_ring_numpy_framing_no_pickle():
    ring = ShmRing(_name("np"), slot_bytes=1 << 20, num_slots=4)
    try:
        x = np.arange(1000, dtype=np.float32).reshape(10, 100)
        y = np.arange(10, dtype=np.int64)
        ring.push((x, y))
        rx, ry = ring.pop()
        np.testing.assert_array_equal(rx, x)
        np.testing.assert_array_equal(ry, y)
        # arbitrary pytrees fall back to pickle
        ring.push({"a": x, "b": [1, 2]})
        out = ring.pop()
        np.testing.assert_array_equal(out["a"], x)
    finally:
        ring.destroy()


def test_ring_capacity_blocks_and_times_out():
    ring = ShmRing(_name("cap"), slot_bytes=1 << 10, num_slots=2)
    try:
        ring.push_bytes(b"a")
        ring.push_bytes(b"b")
        with pytest.raises(TimeoutError):
            ring.push_bytes(b"c", timeout_ms=200)
        assert ring.pop_bytes() == b"a"
        ring.push_bytes(b"c", timeout_ms=200)  # space freed
    finally:
        ring.destroy()


def test_ring_oversize_payload_rejected():
    ring = ShmRing(_name("big"), slot_bytes=64, num_slots=2)
    try:
        with pytest.raises(ValueError):
            ring.push_bytes(b"x" * 100)
    finally:
        ring.destroy()


def test_close_drains_then_raises():
    ring = ShmRing(_name("close"), slot_bytes=1 << 10, num_slots=4)
    try:
        ring.push_bytes(b"last")
        ring.close()
        assert ring.pop_bytes() == b"last"
        with pytest.raises(RingClosed):
            ring.pop_bytes(timeout_ms=1000)
    finally:
        ring.destroy()


def _producer_proc(name):
    ring = ShmRing.attach(name)
    for i in range(20):
        ring.push(np.full((4, 4), i, dtype=np.int32))


def test_cross_process_transport():
    name = _name("xproc")
    ring = ShmRing(name, slot_bytes=1 << 20, num_slots=4)
    try:
        ctx = mp.get_context("spawn")
        p = ctx.Process(target=_producer_proc, args=(name,))
        p.start()
        got = [int(ring.pop(timeout_ms=30_000)[0, 0]) for _ in range(20)]
        p.join(timeout=10)
        assert got == list(range(20))
    finally:
        ring.destroy()


def _batches():
    for i in range(12):
        yield np.full((2, 3), i, dtype=np.float32)


def test_shm_dataloader_end_to_end():
    # the batches of a torch-free module (the test module would cost
    # each coworker a JAX and a torch import)
    loader = ShmDataLoader(synth.SeededBatches(12, 2, 3, 100, seed=5),
                           num_workers=2, slot_bytes=1 << 20, num_slots=4)
    try:
        seen = sorted(tuple(t.ravel()) for t, _ in loader)
        want = sorted(tuple(t.ravel()) for t in synth.SeededBatches(
            12, 2, 3, 100, seed=5).expected())
        assert seen == want
    finally:
        loader.shutdown()
    assert not shm_ring.segments_of(os.getpid())


def test_device_prefetch_preserves_order():
    prefetched = list(DevicePrefetch(_batches(), depth=3, device="cpu"))
    assert [int(b[0, 0]) for b in prefetched] == list(range(12))
    assert all(isinstance(b, torch.Tensor) for b in prefetched)


# ---------------------------------------------------------------- parity

#: batches of every framing: one array of each dtype, a 0-d array, a
#: tuple, a list, and a tree that falls back to pickle
FRAMED = {
    "int32": np.arange(24, dtype=np.int32).reshape(2, 3, 4),
    "int64": np.arange(-5, 5, dtype=np.int64),
    "float32": np.linspace(-1, 1, 17, dtype=np.float32),
    "float16": np.linspace(-2, 2, 9).astype(np.float16),
    "zero_d": np.array(7, dtype=np.int64),
    "tuple": (np.ones((3, 2), np.float32), np.arange(3, dtype=np.int32)),
    "list": [np.zeros(4, np.uint8), np.full((2, 2), 3, np.int64)],
    "pytree": {"x": np.arange(4), "meta": ("shard", 3), "n": None},
    "noncontiguous": np.arange(20, dtype=np.int32).reshape(4, 5)[:, ::2],
}


def _equal(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return a == b


@pytest.mark.parametrize("kind", sorted(FRAMED))
def test_encode_is_byte_equal_to_jax_and_decodes_both_ways(kind):
    batch = FRAMED[kind]
    ours = shm_ring._encode(batch)
    assert ours == jax_shm_ring._encode(batch)
    assert ours[:4] == (b"DLRP" if kind == "pytree" else b"DLRN")
    for decode in (shm_ring._decode, jax_shm_ring._decode):
        back = decode(ours)
        # a list of arrays comes back a tuple in both packages
        want = tuple(batch) if kind == "list" else batch
        assert _equal(want, back), (kind, back)


def test_decode_rejects_unknown_framing():
    with pytest.raises(ValueError):
        shm_ring._decode(b"XXXX" + pickle.dumps(1))


def _drain(ring, n):
    return [ring.pop(timeout_ms=10_000) for _ in range(n)]


def test_rings_are_shared_with_the_jax_package_both_ways():
    """A JAX producer (``_producer_main``) fills a ring the port
    created and the port reads every batch intact; then a port producer
    fills a JAX ring and the JAX package reads it."""
    batches = [b for _, b in sorted(FRAMED.items())
               if not isinstance(b, dict)]
    ring = ShmRing(_name("port_owned"), slot_bytes=1 << 16,
                   num_slots=len(batches))
    try:
        jax_shm_dataloader._producer_main(
            ring.name, lambda: iter(batches), 0, 1, False)
        got = _drain(ring, len(batches))
    finally:
        ring.destroy()
    assert all(_equal(tuple(b) if isinstance(b, list) else b, g)
               for b, g in zip(batches, got))

    jring = jax_shm_ring.ShmRing(_name("jax_owned"), slot_bytes=1 << 16,
                                 num_slots=len(batches))
    try:
        _producer_main(jring.name, lambda: iter(batches), 0, 1, False)
        got = _drain(jring, len(batches))
    finally:
        jring.destroy()
    assert all(_equal(tuple(b) if isinstance(b, list) else b, g)
               for b, g in zip(batches, got))


def test_library_is_built_under_build_native():
    ShmRing(_name("lib"), slot_bytes=64, num_slots=1).destroy()
    path = shm_ring.build()
    assert path == (shm_ring.BUILD_ROOT / shm_ring.source_hash()
                    / "libshm_ring.so")
    assert str(path).startswith(os.path.join(REPO, "build", "native", ""))
    assert path.exists()
    # never the JAX package's cache file
    assert "dlrover_tpu_native" not in str(path)


def test_a_failed_producer_raises_in_the_consumer():
    """A producer whose dataset raises (a vocabulary of 0 tokens) exits
    1; the consumer gets a RuntimeError, not a quiet end of the epoch
    (the JAX loader's producer logs it and the epoch ends empty)."""
    loader = ShmDataLoader(synth.SeededBatches(3, 1, 1, vocab=0),
                           num_workers=1, slot_bytes=1 << 16, num_slots=8)
    try:
        with pytest.raises(RuntimeError, match="exited with code 1"):
            list(loader)
    finally:
        loader.shutdown()
    assert not shm_ring.segments_of(os.getpid())


def test_device_prefetch_reraises_source_and_transform_errors():
    def source():
        yield np.zeros(2)
        raise KeyError("source")

    out = []
    with pytest.raises(KeyError, match="source"):
        for b in DevicePrefetch(source(), device="cpu"):
            out.append(b)
    assert len(out) == 1

    def bad(batch):
        if int(batch[0, 0]) == 2:
            raise ValueError("transform")
        return batch

    out = []
    with pytest.raises(ValueError, match="transform"):
        for b in DevicePrefetch(_batches(), device="cpu", transform=bad):
            out.append(int(b[0, 0]))
    assert out == [0, 1]


def test_device_prefetch_transforms_and_keeps_host_leaves():
    def transform(batch):
        return (batch.astype(np.int64).reshape(1, 2, 3),
                (int(batch[0, 0]), "rows"))

    got = list(DevicePrefetch(_batches(), device="cpu",
                              transform=transform))
    tensors = [t for t, _ in got]
    assert [meta for _, meta in got] == [(i, "rows") for i in range(12)]
    assert all(t.dtype == torch.int64 and t.shape == (1, 2, 3)
               for t in tensors)


def test_device_prefetch_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePrefetch(_batches())


def test_device_prefetch_join_unblocks_a_stopped_consumer():
    pre = DevicePrefetch(_batches(), depth=1, device="cpu")
    it = iter(pre)
    assert int(next(it)[0, 0]) == 0
    assert pre.join(timeout=10)
