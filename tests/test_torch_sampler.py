"""The port's ElasticDistributedSampler (a copy of the JAX package's,
framework-neutral) against the JAX package's: the same indices for every
geometry, the same batches, and the same resume across a world change."""

import itertools

import numpy as np
import pytest

from dlrover_tpu.trainer.sampler import (
    ElasticDistributedSampler as JaxSampler,
)
from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler

GEOMETRIES = [
    (size, replicas, rank, shuffle, seed, drop_last)
    for size, replicas in ((10, 1), (10, 3), (17, 4), (5, 8))
    for rank in sorted({0, replicas - 1})
    for shuffle, seed in ((False, 0), (True, 0), (True, 7))
    for drop_last in (False, True)
]


def _both(*args, **kw):
    return JaxSampler(*args, **kw), ElasticDistributedSampler(*args, **kw)


@pytest.mark.parametrize(
    "size,replicas,rank,shuffle,seed,drop_last", GEOMETRIES)
def test_indices_equal_jax(size, replicas, rank, shuffle, seed, drop_last):
    jax_s, port_s = _both(size, num_replicas=replicas, rank=rank,
                          shuffle=shuffle, seed=seed, drop_last=drop_last)
    for epoch in (0, 1):
        jax_s.set_epoch(epoch)
        port_s.set_epoch(epoch)
        assert list(port_s) == list(jax_s)
        assert len(port_s) == len(jax_s)
        assert port_s.state_dict() == jax_s.state_dict()


@pytest.mark.parametrize("batch_size", [1, 3, 4])
def test_batches_equal_jax(batch_size):
    jax_s, port_s = _both(23, num_replicas=2, rank=1, shuffle=True, seed=3)
    got = [b.tolist() for b in port_s.iter_batches(batch_size)]
    want = [b.tolist() for b in jax_s.iter_batches(batch_size)]
    assert got == want
    assert port_s.completed_num == jax_s.completed_num


@pytest.mark.parametrize("old,new,drop_last", [
    ((4, 1), (2, 0), False), ((4, 3), (2, 1), False),
    ((2, 0), (4, 3), False), ((3, 2), (5, 4), True),
])
def test_resume_across_a_world_change_equals_jax(old, new, drop_last):
    """Consume part of an epoch under ``old`` (replicas, rank), save,
    load into ``new``: the remaining indices are JAX's."""
    states = []
    for cls in (JaxSampler, ElasticDistributedSampler):
        s = cls(29, num_replicas=old[0], rank=old[1], shuffle=True,
                seed=11, drop_last=drop_last)
        list(itertools.islice(iter(s), 3))
        state = s.state_dict()
        fresh = cls(29, shuffle=True, seed=11, drop_last=drop_last)
        fresh.load_state_dict(state, num_replicas=new[0], rank=new[1])
        states.append((state, list(fresh), len(fresh)))
    assert states[1] == states[0]


def test_set_world_mid_epoch_equals_jax():
    out = []
    for cls in (JaxSampler, ElasticDistributedSampler):
        s = cls(20, num_replicas=4, rank=2, shuffle=True, seed=1)
        head = list(itertools.islice(iter(s), 2))
        s.set_world(3, 1)
        out.append((head, list(s), s.state_dict()))
    assert out[1] == out[0]


@pytest.mark.parametrize("rank,replicas", [(2, 2), (-1, 2)])
def test_bad_rank_raises_like_jax(rank, replicas):
    for cls in (JaxSampler, ElasticDistributedSampler):
        with pytest.raises(ValueError):
            cls(10, num_replicas=replicas, rank=rank)
        s = cls(10)
        with pytest.raises(ValueError):
            s.load_state_dict({"epoch": 0, "completed_num": 0},
                              num_replicas=replicas, rank=rank)


def test_iter_batches_rejects_nonpositive_size():
    with pytest.raises(ValueError):
        next(ElasticDistributedSampler(4).iter_batches(0))
    assert np.asarray(next(
        ElasticDistributedSampler(4, shuffle=False).iter_batches(4))
    ).tolist() == [0, 1, 2, 3]
