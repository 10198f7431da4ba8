"""The port's elastic shm data path on the CPU: master-sharded coworker
producers -> the C++ ring -> DevicePrefetch -> the trainer (the cases of
``tests/test_elastic_shm_data.py`` against the port's master service),
the batches against the JAX ``ElasticShmDataLoader``'s from the same
``batch_fn``, and the fp32 ``llama_tiny`` losses through the shm feed
against the in-process feed (bitwise) and the JAX trainer's."""

import os

import jax
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.data.elastic_shm import (
    ElasticShmDataLoader as JaxElasticShmDataLoader,
)
from dlrover_tpu.master.local_master import LocalJobMaster as JaxLocalJobMaster
from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.trainer.elastic import ElasticTrainer as JaxElasticTrainer
from dlrover_tpu_torch.agent.master_client import LocalMasterClient
from dlrover_tpu_torch.agent.sharding.client import ShardingClient
from dlrover_tpu_torch.data import shm_ring, synth
from dlrover_tpu_torch.data.elastic_shm import ElasticShmDataLoader
from dlrover_tpu_torch.examples import llama_train
from dlrover_tpu_torch.master.local_master import LocalJobMaster
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from dlrover_tpu_torch.trainer.sharded import adamw, make_trainer_for_llama


@pytest.fixture()
def master():
    m = LocalJobMaster(port=0)
    m.prepare()
    yield m
    m.stop()


def _loader(master_addr, name, n, batch, workers=2, seq=16, vocab=128,
            **kw):
    return ElasticShmDataLoader(
        synth.ShardBatch(seq, vocab), dataset_name=name, batch_size=batch,
        dataset_size=n, num_epochs=1, num_workers=workers,
        master_addr=master_addr, slot_bytes=1 << 20, device="cpu", **kw)


def test_elastic_shm_covers_dataset_exactly_once(master):
    n, batch = 64, 8
    loader = _loader(master.addr, "cov", n, batch)
    seen = []
    for tokens, targets, rows in loader:
        start, end = rows.tolist()
        seen.extend(range(start, end))
        # batch content derives from the shard range
        assert tokens.shape == (end - start, 16)
        assert torch.equal(tokens, torch.from_numpy(synth.synth_batch(
            start, end, 16, 128)[0]))
    loader.shutdown()
    # both coworkers pulled disjoint shards covering every sample once
    assert sorted(seen) == list(range(n))
    assert not shm_ring.segments_of(os.getpid())


def test_llama_trains_from_shm_ring(master):
    """Llama + ShardedTrainer consuming ring batches end to end, the
    microbatch reshape and the token cast on the prefetch thread."""
    cfg = llama.llama_tiny()
    trainer = make_trainer_for_llama(cfg, device="cpu",
                                     optimizer=adamw(1e-3))
    trainer.init(seed=0)
    elastic = ElasticTrainer(trainer, max_nodes=1, cur_nodes=1)
    n, batch = 32, 8
    loader = _loader(master.addr, "llama-shm", n, batch,
                     vocab=cfg.vocab_size,
                     transform=llama_train.shm_transform(elastic))
    steps = 0
    for mb, rows in loader:
        assert mb[0].dtype == torch.int64 and mb[0].shape == (1, batch, 16)
        loss = elastic.train_step(mb)
        assert np.isfinite(float(loss))
        steps += 1
    loader.shutdown()
    assert steps == n // batch


def test_batches_equal_the_jax_loaders(master):
    """One coworker each, the same ``batch_fn``: the port's batches are
    the JAX ``ElasticShmDataLoader``'s (over the JAX master), in order
    and bitwise."""
    n, batch = 40, 4
    loader = _loader(master.addr, "parity", n, batch, workers=1)
    ours = [tuple(t.numpy() for t in b) for b in loader]
    loader.shutdown()
    jmaster = JaxLocalJobMaster(port=0)
    jmaster.prepare()
    try:
        jloader = JaxElasticShmDataLoader(
            synth.ShardBatch(16, 128), dataset_name="parity",
            batch_size=batch, dataset_size=n, num_epochs=1,
            num_workers=1, master_addr=jmaster.addr, slot_bytes=1 << 20)
        theirs = [tuple(np.asarray(x) for x in b) for b in jloader]
        jloader.shutdown()
    finally:
        jmaster.stop()
    assert len(ours) == len(theirs) == n // batch
    for a, b in zip(ours, theirs):
        # the port keeps the producer's dtypes; jax.device_put narrows
        # the int64 rows to int32 (x64 off)
        assert [x.dtype for x in a] == [np.int32, np.int32, np.int64]
        assert all(y.dtype == jax.dtypes.canonicalize_dtype(x.dtype)
                   and np.array_equal(x, y) for x, y in zip(a, b))


STEPS, BATCH, SEQ = 3, 4, 32


@pytest.fixture(scope="module")
def jax_losses():
    """The JAX ElasticTrainer on the same shards: fp32 llama_tiny,
    AdamW(1e-3, 0.9, 0.95), tokens as targets (the examples' batch)."""
    jcfg = jax_llama.llama_tiny(dtype=np.float32, remat="off")
    params = jax_llama.init_params(jax.random.key(0), jcfg)
    start = jax.tree.map(np.array, params)
    optimizer = optax.adamw(1e-3, b1=0.9, b2=0.95)
    opt_state = optimizer.init(params)
    elastic = JaxElasticTrainer(
        lambda p, b: jax_llama.next_token_loss(p, b, jcfg), optimizer,
        max_nodes=1, cur_nodes=1)
    losses = []
    for i in range(STEPS):
        batch = synth.synth_batch(i * BATCH, (i + 1) * BATCH, SEQ,
                                  jcfg.vocab_size)
        params, opt_state, loss = elastic.train_step(
            params, opt_state, elastic.microbatch(batch))
        losses.append(float(loss))
    return start, losses


def _port_elastic(start):
    cfg = llama.llama_tiny(dtype=torch.float32, remat="off")
    trainer = make_trainer_for_llama(
        cfg, device="cpu", optimizer=adamw(1e-3, b1=0.9, b2=0.95))
    trainer.init(model=llama.params_from_jax(start, cfg, device="cpu"))
    return cfg, trainer, ElasticTrainer(trainer, max_nodes=1, cur_nodes=1)


def test_llama_losses_shm_feed_equal_in_process_and_match_jax(
        master, jax_losses):
    start, want = jax_losses
    cfg, trainer, elastic = _port_elastic(start)
    loader = ElasticShmDataLoader(
        synth.ShardBatch(SEQ, cfg.vocab_size), dataset_name="feed",
        batch_size=BATCH, dataset_size=STEPS * BATCH, num_workers=1,
        master_addr=master.addr, slot_bytes=1 << 20, device="cpu",
        transform=llama_train.shm_transform(elastic))
    shm_losses, shm_rows = [], []
    for mb, rows in loader:
        shm_losses.append(float(elastic.train_step(mb)))
        shm_rows.append(rows)
    loader.shutdown()

    cfg, trainer, elastic = _port_elastic(start)
    sharding = ShardingClient(
        "feed", BATCH, num_epochs=1, dataset_size=STEPS * BATCH,
        shuffle=False, num_minibatches_per_shard=1,
        master_client=LocalMasterClient())
    mem_losses, mem_rows = [], []
    for _ in range(STEPS):
        shard = sharding.fetch_shard()
        batch = trainer.shard_batch(elastic.microbatch(
            llama_train.synth_batch(shard.start, shard.end, SEQ,
                                    cfg.vocab_size)))
        mem_losses.append(float(elastic.train_step(batch)))
        mem_rows.append((shard.start, shard.end))
        sharding.report_batch_done()
    sharding.stop()

    assert shm_rows == mem_rows == [(i * BATCH, (i + 1) * BATCH)
                                    for i in range(STEPS)]
    assert shm_losses == mem_losses  # bitwise
    assert shm_losses[0] == pytest.approx(want[0], rel=1e-5)
    assert shm_losses == pytest.approx(want, rel=1e-4)
