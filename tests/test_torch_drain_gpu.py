"""The preemption drain on the card: a notice that lands inside a step,
between the backward pass and the optimizer's in-place writes, drains
at the step's end, and the emergency save -- staged by the drain's own
thread on a side stream -- holds the whole step; and a notice that lands
during a cadence save drains after it, so the emergency save never
waits on the page-locked block that the cadence save holds. Marked
``gpu``: it
skips on a machine without one; run it on a GPU with ``python -m pytest
--noconftest tests/test_torch_*gpu*.py -m gpu`` (the repo's conftest
imports JAX, which a GPU machine need not have)."""

import os
import signal

import pytest
import torch

from dlrover_tpu_torch.agent.master_client import LocalMasterClient
from dlrover_tpu_torch.examples import llama_train
from dlrover_tpu_torch import telemetry
from dlrover_tpu_torch.fault_tolerance.drain import DRAIN_EXIT_CODE
from dlrover_tpu_torch.telemetry.journal import EventJournal
from dlrover_tpu_torch.trainer import ckpt_store
from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from dlrover_tpu_torch.trainer.sharded import make_trainer_for_llama

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step and its staging copies "
                    "run on the card")
    prev = signal.signal(signal.SIGTERM, signal.SIG_DFL)
    yield torch.device("cuda")
    signal.signal(signal.SIGTERM, prev)


def _flat(tree):
    return {ckpt_store._path_json(p): leaf
            for p, leaf in ckpt_store.flatten_with_path(tree)}


@pytest.mark.parametrize("notice_step", [1, 3])
def test_mid_step_notice_archives_a_whole_step_on_the_card(cuda, tmp_path,
                                                           notice_step):
    cfg, optimizer = llama_train.model_config("tiny")
    trainer = make_trainer_for_llama(cfg, device="cuda",
                                     optimizer=optimizer)
    trainer.init(seed=0)
    elastic = ElasticTrainer(trainer, max_nodes=1, cur_nodes=1,
                             master_client=LocalMasterClient())
    ckpt = FlashCheckpointer(str(tmp_path / "persist"),
                             ram_dir=str(tmp_path / "ram"),
                             persist_interval=0)
    elastic.attach_checkpointer(ckpt, save_interval=2)
    exits = []
    elastic.drain._exit_fn = exits.append
    wait_staged = trainer.before_update

    def before_update():
        if elastic.global_step == notice_step - 1:
            os.kill(os.getpid(), signal.SIGTERM)
            assert elastic.drain.pending
        wait_staged()

    trainer.before_update = before_update
    try:
        for step in range(1, notice_step + 1):
            tokens = llama_train.synth_batch(4 * step, 4 * step + 4, 128,
                                             cfg.vocab_size)[0]
            batch = trainer.shard_batch(elastic.microbatch((tokens, tokens)))
            loss = elastic.train_step(batch)
            elastic.report_step(step, loss=loss)
            elastic.maybe_checkpoint(
                lambda: {**trainer.train_state(), "step": step})
        assert exits == [DRAIN_EXIT_CODE]
        torch.cuda.synchronize()
        live = _flat({**trainer.train_state(), "step": notice_step})
    finally:
        elastic.drain.disarm()
    restored, step = ckpt.restore(
        target={**trainer.train_state(), "step": 0})
    ckpt.close()
    assert step == notice_step
    archived = _flat(restored)
    assert archived.keys() == live.keys()
    for key, leaf in live.items():
        if isinstance(leaf, torch.Tensor):
            assert archived[key].device.type == "cuda"
            assert torch.equal(archived[key], leaf), key
        else:
            assert archived[key] == leaf, key
    assert restored["optimizer"]["count"] == notice_step


def test_notice_during_the_cadence_save_drains_after_it_on_the_card(
        cuda, tmp_path):
    telemetry.set_default_journal(EventJournal(None))
    cfg, optimizer = llama_train.model_config("tiny")
    trainer = make_trainer_for_llama(cfg, device="cuda",
                                     optimizer=optimizer)
    trainer.init(seed=0)
    elastic = ElasticTrainer(trainer, max_nodes=1, cur_nodes=1,
                             master_client=LocalMasterClient())
    ckpt = FlashCheckpointer(str(tmp_path / "persist"),
                             ram_dir=str(tmp_path / "ram"),
                             persist_interval=0)
    elastic.attach_checkpointer(ckpt, save_interval=2)
    exits = []
    elastic.drain._exit_fn = exits.append
    #: (notice pending, exits so far) just after the signal, which
    #: lands after the staging took the page-locked block
    signalled = []

    def clean_fn():
        if elastic.global_step == 2 and not signalled:
            os.kill(os.getpid(), signal.SIGTERM)
            signalled.append((elastic.drain.pending, list(exits)))
        return True

    ckpt.set_clean_fn(clean_fn)
    try:
        for step in (1, 2):
            tokens = llama_train.synth_batch(4 * step, 4 * step + 4, 128,
                                             cfg.vocab_size)[0]
            batch = trainer.shard_batch(elastic.microbatch((tokens, tokens)))
            elastic.report_step(step, loss=elastic.train_step(batch))
            elastic.maybe_checkpoint(
                lambda: {**trainer.train_state(), "step": step},
                durable=True)
        assert signalled == [(True, [])]
        assert exits == [DRAIN_EXIT_CODE]
    finally:
        elastic.drain.disarm()
        ckpt.close()
    (eck,) = telemetry.default_journal().events("preempt.emergency_ckpt")
    assert eck["data"]["ok"] and eck["data"]["durable"]
    assert not eck["data"]["timed_out"] and eck["data"]["step"] == 2
