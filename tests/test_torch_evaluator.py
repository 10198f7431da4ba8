"""The port's checkpoint evaluator on the CPU: the checkpoint-watching
loop and the report into the master's job metric collector (the cases
of ``tests/test_evaluator.py`` on the port's checkpointer, master
service and collector), and the held-out loss that the evaluator
computes for a saved ``llama_tiny`` step against the JAX forward on the
same weights."""

import jax
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.data import synth
from dlrover_tpu_torch.master.servicer import create_master_service
from dlrover_tpu_torch.master.stats.job_collector import JobMetricCollector
from dlrover_tpu_torch.master.stats.reporter import JobMeta
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer
from dlrover_tpu_torch.trainer.evaluator import (
    CheckpointEvaluator,
    report_to,
)
from dlrover_tpu_torch.trainer.sharded import make_trainer_for_llama

#: the JAX example's held-out seed (``examples/eval_loop.py:37``)
HELD_OUT_SEED = 9999


def _ckpt(tmp_path):
    return FlashCheckpointer(str(tmp_path / "persist"),
                             ram_dir=str(tmp_path / "ram"),
                             persist_interval=0)


def test_checkpoint_evaluator_loop(tmp_path):
    ckpt = _ckpt(tmp_path)
    reported = []
    evaluated = []

    def eval_fn(state, step):
        evaluated.append(step)
        return {"loss": float(torch.sum(state["w"]))}

    evaluator = CheckpointEvaluator(
        ckpt, eval_fn,
        report_fn=lambda step, res: reported.append((step, res)),
        poll_interval=0.01,
    )
    assert evaluator.poll_once() is None  # nothing saved yet
    ckpt.save(5, {"w": torch.ones(4)})
    ckpt.wait()
    res = evaluator.poll_once()
    assert res == {"loss": 4.0}
    assert evaluator.poll_once() is None  # same step: not re-evaluated
    ckpt.save(10, {"w": torch.full((4,), 2.0)})
    ckpt.wait()
    n = evaluator.run(max_evals=1, deadline=None)
    assert n == 1
    assert evaluated == [5, 10]
    assert reported[0][0] == 5
    assert reported[1] == (10, {"loss": 8.0})
    ckpt.close()


def test_eval_results_reach_master_stats():
    """End to end over the wire: evaluator -> report_custom_data RPC ->
    the job collector's custom metrics."""
    collector = JobMetricCollector(JobMeta(name="j"))
    server, _ = create_master_service(0, job_metric_collector=collector)
    server.start()
    try:
        client = MasterClient(
            f"localhost:{server.port}", 0, NodeType.EVALUATOR
        )
        client.report_custom_data({"eval_step": 5, "eval_loss": 1.5})
        assert collector._custom["eval_loss"] == 1.5
        assert collector._custom["eval_step"] == 5
        # the evaluator's own report_fn: eval_<key> and the step
        report_to(client)(7, {"loss": 0.25, "accuracy": 0.5})
        assert collector._custom["eval_step"] == 7
        assert collector._custom["eval_loss"] == 0.25
        assert collector._custom["eval_accuracy"] == 0.5
    finally:
        server.stop()


def test_a_failed_report_does_not_stop_the_loop(tmp_path):
    ckpt = _ckpt(tmp_path)

    def broken(step, res):
        raise ConnectionError("master gone")

    evaluator = CheckpointEvaluator(ckpt, lambda s, n: {"n": n},
                                    report_fn=broken, poll_interval=0.01)
    ckpt.save(3, {"w": torch.zeros(2)})
    ckpt.wait()
    assert evaluator.poll_once() == {"n": 3}
    ckpt.close()


def _held_out(cfg, b=2, s=32):
    tokens, targets = synth.synth_batch(HELD_OUT_SEED, HELD_OUT_SEED + b,
                                        s, cfg.vocab_size)
    return tokens, targets


def test_llama_held_out_loss_of_a_saved_step_matches_jax(tmp_path):
    """JAX trains fp32 llama_tiny two steps; the port saves those
    weights as step 2; a CheckpointEvaluator restores the step into a
    fresh trainer (another seed) and computes the held-out loss, which
    is the JAX forward's on the same weights within 1e-5."""
    jcfg = jax_llama.llama_tiny(dtype=np.float32, remat="off")
    cfg = llama.llama_tiny(dtype=torch.float32, remat="off")
    params = jax_llama.init_params(jax.random.key(0), jcfg)
    opt = optax.adamw(1e-3)
    opt_state = opt.init(params)
    grad_fn = jax.value_and_grad(
        lambda p, b: jax_llama.next_token_loss(p, b, jcfg))
    for start in (0, 2):
        batch = synth.synth_batch(start, start + 2, 32, jcfg.vocab_size)
        _, grads = grad_fn(params, batch)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    held_out = _held_out(cfg)
    want = float(jax_llama.next_token_loss(params, held_out, jcfg))

    trained = make_trainer_for_llama(cfg, device="cpu")
    trained.init(model=llama.params_from_jax(
        jax.tree.map(np.asarray, params), cfg, device="cpu"))
    ckpt = _ckpt(tmp_path)
    ckpt.save(2, {**trained.train_state(), "step": 2})
    ckpt.close()

    fresh = make_trainer_for_llama(cfg, device="cpu")
    fresh.init(seed=1)
    tokens = torch.from_numpy(held_out[0].astype(np.int64))

    def eval_fn(state, step):
        fresh.load_train_state(state)
        with torch.no_grad():
            loss = llama.next_token_loss(fresh.model, (tokens, tokens))
        return {"loss": float(loss), "step": int(state["step"])}

    reported = []
    evaluator = CheckpointEvaluator(
        _ckpt(tmp_path), eval_fn,
        target={**fresh.train_state(), "step": 0},
        report_fn=lambda step, res: reported.append((step, res)),
        poll_interval=0.01)
    assert evaluator.run(max_evals=1) == 1
    (step, res), = reported
    assert step == 2 and res["step"] == 2
    assert res["loss"] == pytest.approx(want, rel=1e-5)
    # the evaluator evaluated the saved weights, not the fresh ones
    with torch.no_grad():
        untrained = make_trainer_for_llama(cfg, device="cpu")
        untrained.init(seed=1)
        other = float(llama.next_token_loss(untrained.model,
                                            (tokens, tokens)))
    assert other != pytest.approx(want, rel=1e-3)
