"""The port's train step against the JAX ShardedTrainer (ddp, one CPU
device), from the same weights and batches, in fp32."""

import jax
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.parallel.mesh import create_mesh
from dlrover_tpu.trainer.sharded import (
    make_trainer_for_llama as jax_make_trainer,
)
from dlrover_tpu_torch.auto import device_context
from dlrover_tpu_torch.models import llama, make_trainer_for
from dlrover_tpu_torch.trainer import profiler
from dlrover_tpu_torch.trainer.sharded import adamw, make_trainer_for_llama

from tests.test_torch_llama import _as_port_layout, _batch


def _batches(cfg, n, b=4, s=32, masked=True):
    return [_batch(cfg, b=b, s=s, seed=100 + i, masked=masked)
            for i in range(n)]


def _port_params(trainer):
    return {n: p.detach().float().numpy().copy()
            for n, p in trainer.model.named_parameters()}


def _assert_adam_close(got, want, start, lr):
    """Each parameter's change from ``start`` in ``got`` against the one
    in ``want``. Adam divides by sqrt(v): where a gradient is near zero,
    fp32 summation-order noise can swing that element's step by up to
    lr, so that is the bound on every element; 95% of the changes agree
    to 1e-3 relative (98.7% in the JAX comparison). The rule sees a wrong
    optimizer default: see test_comparison_sees_wrong_adamw_defaults."""
    assert got.keys() == want.keys() == start.keys()
    close = total = 0
    for name in want:
        diff = np.abs(got[name] - want[name])
        assert diff.max() <= lr, name
        change = np.abs(want[name] - start[name])
        close += np.count_nonzero(diff <= 1e-7 + 1e-3 * change)
        total += diff.size
    assert close / total >= 0.95, f"{close / total:.4f} of changes close"


@pytest.fixture(scope="module")
def jax_steps():
    """3 steps of the JAX trainer at lr 1e-3: (starting params as a
    numpy tree, the batches, the JAX losses, the final params in the
    port's layout)."""
    jcfg = jax_llama.llama_tiny(dtype=np.float32, remat="off")
    mesh = create_mesh([("data", 1)], devices=[jax.devices()[0]])
    jtrainer = jax_make_trainer(
        jcfg, mesh, strategy="ddp",
        optimizer=optax.adamw(1e-3, b1=0.9, b2=0.95),
    )
    params, opt_state = jtrainer.init(jax.random.key(0))
    # copied out before the donating step can reuse the buffers
    start = jax.tree.map(np.array, params)
    batches = _batches(llama.llama_tiny(), 3)
    losses = []
    for batch in batches:
        params, opt_state, loss = jtrainer.train_step(
            params, opt_state,
            jtrainer.shard_batch(jtrainer.microbatch(batch)))
        losses.append(float(loss))
    final = _as_port_layout(jax.tree.map(np.asarray, params), jcfg)
    return start, batches, losses, final


def _port_steps(jax_start, batches, optimizer):
    """The port's trainer from the JAX starting weights: (starting
    params, losses, final params), in fp32."""
    cfg = llama.llama_tiny(dtype=torch.float32, remat="off")
    trainer = make_trainer_for_llama(cfg, device="cpu", optimizer=optimizer)
    trainer.init(model=llama.params_from_jax(jax_start, cfg, device="cpu"))
    start = _port_params(trainer)
    losses = [
        trainer.train_step(trainer.shard_batch(trainer.microbatch(
            tuple(x.astype(np.int64) for x in batch)))).item()
        for batch in batches
    ]
    return start, losses, _port_params(trainer)


def test_three_adamw_steps_match_jax(jax_steps):
    jax_start, batches, jax_losses, want = jax_steps
    start, losses, got = _port_steps(
        jax_start, batches, adamw(1e-3, b1=0.9, b2=0.95))
    assert losses == pytest.approx(jax_losses, rel=1e-5)
    _assert_adam_close(got, want, start, lr=1e-3)


@pytest.mark.parametrize("optimizer", [
    # torch's own weight decay default, 1e-2 (optax: 1e-4)
    lambda params: torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.95)),
    adamw(1e-3, b1=0.9, b2=0.95, eps=1e-6),
    adamw(1e-3, b1=0.9, b2=0.999),
], ids=["torch_weight_decay", "eps_1e-6", "b2_0.999"])
def test_comparison_sees_wrong_adamw_defaults(jax_steps, optimizer):
    jax_start, batches, _, want = jax_steps
    start, _, got = _port_steps(jax_start, batches, optimizer)
    with pytest.raises(AssertionError, match="of changes close"):
        _assert_adam_close(got, want, start, lr=1e-3)


def test_accum_two_equals_one():
    cfg = llama.llama_tiny(dtype=torch.float32, remat="off")
    results = []
    for accum in (1, 2):
        trainer = make_trainer_for_llama(cfg, device="cpu",
                                         accum_steps=accum,
                                         optimizer=adamw(1e-3))
        trainer.init(seed=5)
        start = _port_params(trainer)
        losses = [
            trainer.train_step(trainer.shard_batch(trainer.microbatch(
                tuple(x.astype(np.int64) for x in batch)))).item()
            for batch in _batches(cfg, 2, b=4, masked=False)
        ]
        results.append((losses, _port_params(trainer)))
    (losses1, params1), (losses2, params2) = results
    # no target is masked, so the mean of the two microbatch means is
    # the global mean
    assert losses2 == pytest.approx(losses1, rel=1e-5)
    _assert_adam_close(params2, params1, start, lr=1e-3)


def test_accum_keeps_model_dtype_and_fp32_sum():
    cfg = llama.llama_tiny()  # bf16 weights, fp32 norms
    trainer = make_trainer_for_llama(cfg, device="cpu", accum_steps=2)
    model, _ = trainer.init(seed=0)
    batch = tuple(x.astype(np.int64) for x in _batches(cfg, 1)[0])
    loss = trainer.train_step(trainer.shard_batch(trainer.microbatch(batch)))
    assert torch.isfinite(loss)
    assert model.embed.dtype == torch.bfloat16
    assert model.final_norm.dtype == torch.float32
    assert all(p.grad is None for p in model.parameters())


def test_default_device_is_the_gpu():
    cfg = llama.llama_tiny()
    if torch.cuda.is_available():
        assert make_trainer_for_llama(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_trainer_for_llama(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_params(cfg)


def test_unported_strategy_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_trainer_for_llama(llama.llama_tiny(), device="cpu",
                               strategy="fsdp")


def test_make_trainer_for_dispatches_llama():
    trainer = make_trainer_for(llama.llama_tiny(), device="cpu")
    assert trainer.device.type == "cpu" and trainer.strategy == "ddp"


def test_optax_defaults_written_out():
    opt = adamw(1e-4)(torch.nn.Linear(2, 2).parameters())
    group = opt.param_groups[0]
    assert group["weight_decay"] == 1e-4 and group["eps"] == 1e-8
    assert group["betas"] == (0.9, 0.999)


@pytest.mark.parametrize("name,peak,mem", [
    ("NVIDIA H100 80GB HBM3", 989e12, 80e9),
    ("NVIDIA H100 PCIe", 756e12, 80e9),
])
def test_device_table(name, peak, mem):
    assert device_context.peak_flops_per_chip(name) == peak
    assert device_context.hbm_bytes_per_chip(name) == mem


def test_unknown_card_and_utilization():
    with pytest.raises(ValueError, match="no peak rate"):
        device_context.peak_flops_per_chip("Some Other Card")
    assert profiler.utilization(989e12, 2.0, 989e12) == 50.0
    assert profiler.utilization(1.0, 0.0, 989e12) == 0.0
