"""The port's train step against the JAX ShardedTrainer (ddp, one CPU
device), from the same weights and batches, in fp32."""

import copy

import jax
import jax.numpy as jnp
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
from dlrover_tpu_torch.trainer.sharded import (
    Fp32GradAdamW,
    adamw,
    make_trainer_for_llama,
)

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
    """With accum_steps > 1 the update receives the fp32 mean of the
    microbatch gradients (bf16 model: the sum is not rounded to bf16),
    as the JAX step hands optax its fp32 mean."""
    cfg = llama.llama_tiny()  # bf16 weights, fp32 norms
    trainer = make_trainer_for_llama(cfg, device="cpu", accum_steps=2)
    model, optimizer = trainer.init(seed=0)
    batch = trainer.shard_batch(trainer.microbatch(
        tuple(x.astype(np.int64) for x in _batches(cfg, 1)[0])))
    # the mean the step should hand over, from a copy of the model
    twin = copy.deepcopy(model)
    want = [torch.zeros_like(p, dtype=torch.float32)
            for p in twin.parameters()]
    for i in range(2):
        llama.next_token_loss(twin, tuple(x[i] for x in batch)).backward()
        for acc, p in zip(want, twin.parameters()):
            acc.add_(p.grad.float())
            p.grad = None
    received = []
    step = optimizer.step
    optimizer.step = lambda grads: (received.extend(g.clone() for g in grads),
                                    step(grads))
    loss = trainer.train_step(batch)
    assert torch.isfinite(loss)
    assert len(received) == len(want)
    for got, acc in zip(received, want):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, acc / 2, rtol=1e-6, atol=1e-9)
    assert isinstance(optimizer, Fp32GradAdamW)
    assert all(m.dtype == torch.float32 for m in optimizer.mu + optimizer.nu)
    assert model.embed.dtype == torch.bfloat16
    assert model.final_norm.dtype == torch.float32
    assert all(p.grad is None for p in model.parameters())


def _optax_run(p0, grads):
    params = jnp.asarray(p0, jnp.bfloat16)
    opt = optax.adamw(1e-3, b1=0.9, b2=0.95)
    state = opt.init(params)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
    return np.asarray(params.astype(jnp.float32))


def _assert_bf16_update_matches(got, want):
    """Rule for one bf16 tensor after AdamW steps from the same fp32
    gradients: 99.9% of elements identical, every one within a bf16 step
    (2^-7 of its value). Fp32GradAdamW meets it exactly (every element
    identical to optax); see test_bf16_update_rule_sees_bf16_moments for
    what it rejects."""
    diff = np.abs(got - want)
    within = bool(np.all(diff <= 2.0 ** -7 * np.abs(want)))
    same = np.mean(diff == 0)
    assert within and same >= 0.999, (
        f"{same:.4f} of elements identical, all within a bf16 step: "
        f"{within}")


def _bf16_case(seed=0, steps=3):
    rng = np.random.default_rng(seed)
    p0 = (rng.standard_normal((256, 64)) * 0.05).astype(np.float32)
    grads = [(rng.standard_normal((256, 64)) * 1e-3).astype(np.float32)
             for _ in range(steps)]
    return p0, grads


def test_fp32_grad_adamw_matches_optax_on_bf16():
    p0, grads = _bf16_case()
    param = torch.nn.Parameter(torch.tensor(p0).to(torch.bfloat16))
    opt = Fp32GradAdamW([param], adamw(1e-3, b1=0.9, b2=0.95))
    for g in grads:
        opt.step([torch.tensor(g)])
    _assert_bf16_update_matches(param.detach().float().numpy(),
                                _optax_run(p0, grads))


def test_bf16_update_rule_sees_bf16_moments():
    """The former accumulation path -- the mean rounded to bf16, then
    torch.optim.AdamW with bf16 moments -- fails the rule (94% of
    elements identical)."""
    p0, grads = _bf16_case()
    param = torch.nn.Parameter(torch.tensor(p0).to(torch.bfloat16))
    opt = adamw(1e-3, b1=0.9, b2=0.95)([param])
    for g in grads:
        param.grad = torch.tensor(g).to(torch.bfloat16)
        opt.step()
    with pytest.raises(AssertionError, match="of elements identical"):
        _assert_bf16_update_matches(param.detach().float().numpy(),
                                    _optax_run(p0, grads))


def test_accum_bf16_model_matches_jax():
    """A bf16 llama_tiny after 2 steps of 2 accumulated microbatches,
    from the JAX trainer's starting weights, against the JAX trainer.
    The two frameworks round the bf16 forward and backward at other
    places (the first losses differ by 2e-4 relative), so the gradients
    differ slightly, and where a gradient is near zero its sign may
    differ: each Adam step then moves the two copies about lr apart in
    opposite directions. The rule: losses within 1e-3 relative, every
    parameter within 4 lr (two such steps) plus one bf16 step of the JAX
    value (3.4e-3 at most measured), and 98% of the elements within one
    bf16 step (98.7% measured). The optimizer's own arithmetic is held
    exactly by test_fp32_grad_adamw_matches_optax_on_bf16."""
    lr = 1e-3
    jcfg = jax_llama.llama_tiny(dtype=jnp.bfloat16, remat="off")
    mesh = create_mesh([("data", 1)], devices=[jax.devices()[0]])
    jtrainer = jax_make_trainer(
        jcfg, mesh, strategy="ddp", accum_steps=2,
        optimizer=optax.adamw(lr, b1=0.9, b2=0.95))
    params, opt_state = jtrainer.init(jax.random.key(0))
    start = jax.tree.map(np.array, params)
    batches = _batches(llama.llama_tiny(), 2)
    jax_losses = []
    for batch in batches:
        params, opt_state, loss = jtrainer.train_step(
            params, opt_state,
            jtrainer.shard_batch(jtrainer.microbatch(batch)))
        jax_losses.append(float(loss))
    want = _as_port_layout(jax.tree.map(
        lambda x: np.asarray(x.astype(jnp.float32)), params), jcfg)

    cfg = llama.llama_tiny(dtype=torch.bfloat16, remat="off")
    trainer = make_trainer_for_llama(cfg, device="cpu", accum_steps=2,
                                     optimizer=adamw(lr, b1=0.9, b2=0.95))
    trainer.init(model=llama.params_from_jax(start, cfg, device="cpu"))
    losses = [
        trainer.train_step(trainer.shard_batch(trainer.microbatch(
            tuple(x.astype(np.int64) for x in batch)))).item()
        for batch in batches
    ]
    got = _port_params(trainer)
    assert losses == pytest.approx(jax_losses, rel=1e-3)
    assert got.keys() == want.keys()
    close = total = 0
    for name in want:
        step = 2.0 ** -7 * np.abs(want[name])
        diff = np.abs(got[name] - want[name])
        assert np.all(diff <= 4 * lr + step), name
        close += np.count_nonzero(diff <= step)
        total += diff.size
    assert close / total >= 0.98, f"{close / total:.4f} within a bf16 step"


def test_accum_takes_only_adamw():
    with pytest.raises(ValueError, match="adamw"):
        make_trainer_for_llama(
            llama.llama_tiny(), device="cpu", accum_steps=2,
            optimizer=lambda params: torch.optim.SGD(params, lr=0.1))


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
