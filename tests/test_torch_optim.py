"""The port's ``optim/`` against the JAX package's: ``bf16_adamw`` with
and without ``nonfinite_guard`` over the same seeded gradients as
optax's, ``master_weights``, ``guard_stats`` and its metric, and
``wsam_value_and_grad`` alone and as ``ShardedTrainer``'s
``value_and_grad`` hook on llama_tiny against the JAX trainer's. Every
case runs in this one process; the JAX side compiles with XLA's cheap
codegen (test_torch_gpt.py's FAST_COMPILE).

Tolerances: the fp32 masters and moments within 1e-6 relative of
optax's (the bias corrections' ``b ** count`` are XLA's and torch's
``pow`` in fp32), a bf16 parameter or moment within one bf16 ulp;
the guard's gradient norm within one bf16 ulp (optax takes it in the
gradients' dtype, bf16 here, the port in fp32); everything the guard
keeps bitwise; WSAM's gradient within 1e-5
relative; the trainer's losses within 1e-5 and its parameters to
test_torch_trainer.py's ``_assert_adam_close`` with its bound of one
learning rate per step taken. The behaviours of
tests/test_optim.py's TestMasterWeights and TestWsam, and of
tests/test_sentinel.py::test_nonfinite_guard_skips_poisoned_update, are
asserted with their own bounds."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.optim import bf16 as jax_bf16
from dlrover_tpu.optim import wsam as jax_wsam
from dlrover_tpu.parallel.mesh import create_mesh as jax_create_mesh
from dlrover_tpu.trainer import sharded as jax_sharded
from dlrover_tpu.trainer.sharded import ShardedTrainer as JaxTrainer
from dlrover_tpu_torch import telemetry as T
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.optim import (
    bf16 as bf16_mod,
    bf16_adamw,
    guard_stats,
    master_weights,
    nonfinite_guard,
    wsam_value_and_grad,
)
from dlrover_tpu_torch.optim.optimizers import Fp32GradAdamW
from dlrover_tpu_torch.trainer.ckpt_store import ShardedLeaf
from dlrover_tpu_torch.trainer.sharded import adamw, make_trainer_for_llama

from tests.test_torch_gpt import FAST_COMPILE
from tests.test_torch_llama import _as_port_layout, one_thread  # noqa: F401
from tests.test_torch_strategies import _FastJax
from tests.test_torch_trainer import _assert_adam_close

LR = 3e-2
SHAPES = {"b": (24,), "w": (16, 24)}
#: the step (0-based) whose gradient holds a NaN in the guarded run
POISONED = 2


def _params_and_grads(steps=4, seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 0.1).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16()


def _np(t):
    return t.detach().float().numpy()


def _jax_run(guard, steps=4):
    """optax's bf16_adamw on bf16 params, the gradients cast to bf16;
    after each step (params, master, mu, nu, count, the guard's
    (skips, norm))."""
    params, grads = _params_and_grads(steps)
    if guard:
        grads[POISONED]["w"][3, 5] = np.nan
    opt = jax_bf16.bf16_adamw(LR, weight_decay=1e-2,
                              guard_nonfinite=guard)
    p = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    state = opt.init(p)
    update = jax.jit(opt.update, compiler_options=FAST_COMPILE)
    out = []
    for g in grads:
        updates, state = update(
            {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()},
            state, p)
        p = optax.apply_updates(p, updates)
        ms = state.inner_state if guard else state
        adam = ms.inner_state[0]
        out.append({
            "params": {k: np.asarray(v, np.float32) for k, v in p.items()},
            "master": {k: np.asarray(v) for k, v in ms.master.items()},
            "mu": {k: np.asarray(v, np.float32) for k, v in adam.mu.items()},
            "nu": {k: np.asarray(v) for k, v in adam.nu.items()},
            "count": int(adam.count),
            "guard": ((int(state.nonfinite_count),
                       float(state.last_grad_norm)) if guard else None)})
    return out


def _port_opt(guard):
    params, _ = _params_and_grads()
    ps = {k: nn.Parameter(_bf16(v)) for k, v in params.items()}
    opt = bf16_adamw(LR, weight_decay=1e-2, guard_nonfinite=guard)(
        [ps[k] for k in sorted(ps)])
    return ps, opt


def _parts(ps, opt, guard):
    mw = opt.inner if guard else opt
    adam = mw.inner
    names = sorted(ps)
    return {"params": {k: _np(ps[k]) for k in names},
            "master": {k: _np(m) for k, m in zip(names, mw.master)},
            "mu": {k: _np(m) for k, m in zip(names, adam.mu)},
            "nu": {k: _np(v) for k, v in zip(names, adam.nu)},
            "count": int(adam.count)}


def _port_step(ps, opt, grads):
    for k, p in ps.items():
        p.grad = _bf16(grads[k])
    opt.step()
    opt.zero_grad()


def _bits(ps, opt, guard):
    """Every tensor the step writes, as bytes."""
    mw = opt.inner if guard else opt
    ts = list(ps.values()) + mw.master + mw.inner.mu + mw.inner.nu
    return [t.detach().clone() for t in ts] + [mw.inner.count.clone()]


@pytest.fixture(scope="module")
def jax_runs():
    return {guard: _jax_run(guard) for guard in (False, True)}


@pytest.mark.parametrize("guard", [False, True], ids=["plain", "guarded"])
def test_bf16_adamw_steps_match_optax(jax_runs, guard, monkeypatch):
    """Four steps at lr 3e-2 with decay 1e-2; guarded, step 2's gradient
    holds a NaN: optax skips it, the port keeps every parameter, master
    and moment bitwise, counts the skip (the metric too) and keeps the
    NaN norm; then both take step 3 alike."""
    monkeypatch.setattr(bf16_mod, "_skips_published", 0)
    metric = T.counter("dlrover_optim_nonfinite_skips_total")
    before_metric = metric.value
    ps, opt = _port_opt(guard)
    _, grads = _params_and_grads()
    if guard:
        grads[POISONED]["w"][3, 5] = np.nan
    ulp = 2.0 ** -8
    for i, (g, want) in enumerate(zip(grads, jax_runs[guard])):
        held = _bits(ps, opt, guard)
        _port_step(ps, opt, g)
        got = _parts(ps, opt, guard)
        assert got["count"] == want["count"]
        for k in SHAPES:
            # the parameters are their masters rounded, exactly
            assert np.array_equal(got["params"][k], _np(
                torch.from_numpy(got["master"][k]).bfloat16()))
            np.testing.assert_allclose(got["master"][k], want["master"][k],
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(got["nu"][k], want["nu"][k],
                                       rtol=1e-6, atol=1e-12)
            for part in ("params", "mu"):
                np.testing.assert_allclose(
                    got[part][k], want[part][k], rtol=ulp,
                    atol=ulp * np.abs(want[part][k]).max())
        if guard:
            skips, norm = guard_stats(opt)
            assert (skips, math.isnan(norm)) == (
                want["guard"][0], math.isnan(want["guard"][1]))
            if i == POISONED:
                assert all(torch.equal(a, b) for a, b in
                           zip(held, _bits(ps, opt, guard)))
                assert skips == 1
            else:  # JAX sums the bf16 gradients' squares in bf16
                assert norm == pytest.approx(want["guard"][1], rel=ulp)
    assert metric.value - before_metric == (1 if guard else 0)


def test_guarded_state_restores_into_a_fresh_optimizer():
    """The guard's state tree (JAX's ``NonfiniteGuardState`` around
    ``MasterWeightsState``) loaded into a fresh optimizer takes the same
    next step, bit for bit."""
    ps, opt = _port_opt(True)
    _, grads = _params_and_grads()
    grads[1]["b"][0] = np.inf
    for g in grads[:3]:
        _port_step(ps, opt, g)
    tree = opt.state_tree()
    assert set(tree) == {"inner_state", "nonfinite_count", "last_grad_norm"}
    assert set(tree["inner_state"]) == {"master", "inner_state"}
    assert set(tree["inner_state"]["inner_state"]) == {"mu", "nu", "count"}
    assert int(tree["nonfinite_count"]) == 1
    ps2, fresh = _port_opt(True)
    with torch.no_grad():
        for k in ps:
            ps2[k].copy_(ps[k])
    fresh.load_state_tree(tree)
    _port_step(ps, opt, grads[3])
    _port_step(ps2, fresh, grads[3])
    assert all(torch.equal(a, b) for a, b in
               zip(_bits(ps, opt, True), _bits(ps2, fresh, True)))
    assert guard_stats(fresh)[0] == 1


def test_blocked_update_is_bitwise_the_whole_one(monkeypatch):
    """``Fp32GradAdamW`` steps its parameters in blocks of about
    ``BLOCK`` elements; blocks of one parameter each give the one-block
    run's parameters, masters, moments and count bit for bit, through a
    skipped step too."""
    _, grads = _params_and_grads()
    grads[1]["w"][0, 0] = np.nan
    runs = []
    for block in (1 << 26, 16):
        monkeypatch.setattr(Fp32GradAdamW, "BLOCK", block)
        ps, opt = _port_opt(True)
        for g in grads:
            _port_step(ps, opt, g)
        runs.append(_bits(ps, opt, True))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert int(runs[0][-1]) == len(grads) - 1


def test_state_dtypes_and_bytes():
    """fp32 master, bf16 mu, fp32 nu: 10 bytes per parameter."""
    ps, opt = _port_opt(False)
    assert all(m.dtype == torch.float32 for m in opt.master)
    assert all(m.dtype == torch.bfloat16 for m in opt.inner.mu)
    assert all(v.dtype == torch.float32 for v in opt.inner.nu)
    n = sum(p.numel() for p in ps.values())
    state = sum(t.numel() * t.element_size()
                for t in opt.master + opt.inner.mu + opt.inner.nu)
    assert state == 10 * n


def test_exact_roundtrip_vs_master():
    """After three updates the bf16 params equal round_bf16(master)."""
    w = nn.Parameter(torch.from_numpy(np.random.default_rng(1).normal(
        size=(32,)).astype(np.float32)).bfloat16())
    opt = bf16_adamw(3e-2)([w])
    for _ in range(3):
        w.grad = torch.ones(32, dtype=torch.bfloat16) * 0.1
        opt.step()
    assert torch.equal(w, opt.master[0].bfloat16())


def test_master_weights_track_fp32_trajectory():
    """SGD at lr 1e-4 on a quadratic, 200 steps: bf16 params with fp32
    masters follow the fp32 run to within 0.02; plain bf16 loses the
    small updates (5x worse), as tests/test_optim.py asserts of JAX."""
    w0 = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)

    def run(dtype, factory, steps=200):
        w = nn.Parameter(torch.tensor(w0, dtype=dtype))  # a copy
        opt = factory([w])
        for _ in range(steps):
            loss = (w.float() ** 2).sum()
            loss.backward()
            opt.step()
            opt.zero_grad()
        return w.detach().float()

    sgd = functools.partial(torch.optim.SGD, lr=1e-4)
    ref = run(torch.float32, sgd)
    master = run(torch.bfloat16, master_weights(sgd))
    naive = run(torch.bfloat16, sgd)
    err_master = float((master - ref).abs().max())
    err_naive = float((naive - ref).abs().max())
    assert err_master < 0.02, err_master
    assert err_naive > 5 * err_master


def test_nonfinite_guard_skips_poisoned_update(monkeypatch):
    """tests/test_sentinel.py's case on the port: the guard around SGD
    with momentum 0.9 (``torch.optim.SGD``, dampening 0: optax.sgd's
    trace) skips a NaN update, keeps the momentum, counts the skip."""
    monkeypatch.setattr(bf16_mod, "_skips_published", 0)
    c = T.default_registry().counter("dlrover_optim_nonfinite_skips_total")
    before = c.value
    w = nn.Parameter(torch.ones(4))
    opt = nonfinite_guard(functools.partial(
        torch.optim.SGD, lr=0.1, momentum=0.9))([w])
    w.grad = torch.full((4,), 0.5)
    opt.step()
    skips, norm = guard_stats(opt)
    assert skips == 0 and norm == pytest.approx(1.0)
    trace = opt.inner.state[w]["momentum_buffer"].clone()
    held = w.detach().clone()
    w.grad = torch.tensor([np.nan, 0.5, 0.5, 0.5])
    opt.step()
    assert torch.equal(w.detach(), held)  # the whole update skipped
    # the momentum trace kept its previous (finite) value
    assert torch.equal(opt.inner.state[w]["momentum_buffer"], trace)
    skips, norm = guard_stats(opt)
    assert skips == 1 and math.isnan(norm)
    assert c.value - before == 1


# --------------------------------------------------------------- WSAM


class _Tree(nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(w))
        self.b = nn.Parameter(torch.from_numpy(b))


def _jax_tree_loss(params, x):
    return jnp.sum((x @ params["w"] + params["b"]) ** 4) / x.shape[0]


def _port_tree_loss(model, x):
    return ((x @ model.w + model.b) ** 4).sum() / x.shape[0]


def test_wsam_gradient_matches_jax():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    x = rng.standard_normal((8, 6)).astype(np.float32)
    loss, grads = jax_wsam.wsam_value_and_grad(
        _jax_tree_loss, rho=0.01, gamma=0.9)({"w": w, "b": b}, x)
    got_loss, got = wsam_value_and_grad(_port_tree_loss, rho=0.01,
                                        gamma=0.9)(_Tree(w, b),
                                                   torch.from_numpy(x))
    assert got_loss.item() == pytest.approx(float(loss), rel=1e-6)
    for name, g in zip(("w", "b"), got):
        np.testing.assert_allclose(g.numpy(), np.asarray(grads[name]),
                                   rtol=1e-5, atol=1e-6)


def test_wsam_reduces_to_plain_gradient_at_rho_zero():
    model = _Tree(np.ones((3, 4), np.float32), np.zeros(4, np.float32))
    x = torch.ones(2, 3)
    loss, g = wsam_value_and_grad(_port_tree_loss, rho=0.0, gamma=0.7)(
        model, x)
    plain = torch.autograd.grad(_port_tree_loss(model, x),
                                [model.w, model.b])
    assert loss.item() == pytest.approx(_port_tree_loss(model, x).item())
    for a, b in zip(g, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


def test_wsam_sharper_direction_weighted_in():
    """On f(w) = w^4 the adversarial gradient is larger, so WSAM's
    combined gradient exceeds the plain one."""
    class Quartic(nn.Module):
        def __init__(self):
            super().__init__()
            self.w = nn.Parameter(torch.full((4,), 0.5))

    model = Quartic()

    def loss(m, _):
        return (m.w ** 4).sum()

    (plain,) = torch.autograd.grad(loss(model, None), [model.w])
    _, (g,) = wsam_value_and_grad(loss, rho=0.1, gamma=0.9)(model, None)
    assert float(g.norm()) > float(plain.norm())
    assert torch.equal(model.w.detach(), torch.full((4,), 0.5))


def _llama_batch(cfg, seed):
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (4, 33))
    return tokens[:, :-1], tokens[:, 1:]


def test_value_and_grad_hook_matches_the_jax_trainer():
    """``ShardedTrainer(value_and_grad=wsam_value_and_grad(rho=0.01))``
    against the JAX trainer with JAX's WSAM on llama_tiny in fp32, two
    adamw steps from the same weights; the hook takes the trainer's own
    loss."""
    jcfg = jax_llama.llama_tiny(dtype=np.float32, remat="off")
    mesh = jax_create_mesh([("data", 1)], devices=[jax.devices()[0]])

    def jloss(p, b):
        return jax_llama.next_token_loss(p, b, jcfg)

    jtrainer = JaxTrainer(
        jloss, lambda r: jax_llama.init_params(r, jcfg),
        jax_llama.param_axes(jcfg), mesh, strategy="ddp",
        optimizer=optax.adamw(1e-3, b1=0.9, b2=0.95),
        value_and_grad=jax_wsam.wsam_value_and_grad(jloss, rho=0.01))
    params, opt_state = jtrainer.init(jax.random.key(0))
    start = jax.tree.map(np.array, params)
    fast = _FastJax("jax")
    fast.jit = functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    saved, jax_sharded.jax = jax_sharded.jax, fast
    try:
        step = jtrainer.train_step  # its jit, with the cheap codegen
    finally:
        jax_sharded.jax = saved
    cfg = llama.llama_tiny(dtype=torch.float32, remat="off")
    batches = [_llama_batch(cfg, 30 + i) for i in range(2)]
    jax_losses = []
    for batch in batches:
        params, opt_state, loss = step(
            params, opt_state, jtrainer.shard_batch(jtrainer.microbatch(
                tuple(x.astype(np.int32) for x in batch))))
        jax_losses.append(float(loss))
    want = _as_port_layout(jax.tree.map(np.asarray, params), jcfg)
    trainer = make_trainer_for_llama(
        cfg, device="cpu", optimizer=adamw(1e-3, b1=0.9, b2=0.95),
        value_and_grad=wsam_value_and_grad(rho=0.01))
    trainer.init(model=llama.params_from_jax(start, cfg, device="cpu"))
    first = {n: p.detach().numpy().copy()
             for n, p in trainer.model.named_parameters()}
    losses = [trainer.train_step(trainer.shard_batch(trainer.microbatch(
        batch))).item() for batch in batches]
    assert losses == pytest.approx(jax_losses, rel=1e-5)
    got = {n: p.detach().numpy() for n, p in trainer.model.named_parameters()}
    # an element's Adam step can swing by up to lr at each step where its
    # gradient is near zero: the bound is one lr per step taken
    _assert_adam_close(got, want, first, lr=len(batches) * 1e-3)


def test_wsam_trains_in_sharded_trainer():
    """tests/test_optim.py's TestWsam case on the port: five adamw steps
    of llama_tiny with WSAM on one batch lower the loss."""
    cfg = llama.llama_tiny()
    trainer = make_trainer_for_llama(
        cfg, device="cpu", optimizer=adamw(1e-3),
        value_and_grad=wsam_value_and_grad(rho=0.01))
    trainer.init(seed=0)
    tok = np.ones((4, 64), np.int64)
    mb = trainer.shard_batch(trainer.microbatch((tok, tok)))
    losses = [trainer.train_step(mb).item() for _ in range(5)]
    assert losses[-1] < losses[0]


def test_bf16_adamw_in_a_sharded_trainer():
    """llama_tiny in bf16 under fsdp (one rank) with the guarded
    bf16_adamw: 10 bytes of optimizer state per parameter, the state in
    the JAX tree's coordinates (``NonfiniteGuardState`` around
    ``MasterWeightsState``), a planted inf skipped bitwise, and a fresh
    trainer restored from the state taking the same next step."""
    cfg = llama.llama_tiny()

    def trainer_for(seed):
        t = make_trainer_for_llama(
            cfg, device="cpu", strategy="fsdp",
            optimizer=bf16_adamw(1e-3, guard_nonfinite=True))
        t.init(seed=seed)
        return t

    t = trainer_for(0)
    n = sum(s.numel() for s in t._stored)
    assert t.state_bytes()["optimizer"] == 10 * n
    batches = [tuple(torch.from_numpy(x.astype(np.int64))[None]
                     for x in _llama_batch(cfg, 40 + i)) for i in range(3)]
    t.train_step(batches[0])
    held = [x.clone() for x in _state_tensors(t)]
    hook = t.model.embed.register_hook(
        lambda g: g.index_put((torch.tensor([1]), torch.tensor([2])),
                              torch.tensor(float("inf"), dtype=g.dtype)))
    t.train_step(batches[1])
    hook.remove()
    assert all(torch.equal(a, b) for a, b in zip(held, _state_tensors(t)))
    skips, norm = guard_stats(t)
    assert skips == 1 and not math.isfinite(norm)
    state = t.train_state()
    opt = state["optimizer"]
    assert isinstance(opt["inner_state"]["master"]["embed"], ShardedLeaf)
    assert isinstance(opt["inner_state"]["inner_state"]["mu"]["blocks"][
        "wq"], ShardedLeaf)
    fresh = trainer_for(1)
    fresh.load_train_state(state)
    assert t.train_step(batches[2]).item() == \
        fresh.train_step(batches[2]).item()
    assert all(torch.equal(a, b) for a, b in
               zip(_state_tensors(t), _state_tensors(fresh)))


def _state_tensors(t):
    from dlrover_tpu_torch.trainer.sharded import (
        optimizer_state, per_param_leaves)

    return list(t._stored) + [
        x for _, ts in per_param_leaves(optimizer_state(t.optimizer))
        for x in ts]
