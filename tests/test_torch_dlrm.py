"""The port's DLRM, its embedding lookup and optax's Adagrad against the
JAX package's, from the same weights.

A small config (four features of 10-30 ids, embed_dim 4) keeps the
JAX compiles short; its parameter tree is drawn with numpy from a seed
(the wide table and biases away from 0) and carried across by
``params_from_jax``. Ids include out-of-range values on both sides, and
labels include padding (-1). In fp32 the logits, the masked loss and
every gradient agree within 1e-4 relative and 1e-5 of the tensor's
largest element (tighter than the 2e-3 of
``tests/test_flash_attention.py``); so do three ``adagrad(0.05)`` steps
against ``optax.adagrad(0.05)``, which ``torch.optim.Adagrad`` fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import dlrm as jax_dlrm
from dlrover_tpu_torch.models import dlrm, example_batch, make_trainer_for
from dlrover_tpu_torch.models import model_module_for
from dlrover_tpu_torch.parallel import embedding
from dlrover_tpu_torch.trainer.sharded import RssAdagrad, ShardedTrainer

from tests.test_torch_gpt import FAST_COMPILE

RTOL, ATOL = 1e-4, 1e-5
BATCH = 24
SMALL = dict(vocab_sizes=(10, 20, 30, 5), embed_dim=4, bottom_mlp=(8, 4),
             top_mlp=(8, 4), row_align=8)


def _configs(interaction="dot"):
    return (jax_dlrm.DLRMConfig(interaction=interaction, **SMALL),
            dlrm.DLRMConfig(interaction=interaction, **SMALL))


def _np_params(jcfg, seed=0):
    shapes = jax.eval_shape(lambda k: jax_dlrm.init_params(k, jcfg),
                            jax.random.key(0))
    rng = np.random.default_rng(seed)

    def leaf(s):
        x = rng.standard_normal(s.shape)
        scale = 0.1 if len(s.shape) == 1 else s.shape[0] ** -0.5
        return (x * scale).astype(np.float32)

    return jax.tree.map(leaf, shapes)


def _batch(cfg, seed=0, n=BATCH):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, cfg.dense_dim)).astype(np.float32)
    cat = np.stack([rng.integers(-2, s + 3, n) for s in cfg.vocab_sizes],
                   axis=1).astype(np.int32)  # some ids out of range
    labels = rng.integers(0, 2, n).astype(np.int32)
    labels[-4:] = -1
    return dense, cat, labels


def _as_port_layout(tree):
    out = {"table": tree["table"], "wide": tree["wide"]}
    layers = [(f"{part}.{i}", layer) for part in ("bottom", "top")
              for i, layer in enumerate(tree[part])]
    for name, layer in layers + [("head", tree["head"])]:
        out[f"{name}.weight"] = np.asarray(layer["w"]).T
        out[f"{name}.bias"] = layer["b"]
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def jax_runs():
    """Per interaction: (numpy params, batch, the jitted JAX step, its
    logits, loss and port-layout grads)."""
    out = {}
    for interaction in ("dot", "concat"):
        jcfg, _ = _configs(interaction)

        def loss_and_logits(params, dense, cat, labels, jcfg=jcfg):
            return (jax_dlrm.loss(params, (dense, cat, labels), jcfg),
                    jax_dlrm.forward(params, dense, cat, jcfg))

        step = jax.jit(jax.value_and_grad(loss_and_logits, has_aux=True),
                       compiler_options=FAST_COMPILE)
        params = _np_params(jcfg)
        batch = _batch(jcfg)
        (loss, logits), grads = step(jax.tree.map(jnp.asarray, params),
                                     *map(jnp.asarray, batch))
        out[interaction] = (params, batch, step, np.asarray(logits),
                            float(loss),
                            _as_port_layout(jax.tree.map(np.asarray, grads)))
    return out


def _port_model(params, interaction="dot"):
    return dlrm.params_from_jax(params, _configs(interaction)[1],
                                device="cpu")


@pytest.mark.parametrize("interaction", ["dot", "concat"])
def test_forward_loss_and_grads_match_jax(jax_runs, interaction):
    params, batch, _, logits, loss, grads = jax_runs[interaction]
    model = _port_model(params, interaction)
    tb = tuple(torch.from_numpy(x) for x in batch)
    got = dlrm.loss(model, tb)
    got.backward()
    assert got.item() == pytest.approx(loss, rel=RTOL)
    with torch.no_grad():
        _assert_close(model(*tb[:2]).numpy(), logits)
    for name, p in model.named_parameters():
        _assert_close(p.grad.numpy(), grads[name])


def test_ids_are_clipped_into_their_own_feature(jax_runs, monkeypatch):
    """An id past its feature's vocabulary reads that feature's last row
    (never the next feature's first), a negative id its first."""
    params, (dense, _, _), *_ = jax_runs["dot"]
    model = _port_model(params)
    sizes = np.array(SMALL["vocab_sizes"])
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    rows = []
    lookup = dlrm.vocab_parallel_lookup

    def recorded(table, ids):
        rows.append(ids.tolist())
        return lookup(table, ids)
    monkeypatch.setattr(dlrm, "vocab_parallel_lookup", recorded)

    def logits(ids):
        with torch.no_grad():
            return model(torch.from_numpy(dense), torch.from_numpy(
                np.tile(ids, (BATCH, 1)).astype(np.int32)))

    over, last = logits(sizes + 4), logits(sizes - 1)
    assert rows[0][0] == list(starts + sizes - 1)  # not starts + sizes
    negative, first = logits(-3 * np.ones_like(sizes)), logits(0 * sizes)
    assert rows[4][0] == list(starts)
    assert torch.equal(over, last) and torch.equal(negative, first)


def test_padded_rows_carry_no_gradient(jax_runs):
    """Rows labelled -1 whose ids no other row uses leave those table
    rows' gradients at exactly 0, and the loss is the unpadded rows'."""
    params, (dense, cat, labels), *_ = jax_runs["dot"]
    model = _port_model(params)
    cat = cat.clip(0, np.array(SMALL["vocab_sizes"]) - 1)
    cat[-4:] = np.array(SMALL["vocab_sizes"]) - 1  # ids of the padding
    cat[:-4] = np.minimum(cat[:-4], np.array(SMALL["vocab_sizes"]) - 2)
    batch = tuple(torch.from_numpy(x) for x in (dense, cat, labels))
    loss = dlrm.loss(model, batch)
    loss.backward()
    pad_rows = (model.offsets + model.sizes - 1).long()
    assert torch.count_nonzero(model.table.grad[pad_rows]) == 0
    assert torch.count_nonzero(model.wide.grad[pad_rows]) == 0
    assert torch.count_nonzero(model.table.grad) > 0
    kept = dlrm.loss(model, tuple(x[:-4] for x in batch))
    assert loss.item() == pytest.approx(kept.item(), rel=1e-6)


def _optax_adagrad_steps(jax_runs, batches):
    params, _, step, *_ = jax_runs["dot"]
    opt = optax.adagrad(0.05)
    update = jax.jit(opt.update, compiler_options=FAST_COMPILE)
    jparams = jax.tree.map(jnp.asarray, params)
    state = opt.init(jparams)
    losses = []
    for batch in batches:
        (loss, _), grads = step(jparams, *map(jnp.asarray, batch))
        updates, state = update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        losses.append(float(loss))
    return losses, _as_port_layout(jax.tree.map(np.asarray, jparams))


def _port_steps(params, batches, optimizer=None):
    trainer = make_trainer_for(_configs()[1], device="cpu",
                               optimizer=optimizer)
    trainer.init(model=_port_model(params))
    losses = [trainer.train_step(trainer.shard_batch(
        trainer.microbatch(batch))).item() for batch in batches]
    return trainer, losses, {n: p.detach().numpy()
                             for n, p in trainer.model.named_parameters()}


@pytest.fixture(scope="module")
def adagrad_runs(jax_runs):
    batches = [_batch(_configs()[0], seed=100 + i) for i in range(3)]
    return batches, _optax_adagrad_steps(jax_runs, batches)


def test_three_adagrad_steps_match_optax(jax_runs, adagrad_runs):
    batches, (jax_losses, want) = adagrad_runs
    trainer, losses, got = _port_steps(jax_runs["dot"][0], batches)
    assert isinstance(trainer.optimizer, RssAdagrad)
    assert trainer.strategy == "rowwise"
    assert losses == pytest.approx(jax_losses, rel=RTOL)
    for name in want:
        _assert_close(got[name], want[name])


def test_torch_adagrad_is_another_optimizer(jax_runs, adagrad_runs):
    """``torch.optim.Adagrad``: accumulator from 0, eps after the root."""
    batches, (_, want) = adagrad_runs
    _, _, got = _port_steps(
        jax_runs["dot"][0], batches,
        lambda ps: torch.optim.Adagrad(ps, lr=0.05))
    with pytest.raises(AssertionError):
        for name in want:
            _assert_close(got[name], want[name])


def test_adagrad_state_round_trips(jax_runs, adagrad_runs):
    """``train_state`` carries optax's ``sum_of_squares`` by parameter
    name; a fresh trainer loaded with it takes the same next step."""
    batches, _ = adagrad_runs
    params = jax_runs["dot"][0]
    trainer, _, _ = _port_steps(params, batches[:2])
    state = trainer.train_state()
    assert set(state["optimizer"]) == {"sum_of_squares"}
    assert state["optimizer"]["sum_of_squares"].keys() == state["model"].keys()
    acc = state["optimizer"]["sum_of_squares"]["head.bias"]
    assert acc.item() > 0.1  # 0.1 plus two squared gradients
    fresh = make_trainer_for(_configs()[1], device="cpu")
    fresh.init(model=_port_model(params))
    fresh.load_train_state({k: v for k, v in state.items()})
    mb = trainer.shard_batch(trainer.microbatch(batches[2]))
    assert fresh.train_step(mb).item() == trainer.train_step(mb).item()
    for (n, p), q in zip(trainer.model.named_parameters(),
                         fresh.model.parameters()):
        assert torch.equal(p, q), n


def test_lookup_and_its_gradient_match_a_dense_gather():
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(40, 4, generator=gen, requires_grad=True)
    ids = torch.randint(0, 40, (6, 3), generator=gen, dtype=torch.int32)
    upstream = torch.randn(6, 3, 4, generator=gen)
    got = embedding.vocab_parallel_lookup(table, ids)
    got.backward(upstream)
    one_hot = torch.nn.functional.one_hot(ids.long(), 40).float()
    assert torch.allclose(got, one_hot @ table.detach())
    want = torch.einsum("bfv,bfd->vd", one_hot, upstream)
    assert torch.allclose(table.grad, want, atol=1e-6)
    assert not table.grad.is_sparse
    assert embedding.feature_offsets((10, 20, 30)).tolist() == [0, 10, 30]


def test_strategies(monkeypatch):
    cfg = _configs()[1]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dlrm.make_trainer(cfg, device="cpu", strategy="fsdp")
    assert make_trainer_for(cfg, device="cpu", strategy="ddp").strategy \
        == "ddp"
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="item 1.1"):
        ShardedTrainer(None, None, device="cpu", strategy="rowwise")


@pytest.mark.parametrize("preset", ["criteo_wide_deep", "dlrm_large"])
def test_contract_matches_jax(preset):
    jcfg, tcfg = getattr(jax_dlrm, preset)(), getattr(dlrm, preset)()
    for fn in ("param_count", "flops_per_token", "table_bytes"):
        assert getattr(dlrm, fn)(tcfg) == getattr(jax_dlrm, fn)(jcfg), fn
    assert tcfg.padded_vocab == jcfg.padded_vocab
    assert model_module_for(jcfg) is dlrm
    got = example_batch(tcfg, 4)
    want = jax_dlrm.example_batch(jcfg, 4)
    assert [(x.shape, x.dtype) for x in got] == \
        [(x.shape, x.dtype) for x in want]


def test_criteo_table_and_config_guard():
    cfg = dlrm.criteo_wide_deep()
    assert (cfg.padded_vocab, cfg.embed_dim) == (734_208, 8)
    # the deep table's 51.2 GB and the wide table's 1.6 GB
    assert dlrm.table_bytes(dlrm.dlrm_large()) == 4 * 400_000_000 * 33
    with pytest.raises(ValueError, match="embed_dim"):
        dlrm.DLRMConfig(embed_dim=8, bottom_mlp=(16, 4))
