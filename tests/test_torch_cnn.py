"""The port's MNIST CNN against the JAX package's, from the same weights.

The JAX parameter tree is drawn with numpy from a seed (biases away
from 0) and carried across by ``params_from_jax``; images and labels
come from a numpy seed, with padding labels (-1). In fp32 the logits,
the masked loss and every gradient agree within 1e-4 relative and 1e-5
of the tensor's largest element (tighter than the 2e-3 of
``tests/test_flash_attention.py``), and three ``adam(1e-3)`` steps
follow ``optax.adam`` under ``test_torch_trainer``'s Adam rule. A flatten
in NCHW order, or HWIO kernels reshaped instead of permuted, fails the
comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from dlrover_tpu.models import cnn as jax_cnn
from dlrover_tpu_torch.models import cnn, example_batch, make_trainer_for
from dlrover_tpu_torch.models import model_module_for
from dlrover_tpu_torch.trainer.sharded import adam

from tests.test_torch_gpt import FAST_COMPILE
from tests.test_torch_llama import one_thread  # noqa: F401
from tests.test_torch_trainer import _assert_adam_close

RTOL, ATOL = 1e-4, 1e-5
BATCH = 16


def _np_params(jcfg, seed=0):
    shapes = jax.eval_shape(lambda k: jax_cnn.init_params(k, jcfg),
                            jax.random.key(0))
    rng = np.random.default_rng(seed)

    def leaf(s):
        x = rng.standard_normal(s.shape)
        if len(s.shape) == 1:
            return (0.1 * x).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (x * (2.0 / fan_in) ** 0.5).astype(np.float32)

    return jax.tree.map(leaf, shapes)


def _batch(seed=0, n=BATCH):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, n).astype(np.int32)
    labels[-3:] = -1  # a tail shard's padding
    return images, labels


def _as_port_layout(tree):
    out = {
        "conv1.weight": np.transpose(tree["conv1"], (3, 2, 0, 1)),
        "conv1.bias": tree["b1"],
        "conv2.weight": np.transpose(tree["conv2"], (3, 2, 0, 1)),
        "conv2.bias": tree["b2"],
        "fc1.weight": np.asarray(tree["fc1"]).T, "fc1.bias": tree["fb1"],
        "fc2.weight": np.asarray(tree["fc2"]).T, "fc2.bias": tree["fb2"],
    }
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_run():
    """(numpy params, batch, the jitted JAX step, its logits, loss and
    port-layout grads)."""
    jcfg = jax_cnn.mnist_cnn()

    def loss_and_logits(params, images, labels):
        return (jax_cnn.loss(params, (images, labels), jcfg),
                jax_cnn.forward(params, images, jcfg))

    step = jax.jit(jax.value_and_grad(loss_and_logits, has_aux=True),
                   compiler_options=FAST_COMPILE)
    params = _np_params(jcfg)
    batch = _batch()
    (loss, logits), grads = step(jax.tree.map(jnp.asarray, params),
                                 *map(jnp.asarray, batch))
    return (params, batch, step, np.asarray(logits), float(loss),
            _as_port_layout(jax.tree.map(np.asarray, grads)))


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


def test_forward_masked_loss_and_grads_match_jax(jax_run):
    params, batch, _, logits, loss, grads = jax_run
    model = cnn.params_from_jax(params, cnn.mnist_cnn(), device="cpu")
    images, labels = (torch.from_numpy(x) for x in batch)
    got = cnn.loss(model, (images, labels))
    got.backward()
    assert got.item() == pytest.approx(loss, rel=RTOL)
    with torch.no_grad():
        _assert_close(model(images).numpy(), logits)
    for name, p in model.named_parameters():
        _assert_close(p.grad.numpy(), grads[name])


def test_labels_below_zero_are_masked(jax_run):
    """The padded rows change neither the loss nor the gradients: the
    loss equals that of the unpadded rows alone."""
    params, (images, labels), *_ = jax_run
    model = cnn.params_from_jax(params, cnn.mnist_cnn(), device="cpu")
    keep = labels >= 0
    full = cnn.loss(model, (torch.from_numpy(images),
                            torch.from_numpy(labels)))
    kept = cnn.loss(model, (torch.from_numpy(images[keep]),
                            torch.from_numpy(labels[keep])))
    assert full.item() == pytest.approx(kept.item(), rel=1e-6)
    none = cnn.loss(model, (torch.from_numpy(images),
                            torch.full((BATCH,), -1, dtype=torch.int32)))
    assert none.item() == 0.0


def _logits_nchw_flatten(model, images):
    """The model with its flatten in NCHW order (the bug to catch)."""
    x = images.permute(0, 3, 1, 2)
    x = F.max_pool2d(F.relu(model.conv1(x)), 2, 2)
    x = F.max_pool2d(F.relu(model.conv2(x)), 2, 2)
    return model.fc2(F.relu(model.fc1(x.reshape(x.shape[0], -1))))


def test_wrong_flatten_order_fails(jax_run):
    params, (images, _), _, logits, _, _ = jax_run
    model = cnn.params_from_jax(params, cnn.mnist_cnn(), device="cpu")
    with torch.no_grad():
        got = _logits_nchw_flatten(model, torch.from_numpy(images)).numpy()
    with pytest.raises(AssertionError):
        _assert_close(got, logits)


def test_unpermuted_hwio_weight_fails(jax_run):
    params, (images, _), _, logits, _, _ = jax_run
    model = cnn.params_from_jax(params, cnn.mnist_cnn(), device="cpu")
    with torch.no_grad():  # HWIO bytes read as OIHW: a reshape
        for name in ("conv1", "conv2"):
            conv = getattr(model, name)
            conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(
                params[name])).reshape(conv.weight.shape))
        got = model(torch.from_numpy(images)).numpy()
    with pytest.raises(AssertionError):
        _assert_close(got, logits)


def test_three_adam_steps_match_optax(jax_run):
    params, _, step, *_ = jax_run
    batches = [_batch(seed=100 + i) for i in range(3)]
    opt = optax.adam(1e-3)
    update = jax.jit(opt.update, compiler_options=FAST_COMPILE)
    jparams = jax.tree.map(jnp.asarray, params)
    state = opt.init(jparams)
    jax_losses = []
    for batch in batches:
        (loss, _), grads = step(jparams, *map(jnp.asarray, batch))
        updates, state = update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jax_losses.append(float(loss))
    want = _as_port_layout(jax.tree.map(np.asarray, jparams))

    cfg = cnn.mnist_cnn()
    trainer = make_trainer_for(cfg, device="cpu", optimizer=adam(1e-3))
    trainer.init(model=cnn.params_from_jax(params, cfg, device="cpu"))
    start = {n: p.detach().numpy().copy()
             for n, p in trainer.model.named_parameters()}
    losses = [trainer.train_step(trainer.shard_batch(
        trainer.microbatch(batch))).item() for batch in batches]
    assert losses == pytest.approx(jax_losses, rel=RTOL)
    got = {n: p.detach().numpy() for n, p in trainer.model.named_parameters()}
    _assert_adam_close(got, want, start, lr=1e-3)
    # Adam's state is AdamW's, without decay
    opt_state = trainer.train_state()["optimizer"]
    assert opt_state["count"] == 3 and set(opt_state) == {"mu", "nu",
                                                          "count"}


def test_contract_matches_jax():
    jcfg, tcfg = jax_cnn.mnist_cnn(), cnn.mnist_cnn()
    assert cnn.param_count(tcfg) == jax_cnn.param_count(jcfg)
    assert cnn.flops_per_token(tcfg) == jax_cnn.flops_per_token(jcfg)
    assert model_module_for(jcfg) is cnn
    images, labels = example_batch(tcfg, 4)
    want = jax_cnn.example_batch(jcfg, 4)
    assert [(x.shape, x.dtype) for x in (images, labels)] == \
        [(x.shape, x.dtype) for x in want]
    model = cnn.init_params(tcfg, seed=0, device="cpu")
    again = cnn.init_params(tcfg, seed=0, device="cpu")
    assert torch.equal(model.fc1.weight, again.fc1.weight)
    assert model.fc1.weight.std().item() == pytest.approx(
        (2.0 / 3136) ** 0.5, rel=0.05)
