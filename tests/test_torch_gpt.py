"""The port's GPT against the JAX package's, from the same weights.

The JAX parameter tree is drawn with numpy from a seed in the shapes
``jax.eval_shape`` gives (biases and LayerNorms away from 0 and 1, so
that each one shows) and carried across by ``params_from_jax``; tokens
come from a numpy seed. In fp32 the logits, the loss and every gradient
agree within 1e-4 relative and 1e-5 of the tensor's largest element (the
Llama port's rule, tighter than the 2e-3 of
``tests/test_flash_attention.py``, so that an erf GELU in place of the
tanh one fails it). The head_dim-64, seq-128
config runs in bf16 through the flash kernels' plain versions and is
held to 5e-2.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from dlrover_tpu.models import example_batch as jax_example_batch
from dlrover_tpu.models import gpt as jax_gpt
from dlrover_tpu_torch.models import (
    example_batch,
    gpt,
    make_trainer_for,
    model_module_for,
)
from dlrover_tpu_torch.ops.cuda import flash_attention as fa
from dlrover_tpu_torch.trainer.sharded import adamw

from tests.test_torch_llama import one_thread  # noqa: F401
from tests.test_torch_trainer import _assert_adam_close

RTOL, ATOL = 1e-4, 1e-5
BF16_TOL = 5e-2

#: name -> (config kwargs, dtype, batch, seq)
CONFIGS = {
    "tiny": ({}, "float32", 2, 32),
    "untied_gqa": ({"tie_lm_head": False, "num_kv_heads": 2}, "float32",
                   2, 32),
    # head_dim 64 and seq 128: the CPU path runs the kernels' plain
    # versions (fwd_plain, dq_plain, dkv_plain)
    "d64_s128": ({"hidden_size": 128, "num_heads": 2, "max_seq_len": 128},
                 "bfloat16", 2, 128),
}


def _np_params(jcfg, seed=0):
    """The JAX model's parameter tree as numpy, drawn from ``seed``."""
    shapes = jax.eval_shape(lambda k: jax_gpt.init_params(k, jcfg),
                            jax.random.key(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(s.shape)
        if "scale" in name:
            x = 1 + 0.1 * x
        elif len(s.shape) == (2 if "blocks" in name else 1):  # biases
            x = 0.1 * x
        elif "embed" in name:
            x = 0.5 * x
        else:  # matrices; the MLP's input widened into GELU's bend
            x = x * s.shape[-2] ** -0.5 * (2 if "w_fc" in name else 1)
        return np.asarray(x, dtype=s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    targets = np.roll(tokens, -1, axis=1)
    targets[:, -1] = -1
    targets[0, :5] = -1
    return tokens, targets


def _as_port_layout(tree, cfg):
    """JAX parameter (or gradient) tree -> {port parameter name: fp32}."""
    out = {n: tree[n] for n in ("embed", "pos_embed", "final_ln_scale",
                                "final_ln_bias")}
    if not cfg.tie_lm_head:
        out["lm_head.weight"] = np.asarray(tree["lm_head"]).T
    for i in range(cfg.num_layers):
        for name, arr in tree["blocks"].items():
            arr = np.asarray(arr[i])
            if name.startswith("ln"):
                out[f"blocks.{i}.{name}"] = arr
            elif name.startswith("b"):
                weight = {"bq": "wq", "bk": "wk", "bv": "wv", "bo": "wo",
                          "b_fc": "w_fc", "b_proj": "w_proj"}[name]
                out[f"blocks.{i}.{weight}.bias"] = arr
            else:
                out[f"blocks.{i}.{name}.weight"] = arr.T
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


#: gpt_tiny's fields, which the configs above override
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=256,
            num_layers=2, num_heads=4, max_seq_len=64, remat="off")


def _configs(name, **extra):
    kw, dtype, b, s = CONFIGS[name]
    kw = {**TINY, **kw, **extra}
    return (jax_gpt.GPTConfig(dtype=getattr(jnp, dtype), **kw),
            gpt.GPTConfig(dtype=getattr(torch, dtype), **kw), b, s)


#: XLA's cheaper codegen: the module's compiles take half the time
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _jax_value_and_grad(jcfg):
    def loss_and_logits(params, tokens, targets):
        return (jax_gpt.next_token_loss(params, (tokens, targets), jcfg),
                jax_gpt.forward(params, tokens, jcfg))

    step = jax.jit(jax.value_and_grad(loss_and_logits, has_aux=True),
                   compiler_options=FAST_COMPILE)

    def run(params, tokens, targets):
        (loss, logits), grads = step(params, tokens, targets)
        return logits, loss, grads
    return run


@pytest.fixture(scope="module")
def jax_runs():
    """Per config: (numpy params, batch, the jitted JAX step, its
    logits, loss and port-layout grads)."""
    out = {}
    for name in CONFIGS:
        jcfg, _, b, s = _configs(name)
        params = _np_params(jcfg)
        batch = _batch(jcfg, b, s)
        run = _jax_value_and_grad(jcfg)
        logits, loss, grads = run(jax.tree.map(jnp.asarray, params),
                                  *map(jnp.asarray, batch))
        out[name] = (params, batch, run, np.asarray(logits, np.float32),
                     float(loss), _as_port_layout(grads, jcfg))
    return out


def _port(name, params, batch, **extra):
    """(logits, loss, grads) of the port's model from ``params``."""
    _, tcfg, _, _ = _configs(name, **extra)
    model = gpt.params_from_jax(params, tcfg, device="cpu")
    tokens, targets = (torch.from_numpy(x).long() for x in batch)
    with torch.no_grad():
        logits = model(tokens).numpy()
    loss = gpt.next_token_loss(model, (tokens, targets))
    loss.backward()
    return logits, loss.item(), {n: p.grad.float().numpy()
                                 for n, p in model.named_parameters()}


def _rel_norm(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


#: the k projection's bias has no gradient in exact arithmetic (it moves
#: every score of a query row alike, and softmax ignores that): both
#: sides hold rounding noise there, held against the largest gradient
NO_GRAD = ".wk.bias"


def _assert_grads_close(got, want, bf16=False):
    assert got.keys() == want.keys()
    scale = max(np.abs(g).max() for g in want.values())
    tol = BF16_TOL if bf16 else ATOL
    for n in want:
        if n.endswith(NO_GRAD):
            assert max(np.abs(got[n]).max(), np.abs(want[n]).max()) \
                <= tol * scale, n
        elif bf16:
            assert _rel_norm(got[n], want[n]) <= BF16_TOL, n
        else:
            np.testing.assert_allclose(
                got[n], want[n], rtol=RTOL,
                atol=ATOL * max(1.0, np.abs(want[n]).max()), err_msg=n)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_loss_and_grads_match_jax(jax_runs, name):
    params, batch, _, logits, loss, grads = jax_runs[name]
    got_logits, got_loss, got_grads = _port(name, params, batch)
    bf16 = CONFIGS[name][1] == "bfloat16"
    if bf16:
        assert _rel_norm(got_logits, logits) <= BF16_TOL
        assert got_loss == pytest.approx(loss, rel=BF16_TOL)
    else:
        np.testing.assert_allclose(got_logits, logits, rtol=RTOL,
                                   atol=ATOL * np.abs(logits).max())
        assert got_loss == pytest.approx(loss, rel=RTOL)
    _assert_grads_close(got_grads, grads, bf16=bf16)


@pytest.mark.parametrize("remat,fwd", [("off", 4), ("dots", 6),
                                       ("dots_attn_out", 4)])
def test_d64_config_runs_the_kernels_plain_versions(jax_runs, monkeypatch,
                                                     remat, fwd):
    """The head_dim-64, seq-128 model's attention goes through
    ``flash_attention_cuda``'s forward, dQ and dK/dV on the CPU (their
    plain versions), and through no reference: two forwards (the logits,
    then the loss) and one backward of two layers. "dots" recomputes
    each block in the backward, the forward kernel included;
    "dots_attn_out" keeps the attention call outside its segments."""
    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    for name in calls:
        plain = getattr(fa, f"{name}_plain")

        def counted(*args, _plain=plain, _name=name):
            calls[_name] += 1
            return _plain(*args)
        monkeypatch.setattr(fa, f"{name}_plain", counted)
    monkeypatch.setattr("dlrover_tpu_torch.ops.attention.mha_reference",
                        None)
    params, batch, _, logits, loss, grads = jax_runs["d64_s128"]
    got_logits, got_loss, got_grads = _port("d64_s128", params, batch,
                                            remat=remat)
    assert calls == {"fwd": fwd, "dq": 2, "dkv": 2}
    assert got_loss == pytest.approx(loss, rel=BF16_TOL)
    _assert_grads_close(got_grads, grads, bf16=True)


def test_chunked_ce_matches_the_full_loss(jax_runs):
    """loss_chunk 24 over 64 tokens: three chunks, the last padded."""
    params, batch, _, _, loss, grads = jax_runs["tiny"]
    _, got_loss, got_grads = _port("tiny", params, batch, loss_chunk=24)
    assert got_loss == pytest.approx(loss, rel=RTOL)
    _assert_grads_close(got_grads, grads)


def test_tied_head_gradient_sums_both_uses(jax_runs):
    """The tied head's embedding gradient is the lookup's plus the
    head's: an untied copy of the same weights splits it in two."""
    params, batch, _, _, _, grads = jax_runs["tiny"]
    untied = dict(params, lm_head=np.asarray(params["embed"]).T.copy())
    _, _, got = _port("tiny", untied, batch, tie_lm_head=False)
    np.testing.assert_allclose(got["embed"] + got["lm_head.weight"],
                               grads["embed"], rtol=RTOL, atol=ATOL)


def test_erf_gelu_fails_the_comparison(jax_runs, monkeypatch):
    params, batch, _, logits, _, _ = jax_runs["tiny"]
    erf = partial(F.gelu, approximate="none")
    monkeypatch.setattr(F, "gelu", lambda x, approximate="none": erf(x))
    got, _, _ = _port("tiny", params, batch)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, logits, rtol=RTOL,
                                   atol=ATOL * np.abs(logits).max())


def test_three_adamw_steps_match_jax(jax_runs):
    params, _, run, _, _, _ = jax_runs["tiny"]
    jcfg, tcfg, b, s = _configs("tiny")
    batches = [_batch(jcfg, b, s, seed=100 + i) for i in range(3)]
    opt = optax.adamw(1e-3, b1=0.9, b2=0.95)
    update = jax.jit(opt.update, compiler_options=FAST_COMPILE)
    jparams = jax.tree.map(jnp.asarray, params)
    state = opt.init(jparams)
    jax_losses = []
    for batch in batches:
        _, loss, grads = run(jparams, *map(jnp.asarray, batch))
        updates, state = update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jax_losses.append(float(loss))
    want = _as_port_layout(jax.tree.map(np.asarray, jparams), jcfg)

    trainer = make_trainer_for(tcfg, device="cpu",
                               optimizer=adamw(1e-3, b1=0.9, b2=0.95))
    trainer.init(model=gpt.params_from_jax(params, tcfg, device="cpu"))
    start = {n: p.detach().numpy().copy()
             for n, p in trainer.model.named_parameters()}
    losses = [trainer.train_step(trainer.shard_batch(trainer.microbatch(
        tuple(x.astype(np.int64) for x in batch)))).item()
        for batch in batches]
    assert losses == pytest.approx(jax_losses, rel=RTOL)
    got = {n: p.detach().numpy() for n, p in trainer.model.named_parameters()}
    # Adam scales the k bias's rounding noise (NO_GRAD) up to steps of
    # +-lr, whose signs the two sides draw apart
    noise = [n for n in want if n.endswith(NO_GRAD)]
    for n in noise:
        assert np.abs(got[n] - want[n]).max() <= 2 * 1e-3, n
    _assert_adam_close(*({n: x for n, x in d.items() if n not in noise}
                         for d in (got, want, start)), lr=1e-3)


@pytest.mark.parametrize("preset", ["gpt2_small", "gpt2_xl", "gpt_tiny"])
def test_param_count_and_flops_match_jax(preset):
    jcfg, tcfg = getattr(jax_gpt, preset)(), getattr(gpt, preset)()
    assert gpt.param_count(tcfg) == jax_gpt.param_count(jcfg)
    assert gpt.flops_per_token(tcfg, 1024) == \
        jax_gpt.flops_per_token(jcfg, 1024)
    assert model_module_for(jcfg) is gpt
    tokens, targets = example_batch(tcfg, 4, 16)
    want = jax_example_batch(jcfg, 4, 16)
    assert tokens.shape == targets.shape == want[0].shape == (4, 16)
    assert not tokens.any()


def test_gpt2_xl_is_the_published_shape():
    cfg = gpt.gpt2_xl()
    assert (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
            cfg.num_heads, cfg.kv_heads, cfg.head_dim, cfg.vocab_size,
            cfg.max_seq_len, cfg.tie_lm_head, cfg.remat) == (
        48, 1600, 6400, 25, 25, 64, 50257, 1024, True, "dots")
    assert gpt.param_count(cfg) == 1_557_611_200
    with pytest.raises(ValueError, match="max_seq_len"):
        gpt.init_params(gpt.gpt_tiny(), device="cpu")(
            torch.zeros(1, 65, dtype=torch.long))
