"""The port's Llama against the JAX package's, from the same weights.

JAX-initialised parameters are carried across by ``params_from_jax``;
tokens and targets come from a numpy seed. In fp32 the logits, losses
and every gradient agree to 1e-4 (relative; the two frameworks sum in
other orders), in bf16 the loss to 5e-2.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import gpt as jax_gpt
from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.ops.pallas.flash_attention import flash_attention_tpu
from dlrover_tpu_torch.models import llama, model_module_for
from dlrover_tpu_torch.ops.cuda.flash_attention import flash_attention_cuda

RTOL, ATOL = 1e-4, 1e-5


def _configs(remat="off", dtype="float32", **kw):
    jcfg = jax_llama.llama_tiny(remat=remat, dtype=getattr(jnp, dtype), **kw)
    tcfg = llama.llama_tiny(remat=remat, dtype=getattr(torch, dtype), **kw)
    return jcfg, tcfg


def _batch(cfg, b=2, s=64, seed=0, masked=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    targets = np.roll(tokens, -1, axis=1)
    if masked:
        targets[:, -1] = -1
        targets[0, :5] = -1
    return tokens, targets


def _jax_params(jcfg, seed=0):
    return jax_llama.init_params(jax.random.key(seed), jcfg)


def _as_port_layout(tree, cfg):
    """JAX parameter (or gradient) tree -> {port parameter name: array}."""
    out = {
        "embed": tree["embed"], "final_norm": tree["final_norm"],
        "lm_head.weight": np.asarray(tree["lm_head"]).T,
    }
    for i in range(cfg.num_layers):
        for name, arr in tree["blocks"].items():
            arr = np.asarray(arr[i])
            if name.endswith("norm"):
                out[f"blocks.{i}.{name}"] = arr
            else:
                out[f"blocks.{i}.{name}.weight"] = arr.T
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _loss_and_grads(model, batch, attn_fn=None):
    model.zero_grad(set_to_none=True)
    tokens, targets = (torch.from_numpy(x).long() for x in batch)
    loss = llama.next_token_loss(model, (tokens, targets), attn_fn=attn_fn)
    loss.backward()
    return loss.item(), {n: p.grad.float().numpy()
                         for n, p in model.named_parameters()}


def _jax_loss_and_grads(params, batch, jcfg, attn_fn=None):
    fn = partial(jax_llama.next_token_loss, cfg=jcfg, attn_fn=attn_fn)
    loss, grads = jax.value_and_grad(fn)(
        params, tuple(jnp.asarray(x) for x in batch))
    return float(loss), _as_port_layout(grads, jcfg)


def _assert_grads_close(got, want, rtol=RTOL, atol=ATOL):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, err_msg=name)


def test_params_from_jax_carries_every_weight():
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg)
    model = llama.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                  device="cpu")
    want = _as_port_layout(params, jcfg)
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert sum(p.numel() for p in model.parameters()) == \
        jax_llama.param_count(jcfg)


def test_logits_match_jax():
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg)
    model = llama.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                  device="cpu")
    tokens, _ = _batch(tcfg)
    want = np.asarray(jax_llama.forward(params, jnp.asarray(tokens), jcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("loss_chunk", [0, 48])
def test_loss_and_grads_match_jax(loss_chunk):
    # 48 does not divide the 128 tokens: the chunked path pads
    jcfg, tcfg = _configs(loss_chunk=loss_chunk)
    params = _jax_params(jcfg)
    model = llama.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                  device="cpu")
    batch = _batch(tcfg)
    loss_j, grads_j = _jax_loss_and_grads(params, batch, jcfg)
    loss_t, grads_t = _loss_and_grads(model, batch)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    _assert_grads_close(grads_t, grads_j)


def test_kernel_path_matches_pallas_path():
    """The whole loss through the kernels' plain versions against the
    JAX loss through the Pallas kernels (interpret mode), at a head_dim
    of 64 the kernels take."""
    kw = dict(hidden_size=128, num_heads=2, num_kv_heads=1)
    jcfg, tcfg = _configs(**kw)
    params = _jax_params(jcfg, seed=1)
    model = llama.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                  device="cpu")
    batch = _batch(tcfg, b=1, s=128, seed=1)
    pallas = partial(flash_attention_tpu, causal=True, block_q=64,
                     block_k=64)
    loss_j, grads_j = _jax_loss_and_grads(params, batch, jcfg, pallas)
    loss_t, grads_t = _loss_and_grads(model, batch, flash_attention_cuda)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    _assert_grads_close(grads_t, grads_j, rtol=5e-3, atol=5e-4)


def test_bf16_loss_close_to_jax():
    jcfg, tcfg = _configs(dtype="bfloat16")
    params = _jax_params(jcfg)
    model = llama.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                  device="cpu")
    assert model.embed.dtype == torch.bfloat16
    assert model.blocks[0].attn_norm.dtype == torch.float32
    batch = _batch(tcfg)
    loss_j = float(jax_llama.next_token_loss(
        params, tuple(jnp.asarray(x) for x in batch), jcfg))
    with torch.no_grad():
        loss_t = llama.next_token_loss(
            model, tuple(torch.from_numpy(x).long() for x in batch)).item()
    assert abs(loss_t - loss_j) < 5e-2


@pytest.mark.parametrize("remat", ["dots", "dots_attn_out", "minimal"])
def test_remat_modes_match_off(remat):
    """Each checkpointing mode gives the loss and gradients of "off",
    with attention through the kernels' autograd Function."""
    _, off_cfg = _configs()
    model = llama.init_params(off_cfg, seed=3, device="cpu")
    batch = _batch(off_cfg, seed=3)
    loss_off, grads_off = _loss_and_grads(model, batch, flash_attention_cuda)
    _, cfg = _configs(remat=remat)
    remat_model = llama.Llama(cfg, device="cpu")
    remat_model.load_state_dict(model.state_dict())
    loss, grads = _loss_and_grads(remat_model, batch, flash_attention_cuda)
    assert loss == pytest.approx(loss_off, rel=1e-6)
    _assert_grads_close(grads, grads_off, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize(
    "preset", ["llama_tiny", "llama_1b", "llama2_7b", "llama2_13b",
               "llama2_70b"])
def test_param_count_and_flops_match_jax(preset):
    jcfg = getattr(jax_llama, preset)()
    tcfg = getattr(llama, preset)()
    assert llama.param_count(tcfg) == jax_llama.param_count(jcfg)
    assert llama.flops_per_token(tcfg, 2048) == \
        jax_llama.flops_per_token(jcfg, 2048)


def test_init_params_distributions():
    cfg = llama.llama_tiny(hidden_size=256, intermediate_size=512,
                           vocab_size=512)
    model = llama.init_params(cfg, seed=0, device="cpu")
    again = llama.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(model.blocks[1].w_up.weight, again.blocks[1].w_up.weight)
    assert model.embed.float().std().item() == pytest.approx(0.02, rel=0.05)
    w_down = model.blocks[0].w_down.weight.float()  # fan_in 512
    assert w_down.std().item() == pytest.approx(512 ** -0.5, rel=0.05)
    assert torch.all(model.final_norm == 1)
    assert model.final_norm.dtype == torch.float32


def test_unported_configs_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        llama.llama_tiny(num_experts=4)
    with pytest.raises(ValueError):
        llama.llama_tiny(remat="everything")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model_module_for(jax_gpt.gpt_tiny())
    with pytest.raises(TypeError):
        model_module_for(object())
    assert model_module_for(llama.llama_tiny()) is llama
