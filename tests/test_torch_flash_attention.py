"""The port's flash attention against the JAX package.

The port's plain versions of the three kernels (what its wrappers run on
CPU tensors) and its autograd Function are held against the Pallas
kernels in interpret mode, the same inputs made from a numpy seed going
to both. Tolerances are those of tests/test_flash_attention.py: 2e-3
forward and 5e-3 gradients in fp32, 5e-2 in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import closeness, planted_faults
from dlrover_tpu.ops.attention import mha_reference as jax_mha_reference
from dlrover_tpu.ops.pallas.flash_attention import _fwd, flash_attention_tpu
from dlrover_tpu_torch.ops import attention
from dlrover_tpu_torch.ops.cuda import flash_attention as fa

from tests.test_torch_llama import one_thread  # noqa: F401

BLOCK = 64  # Pallas blocks at seq 128: two q and two k blocks


def _arrays(seed, b, s, h, kvh, d, skv=None):
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, d)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, d)).astype(np.float32))


def _torch(*arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrays)


def _jax(*arrays, dtype=jnp.float32):
    return tuple(jnp.asarray(a, dtype) for a in arrays)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 2])
def test_plain_forward_matches_pallas(causal, group):
    b, s, kvh, d = 2, 128, 2, 64
    h = kvh * group
    q, k, v = _arrays(0, b, s, h, kvh, d)
    scale = d ** -0.5

    def kv_layout(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * kvh, s, d)

    qg = jnp.asarray(q).transpose(0, 2, 1, 3).reshape(b * kvh, group, s, d)
    o_jax, lse_jax = _fwd(qg, kv_layout(k), kv_layout(v), scale, causal,
                          BLOCK, BLOCK)
    o_jax = np.asarray(o_jax).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    lse_jax = np.asarray(lse_jax).reshape(b, h, s)

    o, lse = fa.fwd_plain(*_torch(q, k, v), causal, scale)
    np.testing.assert_allclose(o.numpy(), o_jax, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(lse.numpy(), lse_jax, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 2])
def test_gradients_match_pallas_vjp(causal, group):
    b, s, kvh, d = 1, 128, 2, 64
    q, k, v = _arrays(1, b, s, kvh * group, kvh, d)
    do = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)

    o_jax, vjp = jax.vjp(
        lambda q, k, v: flash_attention_tpu(
            q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK),
        *_jax(q, k, v),
    )
    grads_jax = vjp(jnp.asarray(do))

    qt, kt, vt = (x.requires_grad_() for x in _torch(q, k, v))
    o = fa.flash_attention_cuda(qt, kt, vt, causal=causal)
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_jax),
                               rtol=2e-3, atol=2e-3)
    for got, want, name in zip((qt, kt, vt), grads_jax, "qkv"):
        np.testing.assert_allclose(
            got.grad.numpy(), np.asarray(want), rtol=5e-3, atol=5e-3,
            err_msg=f"d{name} mismatch",
        )


def test_bf16_forward_close():
    q, k, v = _arrays(4, 1, 128, 4, 2, 64)
    o_jax = flash_attention_tpu(*_jax(q, k, v, dtype=jnp.bfloat16),
                                causal=True, block_q=BLOCK, block_k=BLOCK)
    o = fa.flash_attention_cuda(*_torch(q, k, v, dtype=torch.bfloat16))
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(
        o.float().numpy(), np.asarray(o_jax.astype(jnp.float32)),
        rtol=5e-2, atol=5e-2,
    )


@pytest.mark.parametrize(
    "causal,qlen,klen", [(True, 64, 64), (False, 64, 64), (True, 32, 64)])
def test_mha_reference_matches_jax(causal, qlen, klen):
    # qlen < klen checks the bottom-right causal alignment
    q, k, v = _arrays(5, 2, qlen, 4, 2, 16, skv=klen)
    out_j, lse_j = jax_mha_reference(*_jax(q, k, v), causal=causal,
                                     return_lse=True)
    out, lse = attention.mha_reference(*_torch(q, k, v), causal=causal,
                                       return_lse=True)
    assert lse.shape == (2, 4, qlen)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j),
                               rtol=2e-5, atol=2e-5)


def test_mha_reference_fully_masked_row():
    q, k, v = _arrays(6, 1, 8, 2, 1, 16)
    mask = np.tril(np.ones((8, 8), dtype=bool))
    mask[3] = False  # query 3 sees nothing
    out_j, lse_j = jax_mha_reference(*_jax(q, k, v), causal=False,
                                     mask=jnp.asarray(mask),
                                     return_lse=True)
    out, lse = attention.mha_reference(*_torch(q, k, v), causal=False,
                                       mask=torch.from_numpy(mask),
                                       return_lse=True)
    assert torch.all(out[:, 3] == 0)
    assert torch.all(lse[:, :, 3] == attention.NEG_INF)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), rtol=2e-5)


@pytest.mark.parametrize("q_shape,k_shape,ok", [
    ((1, 256, 4, 64), (1, 256, 2, 64), True),
    ((1, 256, 4, 48), (1, 256, 2, 48), False),  # head_dim % 64
    ((1, 200, 4, 64), (1, 200, 2, 64), False),  # seq % 128
    ((1, 256, 4, 64), (1, 128, 2, 64), False),  # kv_len != q_len
    ((1, 256, 4, 192), (1, 256, 2, 192), False),  # no 192 kernel instance
    ((1, 192, 4, 128), (1, 192, 2, 128), False),  # seq % 128, not % 64
    # batch * heads past 65535: every kernel runs a persistent grid
    ((4097, 128, 16, 64), (4097, 128, 2, 64), True),
])
def test_kernel_gate(q_shape, k_shape, ok):
    """One gate: the wrappers raise with its message, and the CPU
    dispatch reads it."""
    assert (fa.shape_error(q_shape, k_shape) is None) is ok


def test_cpu_dispatch_inside_and_outside_gate():
    fa.reset_launches()
    q, k, v = _torch(*_arrays(7, 1, 128, 4, 2, 64))
    inside = attention.flash_attention(q, k, v)
    np.testing.assert_array_equal(inside.numpy(),
                                  fa.fwd_plain(q, k, v, True, 0.125)[0])
    q, k, v = _torch(*_arrays(8, 1, 96, 4, 2, 16))
    outside = attention.flash_attention(q, k, v)
    np.testing.assert_array_equal(
        outside.numpy(), attention.mha_reference(q, k, v).numpy())
    # the CPU path never counts a kernel launch
    assert fa.LAUNCHES == {"fwd": 0, "dq": 0, "dkv": 0}


def test_plain_backward_matches_reference_autograd():
    """dq_plain and dkv_plain, given the forward's lse and delta, are the
    gradient of mha_reference (the equations, not just the kernels)."""
    q, k, v = _torch(*_arrays(9, 2, 64, 4, 2, 32))
    do = torch.from_numpy(
        np.random.default_rng(10).standard_normal(q.shape).astype(
            np.float32))
    scale = 32 ** -0.5
    o, lse = fa.fwd_plain(q, k, v, True, scale)
    delta = fa.attention_delta(o, do)
    args = (q, k, v, do, lse, delta, True, scale)
    dq = fa.dq_plain(*args)
    dk, dv = fa.dkv_plain(*args)
    refs = [x.clone().requires_grad_() for x in (q, k, v)]
    attention.mha_reference(*refs, causal=True).backward(do)
    for got, ref in zip((dq, dk, dv), refs):
        np.testing.assert_allclose(got.numpy(), ref.grad.numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_rule_rejects_planted_faults(causal):
    """The rule that holds each kernel to its plain version on the card
    (``chip_smoke.closeness``) passes another sound rounding of the same
    attention -- mha_reference and its autograd, which keep P and dS in
    fp32 -- and rejects each planted fault, here in bf16 on the CPU."""
    rng = np.random.default_rng(11)
    b, s, h, kvh, d = 1, 256, 8, 2, 64
    q, do = (torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32)).bfloat16() for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, s, kvh, d)).astype(
        np.float32)).bfloat16() for _ in range(2))
    scale = d ** -0.5
    o, lse = fa.fwd_plain(q, k, v, causal, scale)
    delta = fa.attention_delta(o, do)
    args = (q, k, v, do, lse, delta, causal, scale)
    dk, dv = fa.dkv_plain(*args)
    plain = {"o": o, "lse": lse, "dq": fa.dq_plain(*args), "dk": dk,
             "dv": dv}

    refs = [x.clone().requires_grad_() for x in (q, k, v)]
    o_ref, lse_ref = attention.mha_reference(
        *refs, causal=causal, scale=scale, return_lse=True)
    o_ref.backward(do)
    sound = {"o": o_ref, "lse": lse_ref, "dq": refs[0].grad,
             "dk": refs[1].grad, "dv": refs[2].grad}
    for label, got in sound.items():
        reading = closeness(label, got, plain[label])
        assert reading["ok"], (label, reading)

    faults = planted_faults(*args)
    assert sum(len(f) for f in faults.values()) == 8
    for name, items in faults.items():
        for fault, label, bad in items:
            reading = closeness(label, bad, plain[label])
            assert not reading["ok"], (name, fault, label, reading)
