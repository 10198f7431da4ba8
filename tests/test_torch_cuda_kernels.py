"""The port's CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no interpret mode, so these tests are marked
``gpu`` and skip on a machine without one; run them on a GPU with
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m gpu``
(the repo's conftest imports JAX, which a GPU machine need not have).

Tolerance: both sides in bf16 on the card, held by ``chip_smoke.closeness``:
every element within ATOL x rms(plain) + RTOL x |plain| (RTOL two bf16
steps) and the whole within NORM_TOL x ||plain||; lse (fp32) within
LSE_TOL per element.
"""

import pytest
import torch

from chip_smoke import closeness
from dlrover_tpu_torch.ops import attention
from dlrover_tpu_torch.ops.cuda import flash_attention as fa

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, b, s, h, kvh, d, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(
        torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d),
                      (b, s, h, d))
    )


def _assert_close(label, got, want):
    reading = closeness(label, got, want)
    assert reading["ok"], f"{label}: {reading}"


#: (b, s, h, kvh, d): what 128-row tiles, the persistent schedule and
#: the split GQA group can get wrong
SHAPES = {
    "s256-g1-d64": (2, 256, 2, 2, 64),
    "s256-g8-d64": (2, 256, 16, 2, 64),
    "s256-g1-d128": (2, 256, 2, 2, 128),
    "s256-g8-d128": (2, 256, 16, 2, 128),
    "s128-one-tile": (1, 128, 4, 2, 64),
    "s384-odd-tiles": (2, 384, 8, 2, 64),
    "s384-odd-tiles-d128": (1, 384, 8, 2, 128),
    "b3-kvh4-g8-s1024": (3, 1024, 32, 4, 64),
    "b3-kvh4-g8-s1024-d128": (3, 1024, 32, 4, 128),
    # GPT-2 XL's attention: 25 heads, group 1, 50 (batch, head) pairs
    "gpt2-xl-h25-g1-s1024": (2, 1024, 25, 25, 64),
}


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
@pytest.mark.parametrize("causal", [True, False])
def test_kernels_match_plain(cuda, causal, shape):
    b, s, h, kvh, d = shape
    q, k, v, do = _inputs(cuda, b, s, h, kvh, d)
    scale = d ** -0.5
    o, lse = fa.fwd(q, k, v, causal, scale)
    o_ref, lse_ref = fa.fwd_plain(q, k, v, causal, scale)
    _assert_close("o", o, o_ref)
    _assert_close("lse", lse, lse_ref)
    delta = fa.attention_delta(o, do)
    args = (q, k, v, do, lse, delta, causal, scale)
    _assert_close("dq", fa.dq(*args), fa.dq_plain(*args))
    for label, got, want in zip(("dk", "dv"), fa.dkv(*args),
                                fa.dkv_plain(*args)):
        _assert_close(label, got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_two_launches_are_bitwise_equal(cuda, causal):
    """The forward, dQ and dK/dV kernels (the latter's group parts summed
    in a fixed order) give the same bits on every launch."""
    q, k, v, do = _inputs(cuda, 3, 1024, 32, 4, 64)
    scale = 0.125
    o, lse = fa.fwd(q, k, v, causal, scale)
    o2, lse2 = fa.fwd(q, k, v, causal, scale)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    args = (q, k, v, do, lse, fa.attention_delta(o, do), causal, scale)
    assert torch.equal(fa.dq(*args), fa.dq(*args))
    dk, dv = fa.dkv(*args)
    dk2, dv2 = fa.dkv(*args)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_autograd_counts_one_launch_per_kernel(cuda):
    q, k, v, do = _inputs(cuda, 1, 128, 4, 2, 64)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    fa.reset_launches()
    attention.flash_attention(q, k, v).backward(do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"fwd": 1, "dq": 1, "dkv": 1}


def test_cuda_inputs_the_kernels_do_not_take_raise(cuda):
    q, k, v, _ = _inputs(cuda, 1, 128, 4, 2, 64)
    with pytest.raises(ValueError):
        fa.fwd(q.float(), k.float(), v.float(), True, 0.125)
    with pytest.raises(ValueError):
        fa.fwd(q[:, :, :, :32].contiguous(), k[..., :32].contiguous(),
               v[..., :32].contiguous(), True, 0.125)
    short_q, short_k, short_v, _ = _inputs(cuda, 1, 200, 4, 2, 64)
    with pytest.raises(ValueError):
        attention.flash_attention(short_q, short_k, short_v)
    with pytest.raises(ValueError, match="scale"):
        fa.fwd(q, k, v, True, -0.125)
