"""The other model families on the card: a narrow GPT through the flash
kernels against the same model through ``mha_reference``, and a DLRM
step on the card against the CPU. Marked ``gpu``; run them on a GPU
with ``python -m pytest --noconftest tests/test_torch_families_gpu.py
-m gpu`` (the repo's conftest imports JAX).

Tolerances: the GPT's loss and gradients in bf16 within 5e-2 relative
(the norm of the difference over the norm of the reference's, per
tensor; ``tests/test_flash_attention.py``'s bf16 bound; the k bias,
whose exact gradient is 0, against the largest gradient); DLRM in fp32
within 1e-5 relative (the devices sum in other orders, which moved the
loss by about 1e-7 on an H100).
"""

import copy

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.models import dlrm, gpt, make_trainer_for
from dlrover_tpu_torch.ops.attention import mha_reference
from dlrover_tpu_torch.ops.cuda import flash_attention as fa

pytestmark = pytest.mark.gpu

BF16_TOL = 5e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _loss_and_grads(model, batch, attn_fn=None):
    model.zero_grad(set_to_none=True)
    loss = gpt.next_token_loss(model, batch, attn_fn=attn_fn)
    loss.backward()
    return loss.item(), {n: p.grad.float().clone()
                         for n, p in model.named_parameters()}


def test_narrow_gpt_through_the_kernels(cuda):
    """Two layers of head_dim 64 over 3 heads (group 1), seq 256: each
    kernel launches twice (once per layer) in one step, and the loss
    and gradients equal those through mha_reference."""
    cfg = gpt.GPTConfig(vocab_size=512, hidden_size=192,
                        intermediate_size=768, num_layers=2, num_heads=3,
                        max_seq_len=256, remat="dots_attn_out")
    model = gpt.init_params(cfg, seed=0, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 256))).to(cuda)
    fa.reset_launches()
    loss, grads = _loss_and_grads(model, (tokens, tokens))
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"fwd": 2, "dq": 2, "dkv": 2}
    ref_loss, ref_grads = _loss_and_grads(model, (tokens, tokens),
                                          attn_fn=mha_reference)
    assert loss == pytest.approx(ref_loss, rel=BF16_TOL)
    scale = max(g.abs().max().item() for g in ref_grads.values())
    for n, g in ref_grads.items():
        if n.endswith(".wk.bias"):
            # no gradient in exact arithmetic (a shift of every key moves
            # a query's scores alike): rounding noise on both sides
            assert max(grads[n].abs().max().item(),
                       g.abs().max().item()) <= BF16_TOL * scale, n
            continue
        assert ((grads[n] - g).norm() / g.norm()).item() <= BF16_TOL, n


def test_dlrm_step_matches_the_cpu(cuda):
    cfg = dlrm.criteo_wide_deep()
    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((1, 512, cfg.dense_dim), dtype=np.float32),
             np.stack([rng.integers(0, v, (1, 512)) for v in cfg.vocab_sizes],
                      -1).astype(np.int32),
             rng.integers(0, 2, (1, 512)).astype(np.int32))
    init = dlrm.init_params(cfg, seed=0, device="cpu")
    losses = {}
    for device in ("cpu", cuda):
        trainer = make_trainer_for(cfg, device=device)
        trainer.init(model=copy.deepcopy(init))
        mb = trainer.shard_batch(batch)
        losses[str(device)] = [trainer.train_step(mb).item()
                               for _ in range(3)]
    assert losses["cuda"] == pytest.approx(losses["cpu"], rel=1e-5)
