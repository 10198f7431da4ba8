"""The step profile and the device-memory probe on the card: profiling
the step leaves the training state, the generators and the flash
kernels' launch counts bitwise as they were, and counts a floor of the
step's FLOPs, since the counter cannot see the hand-written kernels; the
probe reads the caching allocator's own counters. Marked ``gpu``: it
skips on a machine without one; run it on a GPU with ``python -m pytest
--noconftest tests/test_torch_*gpu*.py -m gpu`` (the repo's conftest
imports JAX, which a GPU machine need not have)."""

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.agent.monitor import resource
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.ops.cuda import flash_attention as fa
from dlrover_tpu_torch.trainer import profiler
from dlrover_tpu_torch.trainer.sharded import adamw, make_trainer_for_llama

pytestmark = pytest.mark.gpu

B, S = 2, 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step runs the flash kernels "
                    "on the card")
    return torch.device("cuda")


def _trainer(seed: int = 0):
    # head_dim 64 and a sequence of 256: the shapes the kernels take
    cfg = llama.llama_tiny(hidden_size=128, num_heads=2, num_kv_heads=1,
                           max_seq_len=S, remat="dots_attn_out")
    trainer = make_trainer_for_llama(cfg, device="cuda",
                                     optimizer=adamw(1e-3))
    trainer.init(seed=seed)
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int64)
    return cfg, trainer, trainer.shard_batch(
        trainer.microbatch((tokens, tokens)))


def _state(trainer):
    st = trainer.train_state()
    flat = {f"model/{k}": v for k, v in st["model"].items()}
    flat.update({f"mu/{k}": v for k, v in st["optimizer"]["mu"].items()})
    flat.update({f"nu/{k}": v for k, v in st["optimizer"]["nu"].items()})
    return ({k: v.detach().clone() for k, v in flat.items()},
            st["optimizer"]["count"])


def test_profile_on_the_card_leaves_the_state_bitwise(cuda):
    cfg, trainer, batch = _trainer()
    _, twin, _ = _trainer()
    fa.reset_launches()
    for t in (trainer, twin):
        t.train_step(batch)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    assert launches == {k: 2 * cfg.num_layers for k in launches}
    before, count = _state(trainer)
    rng_cpu = torch.get_rng_state()
    rng_cuda = torch.cuda.get_rng_state()
    prof = profiler.profile_step(trainer.forward_backward, batch,
                                 params=trainer.model)
    assert prof.peak_memory_bytes == torch.cuda.max_memory_allocated()
    after, count_after = _state(trainer)
    assert before.keys() == after.keys() and all(
        torch.equal(before[k], after[k]) for k in before)
    assert count_after == count == 1
    assert fa.LAUNCHES == launches
    assert torch.equal(torch.get_rng_state(), rng_cpu)
    assert torch.equal(torch.cuda.get_rng_state(), rng_cuda)
    assert all(p.grad is None for p in trainer.model.parameters())
    # the next step of both trainers is bitwise the same
    assert torch.equal(trainer.train_step(batch), twin.train_step(batch))
    assert all(torch.equal(a, b) for a, b in zip(
        _state(trainer)[0].values(), _state(twin)[0].values()))
    # a floor: the matmuls outside attention, three times over (the
    # kernels' own FLOPs are invisible to the counter)
    h, m, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    linear = cfg.num_layers * 2 * B * S * (
        h * nh * hd + 2 * h * nkv * hd + nh * hd * h + 3 * h * m)
    assert prof.device == "cuda"
    assert prof.flops == 3 * (linear + 2 * B * S * h * v)


def test_the_device_probe_equals_torch_cuda(cuda):
    x = torch.empty(1 << 22, device=cuda)
    torch.cuda.synchronize()
    s = resource.get_device_stats()
    assert [d["device"] for d in s] == [
        f"cuda:{i}" for i in range(torch.cuda.device_count())]
    assert s[0]["bytes_in_use"] == torch.cuda.memory_allocated(0)
    assert s[0]["peak_bytes_in_use"] == torch.cuda.max_memory_allocated(0)
    assert s[0]["bytes_limit"] == (
        torch.cuda.get_device_properties(0).total_memory)
    del x
