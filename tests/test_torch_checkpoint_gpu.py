"""The flash checkpoint on the card: device-to-host copies on a side
stream into reused pinned buffers, ordered before the next in-place
update, and restores streamed to the card through a pinned ring.
Marked ``gpu``: they skip on a machine without one; run them on a GPU
with ``python -m pytest --noconftest tests/test_torch_*gpu*.py -m gpu``
(the repo's conftest imports JAX, which a GPU machine need not have)."""

import zipfile

import pytest
import torch

from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.trainer import ckpt_store
from dlrover_tpu_torch.trainer.checkpoint import (
    FlashCheckpointer,
    RestoreError,
)
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from dlrover_tpu_torch.trainer.sharded import adamw, make_trainer_for_llama

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: staging copies run on the card")
    return torch.device("cuda")


def _ckpt(tmp_path, **kw):
    return FlashCheckpointer(str(tmp_path / "persist"),
                             ram_dir=str(tmp_path / "ram"), **kw)


def _archive(ckpt, step):
    with open(ckpt._ram_path(step), "rb") as f:
        tree, got = ckpt_store.snapshot_from_file(f)
    assert got == step
    return tree


def _big_state(device):
    """About 600 MB in bf16 and fp32, so that the copies take longer than
    launching the in-place updates behind them."""
    gen = torch.Generator(device=device).manual_seed(0)
    return {
        "w": [torch.randn(4096, 8192, generator=gen, device=device).to(
            torch.bfloat16) for _ in range(8)],
        "m": torch.randn(4096, 8192, generator=gen, device=device),
        "count": 3,
    }


def test_save_never_sees_the_next_in_place_update(cuda, tmp_path):
    ckpt = _ckpt(tmp_path, persist_interval=0, max_ram_keep=1)
    state = _big_state(cuda)
    tensors = state["w"] + [state["m"]]
    for step in range(1, 11):
        before = [t.clone() for t in tensors]
        ckpt.save(step, state)
        ckpt.wait_staged()
        for t in tensors:  # the next update, in place, right away
            t.mul_(-1.0).add_(1.0)
        ckpt.wait()
        tree = _archive(ckpt, step)
        got = tree["w"]
        for i, want in enumerate(before[:-1]):
            assert torch.equal(got[i], want.cpu()), (step, i)
        assert torch.equal(tree["m"], before[-1].cpu()), step
        assert tree["count"] == 3
    ckpt.close()


def _cfg():
    """llama_tiny with the kernels' head_dim (64)."""
    return llama.llama_tiny(hidden_size=128, num_heads=2, num_kv_heads=1)


def test_elastic_step_waits_for_the_copies(cuda, tmp_path):
    """The trainer path: a save at every step, the next step's AdamW
    writes in place; every archive holds the state the save was given."""
    cfg = _cfg()
    trainer = make_trainer_for_llama(cfg, device=cuda, optimizer=adamw(1e-3))
    trainer.init(seed=0)
    elastic = ElasticTrainer(trainer, max_nodes=1, cur_nodes=1)
    ckpt = _ckpt(tmp_path, persist_interval=0, max_ram_keep=20)
    elastic.attach_checkpointer(ckpt, save_interval=1)
    gen = torch.Generator().manual_seed(0)
    saved = {}
    for step in range(1, 11):
        tokens = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen)
        batch = trainer.shard_batch(elastic.microbatch((tokens, tokens)))
        elastic.report_step(step, loss=elastic.train_step(batch))
        state = trainer.train_state()
        saved[step] = {k: t.detach().cpu().clone()
                       for k, t in state["model"].items()}
        elastic.maybe_checkpoint(state)
    ckpt.wait()
    for step, want in saved.items():
        got = _archive(ckpt, step)["model"]
        assert all(torch.equal(got[k], want[k]) for k in want), step
    ckpt.close()


def test_pinned_buffers_are_reused(cuda, tmp_path):
    ckpt = _ckpt(tmp_path, persist_interval=0)
    state = {"a": torch.ones(1 << 20, device=cuda),
             "b": torch.zeros(333, dtype=torch.bfloat16, device=cuda)}
    ckpt.save(1, state)
    assert ckpt.pinned_allocations == 1  # at the layout's first save
    views = [v.data_ptr() for v in ckpt._pool._sets[
        next(iter(ckpt._pool._sets))].views]
    for step in range(2, 6):
        ckpt.wait_staged()
        state["a"].add_(1)
        ckpt.save(step, state)  # waits while step - 1's archive is written
    ckpt.wait()
    assert ckpt.pinned_allocations == 1
    assert [v.data_ptr() for v in ckpt._pool._sets[
        next(iter(ckpt._pool._sets))].views] == views
    assert _archive(ckpt, 5)["a"][0].item() == 5.0
    # a prepared layout is allocated before its first save
    other = {"c": torch.ones(7, 5, device=cuda)}
    ckpt.prepare(other)
    ckpt.save(6, other)
    assert ckpt.pinned_allocations == 2
    ckpt.close()


def test_restore_puts_every_tensor_on_the_trainers_device(cuda, tmp_path):
    cfg = _cfg()
    trainer = make_trainer_for_llama(cfg, device=cuda, optimizer=adamw(1e-3))
    trainer.init(seed=0)
    ckpt = _ckpt(tmp_path, persist_interval=1)
    ckpt.save(1, {**trainer.train_state(), "step": 1})
    ckpt.close()
    for tier_dir in ("ram", None):
        if tier_dir is not None:
            restorer = _ckpt(tmp_path)
        else:  # the persist tier alone
            for p in (tmp_path / "ram").iterdir():
                p.unlink()
            restorer = _ckpt(tmp_path)
        tree, step = restorer.restore(
            target={**trainer.train_state(), "step": 0})
        assert step == 1
        leaves = [leaf for _, leaf in ckpt_store.flatten_with_path(tree)
                  if isinstance(leaf, torch.Tensor)]
        assert leaves and all(t.device.type == "cuda" for t in leaves)
        assert restorer.last_restore_stats["tier"] == (
            "ram" if tier_dir else "persistent")


def test_restore_streams_members_to_the_card(cuda, tmp_path, monkeypatch):
    """Members bound for the card pass through the pinned ring part by
    part (slots of 1 MiB here): bitwise equal, and a flipped byte past
    the first part is refused by the member's digest."""
    monkeypatch.setattr(ckpt_store, "_RING_SLOT", 1 << 20)
    gen = torch.Generator(device=cuda).manual_seed(1)
    state = {"big": torch.randn(3 << 20, generator=gen, device=cuda).to(
                 torch.bfloat16),
             "f": torch.randn(1000, 777, generator=gen, device=cuda),
             "n": 5}
    ckpt = _ckpt(tmp_path, persist_interval=0)
    ckpt.save(1, state)
    ckpt.close()
    target = {"big": torch.zeros_like(state["big"]),
              "f": torch.zeros_like(state["f"]), "n": 0}
    tree, step = _ckpt(tmp_path).restore(target=target)
    assert step == 1 and tree["n"] == 5
    for k in ("big", "f"):
        assert tree[k].is_cuda and torch.equal(tree[k], state[k]), k
    path = ckpt._ram_path(1)
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo("a0.npy")  # "big", the first key
    with open(path, "r+b") as f:
        f.seek(info.header_offset + info.file_size // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(RestoreError, match="sha256 mismatch"):
        _ckpt(tmp_path).restore(target=target)
