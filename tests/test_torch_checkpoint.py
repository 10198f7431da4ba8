"""The port's checkpoint archive and FlashCheckpointer on the CPU, against
the JAX package's: the same archive format (manifest, digests, bf16 as
raw bytes), archives read across packages bitwise in both directions,
and the save pipeline's contract -- a save never sees a later in-place
update, restore prefers the RAM tier, refuses a corrupted member by its
digest and walks down to an older step, and raises when nothing can be
restored."""

import io
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.trainer import ckpt_store as jax_store
from dlrover_tpu.trainer.checkpoint import (
    FlashCheckpointer as JaxFlashCheckpointer,
)
from dlrover_tpu.trainer.checkpoint import _local_shards, _restore_shards
from dlrover_tpu_torch import telemetry as T
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.trainer import ckpt_store
from dlrover_tpu_torch.trainer.checkpoint import (
    ENV_QUEUE_DEPTH,
    ENV_STAGE,
    FlashCheckpointer,
    RestoreError,
)
from dlrover_tpu_torch.trainer.sharded import adamw, make_trainer_for_llama

TOPOLOGY = {"n_processes": 1, "process_index": 0}


@pytest.fixture(autouse=True)
def fresh_telemetry():
    T.set_default_registry(None)
    T.set_default_journal(T.EventJournal(None))
    yield
    T.set_default_registry(None)
    T.set_default_journal(T.EventJournal(None))


def _ckpt(tmp_path, **kw):
    return FlashCheckpointer(str(tmp_path / "persist"),
                             ram_dir=str(tmp_path / "ram"), **kw)


def _members(data: bytes) -> dict:
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def _trees(seed=0):
    """The same values as a JAX tree and as a port tree."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    b = rng.standard_normal((3,)).astype(np.float32)
    jt = {"a": {"w": jnp.asarray(w, jnp.bfloat16), "n": jnp.asarray(b)},
          "b": [jnp.asarray(w[:2, :2]), jnp.asarray(7, jnp.int32)],
          "step": 5, "data": "{}"}
    pt = {"a": {"w": torch.from_numpy(w).to(torch.bfloat16),
                "n": torch.from_numpy(b)},
          "b": [torch.from_numpy(w[:2, :2].copy()),
                torch.tensor(7, dtype=torch.int32)],
          "step": 5, "data": "{}"}
    return jt, pt


@pytest.mark.parametrize("sink", ["memory", "file"])
def test_archive_matches_the_jax_writer(sink, tmp_path):
    """In memory the members are written one after another; to a real
    file, by threads at their precomputed offsets."""
    jt, pt = _trees()
    jbuf = io.BytesIO()
    jax_store.snapshot_to_file(_local_shards(jt), 3, jbuf, topology=TOPOLOGY)
    if sink == "memory":
        pbuf = io.BytesIO()
        ckpt_store.snapshot_to_file(pt, 3, pbuf, topology=TOPOLOGY)
        data = pbuf.getvalue()
    else:
        with open(tmp_path / "a.ckpt", "w+b") as f:
            ckpt_store.snapshot_to_file(pt, 3, f, topology=TOPOLOGY)
        data = (tmp_path / "a.ckpt").read_bytes()
    want, got = _members(jbuf.getvalue()), _members(data)
    assert json.loads(got.pop("manifest.json")) == json.loads(
        want.pop("manifest.json"))
    assert got == want  # every member's bytes, bf16 ones included


def test_bf16_is_raw_bytes_with_an_encoding():
    _, pt = _trees()
    buf = io.BytesIO()
    ckpt_store.snapshot_to_file(pt, 1, buf)
    man = ckpt_store.read_manifest(buf)
    entry = next(e for e in man["leaves"] if e.get("dtype") == "bfloat16")
    name = entry["shards"][0]["a"]
    assert man["encodings"][name] == {"dtype": "bfloat16", "shape": [4, 8]}
    assert set(man["digests"]) == {f"a{i}.npy" for i in range(4)}
    assert man["version"] == 2


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _tiny_state(seed=0, steps=1):
    cfg = llama.llama_tiny()
    trainer = make_trainer_for_llama(cfg, device="cpu",
                                     optimizer=adamw(1e-3))
    trainer.init(seed=seed)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
        trainer.train_step(trainer.shard_batch(trainer.microbatch(
            (tokens, tokens))))
    return trainer, {**trainer.train_state(), "step": steps, "data": "x"}


def test_port_archive_reads_back_bitwise_in_jax(tmp_path):
    _, state = _tiny_state()
    ckpt = _ckpt(tmp_path, persist_interval=0)
    ckpt.save(1, state)
    ckpt.close()
    with open(ckpt._ram_path(1), "rb") as f:
        snap, step = jax_store.snapshot_from_file(f)
    host = _restore_shards(snap)
    assert step == 1 and host["step"] == 1 and host["data"] == "x"
    flat = ckpt_store.flatten_with_path(state)
    assert len(flat) > 20
    for path, leaf in flat:
        node = host
        for c in path:
            node = node[c.get("k", c.get("i"))]
        if isinstance(leaf, torch.Tensor):
            assert str(np.asarray(node).dtype) == ckpt_store.dtype_name(
                leaf.dtype)
            np.testing.assert_array_equal(_bits(node), _bits(leaf))
    bf16 = [leaf for _, leaf in flat if isinstance(leaf, torch.Tensor)
            and leaf.dtype == torch.bfloat16]
    assert bf16


def test_jax_flash_checkpoint_restores_the_same_model(tmp_path):
    jcfg = jax_llama.llama_tiny()
    params = jax_llama.init_params(jax.random.key(3), jcfg)
    jckpt = JaxFlashCheckpointer(str(tmp_path / "jp"),
                                 ram_dir=str(tmp_path / "jr"),
                                 use_orbax=False, persist_interval=0)
    jckpt.save(2, {"params": params, "step": jnp.asarray(2)})
    jckpt.close()
    with open(jckpt._ram_path(2), "rb") as f:
        tree, step = ckpt_store.snapshot_from_file(f)
    assert step == 2 and int(tree["step"]) == 2
    cfg = llama.llama_tiny()
    got = llama.params_from_jax(tree["params"], cfg, device="cpu")
    want = llama.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu")
    gs, ws = got.state_dict(), want.state_dict()
    assert gs.keys() == ws.keys()
    assert any(t.dtype == torch.bfloat16 for t in ws.values())
    for k in ws:
        assert gs[k].dtype == ws[k].dtype
        np.testing.assert_array_equal(_bits(gs[k]), _bits(ws[k]), k)


def test_save_never_sees_a_later_in_place_update(tmp_path):
    trainer, state = _tiny_state()
    before = {k: v.clone() for k, v in state["model"].items()}
    ckpt = _ckpt(tmp_path, persist_interval=0)
    ckpt.save(1, state)
    ckpt.wait_staged()
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.add_(1.0)
    ckpt.wait()
    restored, _ = ckpt.restore()
    ckpt.close()
    for k, v in before.items():
        assert torch.equal(restored["model"][k], v), k
        assert not torch.equal(state["model"][k], v)


def test_restored_cpu_tensors_own_their_memory(tmp_path):
    """The reader maps the archive; what it returns on the CPU is copied
    out, so rewriting the file afterwards changes nothing."""
    _, state = _tiny_state()
    for target in (None, {**state, "step": 0, "data": ""}):
        ckpt = _ckpt(tmp_path, persist_interval=0)
        ckpt.save(1, state)
        ckpt.close()
        restored, _ = _ckpt(tmp_path).restore(target=target)
        path = ckpt._ram_path(1)
        with open(path, "r+b") as f:
            f.write(bytes(os.path.getsize(path)))
        for k, v in state["model"].items():
            assert torch.equal(restored["model"][k], v), k


def test_restore_prefers_ram_then_the_persist_tier(tmp_path):
    trainer, state = _tiny_state(steps=2)
    ckpt = _ckpt(tmp_path, persist_interval=1)
    ckpt.save(2, state)
    ckpt.close()
    target = {**trainer.train_state(), "step": 0, "data": ""}
    for tier in ("ram", "persistent"):
        restorer = _ckpt(tmp_path)
        assert restorer.latest_step() == 2
        restored, step = restorer.restore(target=target)
        stats = restorer.last_restore_stats
        assert (step, stats["tier"]) == (2, tier)
        assert stats["seconds"] > 0 and stats["archive_bytes"] > 0
        for (path, got), (_, want) in zip(
                ckpt_store.flatten_with_path(restored),
                ckpt_store.flatten_with_path(state)):
            if isinstance(want, torch.Tensor):
                assert torch.equal(got, want), path
            else:
                assert got == want
        for p in (tmp_path / "ram").iterdir():  # lose the RAM tier
            p.unlink()
    fresh, _ = _tiny_state(seed=9)
    fresh.load_train_state(restored)
    assert fresh.optimizer.state[next(fresh.model.parameters())][
        "step"].item() == 2


def _corrupt(path):
    """Flip one byte inside the first array member's data."""
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo("a0.npy")
    with open(path, "r+b") as f:
        f.seek(info.header_offset + 30 + len(info.filename) + 20 + 140)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))


def test_corrupt_member_refused_and_restore_walks_down(tmp_path):
    _, state = _tiny_state()
    ckpt = _ckpt(tmp_path, persist_interval=1, max_persist_keep=3)
    ckpt.save(1, state)
    ckpt.save(2, state)
    ckpt.close()
    for p in (tmp_path / "ram").iterdir():
        p.unlink()
    newest = tmp_path / "persist" / "step-2" / "proc-0.a0.ckpt"
    _corrupt(newest)
    with open(newest, "rb") as f, pytest.raises(
            ckpt_store.DigestMismatchError):
        ckpt_store.snapshot_from_file(f)
    restorer = _ckpt(tmp_path)
    _, step = restorer.restore()
    assert step == 1
    events = T.default_journal().events("checkpoint.restore_fallback")
    assert [e["data"]["reason"] for e in events] == ["digest_mismatch"]
    # the JAX reader refuses the same member (by the zip's CRC-32,
    # which it checks before the digest)
    with open(newest, "rb") as f, pytest.raises(jax_store.ArchiveError):
        jax_store.snapshot_from_file(f)


def test_restore_raises_when_no_checkpoint_is_readable(tmp_path):
    _, state = _tiny_state()
    ckpt = _ckpt(tmp_path, persist_interval=1)
    ckpt.save(1, state)
    ckpt.close()
    _corrupt(tmp_path / "ram" / "step-1-proc-0")
    _corrupt(tmp_path / "persist" / "step-1" / "proc-0.a0.ckpt")
    with pytest.raises(RestoreError, match="sha256 mismatch"):
        _ckpt(tmp_path).restore()


def test_restore_refuses_a_target_of_another_shape(tmp_path):
    _, state = _tiny_state()
    ckpt = _ckpt(tmp_path, persist_interval=0)
    ckpt.save(1, state)
    ckpt.close()
    target = {**state, "step": 0, "data": ""}
    name = next(iter(target["model"]))
    target["model"] = {**target["model"],
                       name: torch.zeros(3, dtype=torch.bfloat16)}
    with pytest.raises(RestoreError, match="target"):
        _ckpt(tmp_path).restore(target=target)


def test_no_checkpoint_restores_nothing(tmp_path):
    assert _ckpt(tmp_path).restore() == (None, None)
    assert _ckpt(tmp_path).latest_step() is None


def test_ram_tier_gc_and_persist_cadence(tmp_path):
    _, state = _tiny_state()
    ckpt = _ckpt(tmp_path, persist_interval=2, max_ram_keep=2)
    for step in range(1, 6):
        ckpt.save(step, state)
    ckpt.close()
    assert sorted(os.listdir(tmp_path / "ram")) == [
        "step-4-proc-0", "step-5-proc-0"]
    assert ckpt_store.committed_steps(
        ckpt_store.get_store(str(tmp_path / "persist"))) == [2, 4]
    assert set(ckpt.save_stats) == {1, 2, 3, 4, 5}
    assert ckpt.save_stats[4]["persist_s"] > 0
    assert ckpt.save_stats[5]["archive_bytes"] > 0


def test_env_knobs(tmp_path, monkeypatch):
    monkeypatch.setenv(ENV_QUEUE_DEPTH, "5")
    monkeypatch.setenv(ENV_STAGE, "sync")
    ckpt = _ckpt(tmp_path)
    assert ckpt.queue_depth == 5 and ckpt._stage_sync
    monkeypatch.setenv(ENV_STAGE, "lazy")
    with pytest.raises(ValueError, match="async|sync"):
        _ckpt(tmp_path)


def test_bucket_url_is_not_ported():
    with pytest.raises(NotImplementedError, match="GcsStore"):
        ckpt_store.get_store("gs://bucket/prefix")
