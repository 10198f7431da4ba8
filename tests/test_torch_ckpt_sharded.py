"""The flash checkpoint of a sharded strategy, on the CPU: an ``fsdp``
step that two gloo ranks saved holds, in the JAX parameter tree's
coordinates (stacked layers, ``[in, out]`` matrices), two domains per
layer of every sharded leaf, each owned by the one rank that holds it,
and one domain with both ranks as replicas for every norm; it restores
bitwise into fresh ranks on the same mesh (the next step's loss equal to
the bit), whole into one rank, and the JAX loader reads it. A JAX
``fsdp`` state two virtual JAX processes saved is read by the port.
Cases of test_torch_ckpt_world.py's style; the two ranks are
test_torch_strategies.py's, which run this module's job after their
cases."""

import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.parallel import sharding as jax_shd
from dlrover_tpu.trainer.checkpoint import (
    FlashCheckpointer as JaxFlashCheckpointer,
)
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.trainer import ckpt_store
from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer
from dlrover_tpu_torch.trainer.sharded import adamw, make_trainer_for_llama

from tests.test_torch_strategies import rank_groups

STEP = 2

#: run by test_torch_strategies.py's two gloo ranks after their cases,
#: in their process group (``env``), from their work directory
_JOB = textwrap.dedent("""
    def ckpt_job(work, rank):
        from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer
        from dlrover_tpu_torch.trainer.ckpt_store import state_checksums
        cfg = llama.llama_tiny()
        data = np.load(f"{work}/ckpt_batches.npz")

        def trainer(seed):
            t = make_trainer_for_llama(
                cfg, device="cpu", strategy="fsdp",
                mesh=create_mesh([("fsdp", 2)], device="cpu"),
                optimizer=adamw(1e-3, b1=0.9, b2=0.95))
            t.init(seed=seed)
            return t

        def step(t, i):
            batch = t.split_batch((data["tokens"][i], data["targets"][i]))
            return t.train_step(t.shard_batch(t.microbatch(batch))).item()

        def ckpt():
            return FlashCheckpointer(f"{work}/store",
                                     ram_dir=f"{work}/ram{rank}",
                                     persist_interval=STEP,
                                     commit_timeout=20)

        first, saver = trainer(0), ckpt()
        for i in range(STEP):
            step(first, i)
        state = {**first.train_state(), "step": STEP, "data": ""}
        saved = state_checksums(state)
        saver.save(STEP, state)
        saver.close()  # persisted, and committed by rank 0
        dist.barrier()
        gathered = {n: p.clone() for n, p in first.gathered_params().items()}
        next_loss = step(first, STEP)
        # fresh ranks: another seed's weights, the same mesh
        fresh, reader = trainer(1), ckpt()
        got, at = reader.restore(
            target={**fresh.train_state(), "step": 0, "data": ""})
        fresh.load_train_state(got)
        torch.save({"saved": saved, "at": at,
                    "tier": reader.last_restore_stats,
                    "restored": state_checksums(
                        {**fresh.train_state(), "step": at, "data": ""}),
                    "gathered": gathered, "next_loss": next_loss,
                    "fresh_next_loss": step(fresh, STEP)},
                   f"{work}/ckpt_rank{rank}.pt")
        reader.close()

    ckpt_job(work, env.rank)
""").replace("STEP", str(STEP))


def rank_job(work) -> str:
    """The ranks' code of this module's fsdp save and restore, its
    batches written to ``work``."""
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 256, (STEP + 1, 4, 33))
    np.savez(work / "ckpt_batches.npz", tokens=tokens[:, :, :-1],
             targets=tokens[:, :, 1:])
    return _JOB


@pytest.fixture(scope="module")
def rank_procs(tmp_path_factory):
    """The two ranks, started. The module's first test, which needs no
    ranks, runs while they do."""
    rank_groups(tmp_path_factory, wait=False)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """(work dir, [rank 0's, rank 1's results])."""
    work = rank_groups(tmp_path_factory)["dirs"][2]
    return work, [torch.load(work / f"ckpt_rank{r}.pt") for r in range(2)]


@pytest.mark.usefixtures("rank_procs")
def test_jax_fsdp_state_of_two_virtual_processes_read_by_port(tmp_path):
    """The JAX llama_tiny parameters and AdamW moments laid out under
    fsdp_rules on two devices, saved by two virtual JAX processes (one
    device each), restore whole into the port's fsdp trainer at one
    rank."""
    jcfg = jax_llama.llama_tiny()
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("fsdp",))
    shardings = jax_shd.tree_shardings(jax_llama.param_axes(jcfg), mesh,
                                       jax_shd.fsdp_rules())
    params = jax_llama.init_params(jax.random.key(3), jcfg)
    rng = np.random.default_rng(3)

    def moment(p):
        return rng.standard_normal(p.shape).astype(np.float32).astype(
            p.dtype)

    put = lambda tree: jax.tree.map(jax.device_put, tree, shardings)  # noqa
    host = {"model": jax.tree.map(np.asarray, params),
            "mu": jax.tree.map(moment, params),
            "nu": jax.tree.map(lambda p: np.abs(moment(p)), params)}
    state = {"model": put(host["model"]),
             "optimizer": {"mu": put(host["mu"]), "nu": put(host["nu"]),
                           "count": 3},
             "step": 9, "data": ""}
    savers = [JaxFlashCheckpointer(
        str(tmp_path / "store"), ram_dir=str(tmp_path / f"jram{p}"),
        persist_interval=1, use_orbax=False, process_index=p,
        n_processes=2, proc_of_device=lambda d: d.id,
        commit_timeout=30) for p in range(2)]
    for c in savers:
        c.save(9, state, force_persist=True)
    for c in savers:
        c.close()
    trainer = _one_rank(tmp_path)
    r = FlashCheckpointer(str(tmp_path / "store"),
                          ram_dir=str(tmp_path / "port-ram"))
    got, step = r.restore(
        target={**trainer.train_state(), "step": 0, "data": ""})
    r.close()
    assert step == 9 and got["optimizer"]["count"] == 3
    trainer.load_train_state(got)
    cfg = llama.llama_tiny()
    want = llama.params_from_jax(host["model"], cfg, device="cpu")
    for name, p in trainer.gathered_params().items():
        assert torch.equal(p, dict(want.named_parameters())[name]), name
    mu = llama.params_from_jax(host["mu"], cfg, device="cpu")
    got_mu = dict(zip((n for n, _ in trainer._named_trained()),
                      trainer._moments()[0]))
    for name, m in got_mu.items():
        assert torch.equal(m, dict(mu.named_parameters())[name]), name


def _leaves(man):
    return {"/".join(str(c["k"]) for c in e["path"]): e
            for e in man["leaves"]}


def test_domain_map_has_a_domain_per_rank_box(two_ranks):
    work, _ = two_ranks
    store = ckpt_store.get_store(str(work / "store"))
    assert ckpt_store.committed_steps(store) == [STEP]
    leaves = _leaves(ckpt_store.step_manifest(store, STEP))
    cfg = llama.llama_tiny()
    for tree in ("model", "optimizer/mu", "optimizer/nu"):
        embed = leaves[f"{tree}/embed"]
        assert embed["shape"] == [cfg.vocab_size, cfg.hidden_size]
        # fsdp's first axis of (vocab, embed) is vocab: rows split
        assert [(d["idx"], d["replicas"], d["owner"])
                for d in embed["domains"]] == [
            ([[0, 128], [0, 64]], [0], 0), ([[128, 256], [0, 64]], [1], 1)]
        wq = leaves[f"{tree}/blocks/wq"]
        assert wq["shape"] == [cfg.num_layers, cfg.hidden_size, 64]
        # (embed, heads): the embed dim, JAX's dim 1, the port's dim 1
        assert sorted((d["idx"][0][0], d["idx"][1], d["replicas"])
                      for d in wq["domains"]) == [
            (layer, half, [r]) for layer in range(cfg.num_layers)
            for r, half in enumerate(([0, 32], [32, 64]))]
        norm = leaves[f"{tree}/blocks/attn_norm"]
        assert len(norm["domains"]) == cfg.num_layers
        assert all(d["replicas"] == [0, 1] and d["owner"] in (0, 1)
                   for d in norm["domains"])
        assert leaves[f"{tree}/lm_head"]["shape"] == [64, cfg.vocab_size]
    assert leaves["optimizer/count"]["v"] == STEP


def test_restores_bitwise_into_fresh_ranks(two_ranks):
    _, ranks = two_ranks
    for r in ranks:
        assert r["at"] == STEP and r["restored"] == r["saved"]
        assert r["tier"]["tier"] == "ram"
        assert r["fresh_next_loss"] == r["next_loss"]
    # each rank saved its own shards
    assert ranks[0]["saved"] != ranks[1]["saved"]


def _one_rank(tmp_path):
    trainer = make_trainer_for_llama(llama.llama_tiny(), device="cpu",
                                     strategy="fsdp",
                                     optimizer=adamw(1e-3, b1=0.9, b2=0.95))
    trainer.init(seed=5)
    return trainer


def test_two_rank_step_restores_whole_into_one_rank(two_ranks, tmp_path):
    work, ranks = two_ranks
    trainer = _one_rank(tmp_path)
    solo = FlashCheckpointer(str(work / "store"),
                             ram_dir=str(tmp_path / "ram-solo"))
    got, step = solo.restore(
        target={**trainer.train_state(), "step": 0, "data": ""})
    solo.close()
    assert step == STEP and solo.last_restore_stats["tier"] == "persistent"
    trainer.load_train_state(got)
    for name, p in trainer.gathered_params().items():
        assert torch.equal(p, ranks[0]["gathered"][name]), name


def test_two_rank_step_read_by_jax(two_ranks, tmp_path):
    work, ranks = two_ranks
    r = JaxFlashCheckpointer(str(work / "store"),
                             ram_dir=str(tmp_path / "jax-ram"),
                             persist_interval=0, use_orbax=False,
                             process_index=0, n_processes=1)
    got, step = r.restore()
    r.close()
    assert step == STEP and got["optimizer"]["count"] == STEP
    cfg = llama.llama_tiny()
    for name, p in ranks[0]["gathered"].items():
        leaf = llama.jax_coordinates(cfg, name)
        arr = got["model"]
        for k in leaf.path:
            arr = arr[k]
        arr = np.asarray(arr)
        assert str(arr.dtype) == ckpt_store.dtype_name(p.dtype)
        box = arr[tuple(slice(a, b) for a, b in leaf.index(
            [[0, n] for n in p.shape]))]
        want = leaf.to_jax(p).contiguous()
        assert box.tobytes() == want.view(torch.int16 if p.element_size()
                                          == 2 else torch.int32
                                          ).numpy().tobytes(), name
