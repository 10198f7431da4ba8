"""The "rowwise" strategy above one rank on the CPU: two gloo ranks on the
mesh ``(data 1, fsdp 2)`` each hold half of the DLRM tables' rows.

* The sharded ``vocab_parallel_lookup`` and its table gradient against
  JAX's under ``shard_map`` on two virtual devices, with ids in both
  shards and out of the table: the embeddings and the gradient fp32
  exact. It refuses a batch axis that is the shard axis, as JAX does.
* Three ``adagrad(0.05)`` steps of a small DLRM against the JAX rowwise
  ``ShardedTrainer`` on the same mesh, from the same numpy weights on
  the same global batches (ids out of range, padded rows): the losses
  within 1e-5 relative, the parameters to test_torch_dlrm.py's
  tolerances; each rank keeps half the tables and half their
  accumulators; the rows that only padded examples reference get a zero
  gradient, as tests/test_dlrm.py asserts of JAX.
* The ranks' save of step 3 (the tables and their accumulators split by
  rows over fsdp, in the JAX tree's coordinates) restores bitwise into
  fresh ranks, whole into one rank, and the JAX loader reads it.

The ranks are test_torch_strategies.py's two (``rank_groups``), which
run this module's job after their cases."""

import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from dlrover_tpu.models import dlrm as jax_dlrm
from dlrover_tpu.parallel.embedding import (
    vocab_parallel_lookup as jax_lookup,
)
from dlrover_tpu.trainer import sharded as jax_sharded
from dlrover_tpu.trainer.checkpoint import (
    FlashCheckpointer as JaxFlashCheckpointer,
)
from dlrover_tpu_torch.models import dlrm
from dlrover_tpu_torch.parallel import embedding
from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer

from tests.test_torch_dlrm import (
    SMALL, _as_port_layout, _assert_close, _batch, _np_params,
)
from tests.test_torch_gpt import FAST_COMPILE
from tests.test_torch_strategies import _FastJax, rank_groups

STEPS = 3
LR = 0.05
#: the lookup's table rows, and its ids' range (both ends out of it)
ROWS, IDS = 40, (-3, 46)

#: run by test_torch_strategies.py's two gloo ranks after their cases,
#: in their process group (``env``), from their work directory
_JOB = textwrap.dedent("""
    def rowwise_job(work, rank):
        import torch.nn as nn
        from dlrover_tpu_torch.models import dlrm
        from dlrover_tpu_torch.parallel.embedding import (
            vocab_parallel_lookup)
        from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer
        from dlrover_tpu_torch.trainer.ckpt_store import state_checksums
        d = np.load(f"{work}/rowwise.npz")
        mesh = create_mesh([("data", 1), ("fsdp", 2)], device="cpu")
        out = {}
        half = d["table"].shape[0] // 2
        t = nn.Parameter(torch.from_numpy(
            d["table"][rank * half:(rank + 1) * half].copy()))
        ids = torch.from_numpy(d["ids"])
        emb = vocab_parallel_lookup(t, ids, mesh)
        emb.backward(torch.from_numpy(d["upstream"]))
        out["lookup"], out["lookup_grad"] = emb.detach(), t.grad
        try:
            vocab_parallel_lookup(t, ids, mesh, batch_axes=("data", "fsdp"))
        except ValueError as e:
            out["refused"] = str(e)
        cfg = dlrm.DLRMConfig(**SMALL)

        def trainer(seed, model=None):
            tr = dlrm.make_trainer(cfg, device="cpu", mesh=mesh)
            tr.init(seed=seed, model=model)
            return tr

        def batch(tr, i):
            rows = tr.split_batch(tuple(d[f"{k}{i}"] for k in
                                        ("dense", "cat", "labels")))
            return tr.shard_batch(tr.microbatch(rows))

        start = dlrm.DLRM(cfg, "cpu")
        start.load_state_dict(torch.load(f"{work}/rowwise_start.pt"))
        tr = trainer(0, start)
        out["losses"] = [tr.train_step(batch(tr, i)).item()
                         for i in range(STEPS)]
        out["bytes"] = tr.state_bytes()
        out["local_rows"] = tuple(tr.model.table.shape)
        _, grads = tr._loss_and_grads(tuple(
            torch.from_numpy(d[f"padded_{k}"])
            for k in ("dense", "cat", "labels")))
        names = [n for n, _ in tr._named_trained()]
        out["padded_grad"] = grads[names.index("table")]
        ckpt = FlashCheckpointer(f"{work}/rowwise_store",
                                 ram_dir=f"{work}/rowwise_ram{rank}",
                                 persist_interval=STEPS, commit_timeout=20)
        state = {**tr.train_state(), "step": STEPS, "data": ""}
        out["saved"] = state_checksums(state)
        ckpt.save(STEPS, state)
        ckpt.close()  # persisted, and committed by rank 0
        dist.barrier()
        out["gathered"] = {n: p.clone()
                           for n, p in tr.gathered_params().items()}
        out["next_loss"] = tr.train_step(batch(tr, STEPS)).item()
        fresh = trainer(1)
        reader = FlashCheckpointer(f"{work}/rowwise_store",
                                   ram_dir=f"{work}/rowwise_ram{rank}")
        got, at = reader.restore(
            target={**fresh.train_state(), "step": 0, "data": ""})
        fresh.load_train_state(got)
        out["at"], out["tier"] = at, reader.last_restore_stats["tier"]
        out["restored"] = state_checksums(
            {**fresh.train_state(), "step": at, "data": ""})
        out["fresh_next_loss"] = fresh.train_step(batch(fresh, STEPS)).item()
        reader.close()
        torch.save(out, f"{work}/rowwise_rank{rank}.pt")

    rowwise_job(work, env.rank)
""").replace("STEPS", str(STEPS)).replace("SMALL", repr(SMALL))


def _inputs():
    """The lookup's table, ids and upstream gradient; the numpy weights;
    STEPS + 1 global batches; the padded batch and the rows only its
    padded examples reference."""
    rng = np.random.default_rng(21)
    ids = rng.integers(*IDS, (6, 3)).astype(np.int64)
    ids[0, :2] = IDS[0], IDS[1] - 1  # one id past each end for certain
    out = {"table": rng.standard_normal((ROWS, 4)).astype(np.float32),
           "ids": ids,
           "upstream": rng.standard_normal((6, 3, 4)).astype(np.float32)}
    jcfg = jax_dlrm.DLRMConfig(**SMALL)
    for i in range(STEPS + 1):
        for k, x in zip(("dense", "cat", "labels"),
                        _batch(jcfg, seed=300 + i)):
            out[f"{k}{i}"] = x
    prng = np.random.RandomState(0)
    cat = np.stack([prng.randint(0, s, 6) for s in SMALL["vocab_sizes"]],
                   axis=1).astype(np.int32)
    out["padded_dense"] = prng.randn(6, jcfg.dense_dim).astype(np.float32)
    out["padded_cat"] = cat
    out["padded_labels"] = np.array([1, 0, 1, 0, -1, -1], np.int32)
    return out, _np_params(jcfg, seed=5)


def rank_job(work) -> str:
    """The ranks' code of this module, its inputs written to ``work``."""
    arrays, params = _inputs()
    np.savez(work / "rowwise.npz", **arrays)
    torch.save(dlrm.params_from_jax(params, dlrm.DLRMConfig(**SMALL),
                                    device="cpu").state_dict(),
               work / "rowwise_start.pt")
    return _JOB


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """(work dir, [rank 0's, rank 1's results])."""
    work = rank_groups(tmp_path_factory)["dirs"][2]
    return work, [torch.load(work / f"rowwise_rank{r}.pt")
                  for r in range(2)]


def _jax_mesh():
    return JaxMesh(np.asarray(jax.devices()[:2]).reshape(1, 2),
                   ("data", "fsdp"))


@pytest.fixture(scope="module")
def jax_rowwise():
    """The JAX rowwise trainer's losses and final parameters (port
    layout) from the numpy weights, compiled with the cheap codegen."""
    arrays, params = _inputs()
    jcfg = jax_dlrm.DLRMConfig(**SMALL)
    fast = _FastJax("jax")
    fast.jit = lambda f, **kw: jax.jit(f, compiler_options=FAST_COMPILE,
                                       **kw)
    saved, jax_sharded.jax = jax_sharded.jax, fast
    try:
        trainer = jax_dlrm.make_trainer(jcfg, _jax_mesh(),
                                        optimizer=optax.adagrad(LR))
        step = trainer.train_step
    finally:
        jax_sharded.jax = saved
    p = jax.device_put(jax.tree.map(jnp.asarray, params),
                       trainer.param_shardings)
    state = trainer.optimizer.init(p)
    losses = []
    for i in range(STEPS):
        batch = tuple(arrays[f"{k}{i}"][None]
                      for k in ("dense", "cat", "labels"))
        p, state, loss = step(p, state, trainer.shard_batch(batch))
        losses.append(float(loss))
    return losses, _as_port_layout(jax.tree.map(np.asarray, p))


def test_sharded_lookup_and_gradient_match_jax(two_ranks):
    _, ranks = two_ranks
    arrays, _ = _inputs()
    mesh = _jax_mesh()
    table, ids = jnp.asarray(arrays["table"]), jnp.asarray(
        arrays["ids"], jnp.int32)
    up = jnp.asarray(arrays["upstream"])
    want = jax.jit(lambda t: jax_lookup(t, ids, mesh),
                   compiler_options=FAST_COMPILE)(table)
    grad = jax.jit(jax.grad(lambda t: jnp.sum(jax_lookup(t, ids, mesh) * up)),
                   compiler_options=FAST_COMPILE)(table)
    got_grad = torch.cat([r["lookup_grad"] for r in ranks]).numpy()
    for r in ranks:  # every rank of the shard axis holds the embeddings
        assert np.array_equal(r["lookup"].numpy(), np.asarray(want))
    assert np.array_equal(got_grad, np.asarray(grad))
    # ids in both shards and out of the table on both sides
    assert (arrays["ids"] < 0).any() and (arrays["ids"] >= ROWS).any()
    assert ((arrays["ids"] >= 0) & (arrays["ids"] < ROWS // 2)).any()
    assert ((arrays["ids"] >= ROWS // 2) & (arrays["ids"] < ROWS)).any()


def test_lookup_refuses_the_shard_axis_as_a_batch_axis(two_ranks):
    _, ranks = two_ranks
    for r in ranks:
        assert "must not include" in r["refused"]
    # the stub of a two-way mesh, in this process, as well
    with pytest.raises(ValueError, match="must not include"):
        embedding.vocab_parallel_lookup(
            torch.zeros(4, 2), torch.zeros(2, 2, dtype=torch.long),
            _TwoWay(), batch_axes=("data", "fsdp"))


class _TwoWay:
    """The questions the lookup asks a mesh of ``(data 1, fsdp 2)``."""

    mesh_dim_names = ("data", "fsdp")

    def size(self, dim):
        return (1, 2)[dim]


def test_three_adagrad_steps_match_the_jax_rowwise_trainer(
        two_ranks, jax_rowwise):
    _, ranks = two_ranks
    jax_losses, want = jax_rowwise
    for r in ranks:
        assert r["losses"] == pytest.approx(jax_losses, rel=1e-5)
        for name, p in r["gathered"].items():
            _assert_close(p.numpy(), want[name])
    assert torch.equal(ranks[0]["gathered"]["table"],
                       ranks[1]["gathered"]["table"])


def test_each_rank_keeps_half_the_tables(two_ranks):
    cfg = dlrm.DLRMConfig(**SMALL)
    _, ranks = two_ranks
    tables = 4 * cfg.padded_vocab * (cfg.embed_dim + 1)
    mlps = 4 * dlrm.param_count(cfg) - tables
    for r in ranks:
        assert r["local_rows"] == (cfg.padded_vocab // 2, cfg.embed_dim)
        assert r["bytes"]["params"] == tables // 2 + mlps
        assert r["bytes"]["optimizer"] == tables // 2 + mlps


def test_rows_only_padded_examples_reference_get_no_gradient(two_ranks):
    arrays, _ = _inputs()
    cfg = dlrm.DLRMConfig(**SMALL)
    offsets = np.concatenate([[0], np.cumsum(cfg.vocab_sizes)[:-1]])
    rows = arrays["padded_cat"] + offsets
    only_padded = set(rows[4:].ravel()) - set(rows[:4].ravel())
    assert only_padded
    grad = torch.cat([r["padded_grad"] for r in two_ranks[1]])
    for row in only_padded:
        assert torch.count_nonzero(grad[row]) == 0
    assert torch.count_nonzero(grad) > 0


def test_rowwise_save_restores_into_fresh_ranks(two_ranks):
    _, ranks = two_ranks
    for r in ranks:
        assert r["at"] == STEPS and r["tier"] == "ram"
        assert r["restored"] == r["saved"]
        assert r["fresh_next_loss"] == r["next_loss"]
    assert ranks[0]["saved"] != ranks[1]["saved"]  # each its own rows


def test_rowwise_save_restores_whole_into_one_rank(two_ranks, tmp_path):
    work, ranks = two_ranks
    trainer = dlrm.make_trainer(dlrm.DLRMConfig(**SMALL), device="cpu")
    trainer.init(seed=7)
    solo = FlashCheckpointer(str(work / "rowwise_store"),
                             ram_dir=str(tmp_path / "ram-solo"))
    got, step = solo.restore(
        target={**trainer.train_state(), "step": 0, "data": ""})
    solo.close()
    assert step == STEPS
    trainer.load_train_state(got)
    for name, p in trainer.gathered_params().items():
        assert torch.equal(p, ranks[0]["gathered"][name]), name


def test_rowwise_save_read_by_jax(two_ranks, tmp_path):
    work, ranks = two_ranks
    r = JaxFlashCheckpointer(str(work / "rowwise_store"),
                             ram_dir=str(tmp_path / "jax-ram"),
                             persist_interval=0, use_orbax=False,
                             process_index=0, n_processes=1)
    got, step = r.restore()
    r.close()
    assert step == STEPS
    want = ranks[0]["gathered"]
    model = jax.tree.map(np.asarray, got["model"])
    assert np.array_equal(model["table"], want["table"].numpy())
    assert np.array_equal(model["bottom"][1]["w"],
                          want["bottom.1.weight"].numpy().T)
    assert np.array_equal(model["head"]["b"], want["head.bias"].numpy())
    acc = np.asarray(got["optimizer"]["sum_of_squares"]["table"])
    assert acc.shape == model["table"].shape and (acc >= 0.1).all()

