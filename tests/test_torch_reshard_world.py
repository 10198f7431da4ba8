"""Reshard-in-place across gloo CPU ranks, held to the JAX trainer.

``chip_smoke.run_reshard(device="cpu")`` runs phase "reshard"'s logic on
llama_tiny: two gloo ranks under fsdp and the port's distributed master
(``--platform process``, ``DLROVER_TPU_RESHARD=1``);
``node_lost@3:host=1`` SIGKILLs rank 1 after its step-3 save is durable,
the master's heartbeat watchdog declares it lost, rank 0 takes the
shrink (2 -> 1) in process (its half live, rank 1's from the store),
trains two steps, and a joiner the master's process scaler launches on
``request_scale`` grows the world back (1 -> 2) over rank 0's RAM tier,
two steps more, through the master's crash and its restore from the
journal. Its own gates: each migrated state bitwise a fresh
``restore(step=pinned)``, the steps after it against the port's
one-process step, the survivor's pid, the journal's reshard window, the
move stats, a planted stale-live migration failing the bitwise gate.

Here the steps after each transition are also held to the JAX fsdp
trainer started from the same pinned state (numpy, in the JAX tree's
coordinates) on the same global rows: losses within 1e-3 relative and
phase "mesh"'s parameter rule. The JAX side runs in two spawned
workers, one a transition, started before the ranks, as
``test_torch_strategies.py`` does."""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

import chip_smoke

LAYERS = 2
#: (the transition, JAX microbatches per step: the world after it)
TRANSITIONS = {"shrink": 2, "grow": 1}

_JAX = {}


def _jax_trainer(accum):
    """The JAX fsdp trainer of llama_tiny on one CPU device at ``accum``
    microbatches, its step built with XLA's cheap codegen (cached)."""
    if accum not in _JAX:
        import jax
        import optax
        from jax.sharding import Mesh

        from dlrover_tpu.models import llama as jax_llama
        from dlrover_tpu.trainer.sharded import make_trainer_for_llama
        from tests.test_torch_strategies import _cheap_codegen

        jcfg = jax_llama.llama_tiny(num_layers=LAYERS)
        mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                    ("data", "fsdp"))
        with _cheap_codegen():
            jt = make_trainer_for_llama(
                jcfg, mesh, strategy="fsdp", accum_steps=accum,
                optimizer=optax.adamw(chip_smoke.MESH_LR, b1=0.9, b2=0.95))
            _ = jt.train_step
        _JAX[accum] = (jt, jcfg)
    return _JAX[accum]


def _warm(accum):
    _jax_trainer(accum)


def _jax_steps(pinned, rows, accum):
    """The JAX trainer from the pinned state ``{"path": (array, dtype)}``
    on the global ``rows`` of each step: (losses, parameters before and
    after, in the port's layout)."""
    import jax
    import jax.numpy as jnp

    from dlrover_tpu.models import llama as jax_llama
    from dlrover_tpu_torch.models import llama
    from tests.test_torch_strategies import _port_view

    jt, jcfg = _jax_trainer(accum)

    def key(path):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)

    def tree(prefix, like):
        return jax.tree_util.tree_map_with_path(
            lambda p, x: jnp.asarray(pinned[f"{prefix}/{key(p)}"][0],
                                     dtype=pinned[f"{prefix}/{key(p)}"][1]),
            like)

    template = jax_llama.init_params(jax.random.key(0), jcfg)
    params = jax.jit(lambda t: t, out_shardings=jt.param_shardings)(
        tree("model", template))
    opt_state = jt.optimizer.init(params)
    adam = opt_state[0]
    assert type(adam).__name__ == "ScaleByAdamState"
    count = pinned["optimizer/count"][0]
    opt_state = (adam._replace(
        count=jnp.asarray(count, adam.count.dtype),
        mu=tree("optimizer/mu", template),
        nu=tree("optimizer/nu", template)),) + tuple(opt_state[1:])
    cfg = llama.llama_tiny(num_layers=LAYERS)
    tokens = chip_smoke.reshard_tokens(cfg, chip_smoke.RESHARD_S_CPU)
    def view(p):  # fp32 numpy (torch takes no ml_dtypes bfloat16)
        return _port_view(jax.tree.map(
            lambda x: np.asarray(x, np.float32), p), cfg)

    init = view(params)
    losses = []
    for idx in rows:
        idx = np.asarray(idx)
        batch = (tokens[idx, :-1].astype(np.int32),
                 tokens[idx, 1:].astype(np.int32))
        params, opt_state, loss = jt.train_step(
            params, opt_state, jt.shard_batch(jt.microbatch(batch)))
        losses.append(float(loss))
    return losses, init, view(params)


@pytest.fixture(scope="module")
def run():
    # one spawned JAX worker a transition, each warmed while the ranks run
    pools = {what: ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
        for what in TRANSITIONS}
    try:
        warm = [pools[what].submit(_warm, accum)
                for what, accum in TRANSITIONS.items()]
        got = chip_smoke.run_reshard(LAYERS, device="cpu")
        for f in warm:
            f.result()
        jax_runs = {
            what: pools[what].submit(_jax_steps,
                                     got["pinned"][what]["numpy"],
                                     got["pinned"][what]["rows"], accum)
            for what, accum in TRANSITIONS.items()}
        got["jax"] = {what: f.result() for what, f in jax_runs.items()}
    finally:
        for pool in pools.values():
            pool.shutdown(wait=True)
    return got


def test_shrink_and_grow_pass_the_phase_gates(run):
    assert run["failed"] == []
    r = run["readings"]
    assert r["moves"]["shrink"]["live"] > 0
    assert r["moves"]["shrink"]["store"] > 0
    assert r["moves"]["grow node 2"]["peer"] > 0
    assert r["planted_caught"]
    assert r["failed_step"] == chip_smoke.RESHARD_LOST + 1
    assert run["results"][0]["pid"] == run["results"][0]["pid_end"]
    # the master's part: the watchdog's verdict, one launch, the restore
    assert r["detection_s"] >= (chip_smoke.RESHARD_WATCHDOG_S
                                - chip_smoke.RESHARD_HB_INTERVAL_S)
    assert [(p["launch"], p["remove"]) for p in r["scale_plans"]] == [(1, 0)]
    assert r["master_restored"]["global_step"] >= 1
    assert r["goodput_faults"].count("master_restart") == 1


def test_migrated_states_are_the_restored_step_bitwise(run):
    shrink, grow0 = run["results"][0]["transitions"]
    grow2, = run["results"][2]["transitions"]
    assert shrink["sums"] == run["pinned"]["shrink"]["sums"]
    assert [grow0["sums"], grow2["sums"]] == run["pinned"]["grow"][
        "sums_for"]
    assert shrink["planted_sums"] != shrink["sums"]


@pytest.mark.parametrize("what", sorted(TRANSITIONS))
def test_steps_after_the_transition_match_the_jax_trainer(run, what):
    jax_losses, jax_init, jax_final = run["jax"][what]
    losses = run["readings"]["losses"]
    ours = ([losses["shrink"]] if what == "shrink"
            else [losses["grow node 0"], losses["grow node 2"]])
    for got in ours:
        assert len(got) == len(jax_losses)
        np.testing.assert_allclose(got, jax_losses,
                                   rtol=chip_smoke.MESH_LOSS_RTOL)
    steps = (chip_smoke.RESHARD_WORLD1_STEPS if what == "shrink"
             else chip_smoke.RESHARD_WORLD2_STEPS)
    ref = {k: torch.from_numpy(v) for k, v in jax_final.items()}
    init = {k: torch.from_numpy(v) for k, v in jax_init.items()}
    for name, shards in run["shards"].items():
        if not name.startswith(what):
            continue
        check = chip_smoke._against_reference(shards, ref, init, steps)
        assert check["param_within_2lr_share"] >= chip_smoke.MESH_WITHIN_SHARE
        assert check["param_diff_lr"]["per_step"] <= 2.0 * steps
