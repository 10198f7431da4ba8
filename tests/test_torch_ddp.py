"""The port's "ddp" step at world 2 against the JAX ddp step on the
whole batch: two gloo ranks, each on its half of a seeded global batch,
must hold bitwise-equal parameters after every step.

On batches that mask no target, three steps match the JAX trainer (one
CPU device, the whole batch) within the tolerances of
test_torch_trainer.py::test_three_adamw_steps_match_jax. On batches whose
ranks and microbatches hold different counts of unmasked targets, where
a plain mean of the ranks' mean losses is not the JAX loss, each step's
loss and reduced gradient are held against the JAX loss and gradient on
the global batch at the same parameters (the tolerances of
test_torch_llama.py::test_loss_and_grads_match_jax). The trajectory is
not compared there: on these batches AdamW turns fp32 rounding in
near-zero gradients into steps of up to 1.43 lr after two steps, one
rank on the whole batch as much as two.
"""

import os
import re
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.parallel.mesh import create_mesh
from dlrover_tpu.trainer.sharded import (
    make_trainer_for_llama as jax_make_trainer,
)
from dlrover_tpu_torch.models import llama

from tests.test_torch_llama import (
    RTOL,
    ATOL,
    _as_port_layout,
    _assert_grads_close,
    _batch,
)
from tests.test_torch_trainer import _assert_adam_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
STEPS = 3
#: the ranks' DLROVER_TPU_DIST_HEARTBEAT_TIMEOUT
HEARTBEAT_S = 3

_RANK = textwrap.dedent("""
    import hashlib, os, sys, time, numpy as np, torch
    import torch.distributed as dist
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.trainer.distributed import init_from_env
    from dlrover_tpu_torch.trainer.sharded import (
        adamw, make_trainer_for_llama)
    work = sys.argv[1]
    torch.set_num_threads(1)  # the ranks and the JAX run share the cores
    env = init_from_env(timeout_s=60, device="cpu")

    def digest(model):
        return hashlib.sha256(b"".join(
            p.detach().numpy().tobytes()
            for p in model.parameters())).hexdigest()

    cfg = llama.llama_tiny(dtype=torch.float32, remat="off")
    data = np.load(f"{work}/batches.npz")
    out = {}
    for kind, accum in [(k, a) for k in ("full", "masked") for a in (1, 2)]:
        model = llama.init_params(cfg, seed=0, device="cpu")
        digests = [digest(model)]  # each rank's init from the same seed
        model.load_state_dict(torch.load(f"{work}/start.pt"))
        trainer = make_trainer_for_llama(
            cfg, device="cpu", accum_steps=accum,
            optimizer=adamw(1e-3, b1=0.9, b2=0.95))
        trainer.init(model=model)
        names = [n for n, _ in trainer.model.named_parameters()]
        before, grads = [], []
        update = trainer.optimizer.step

        def step(*args):
            # the reduced gradients the update takes: p.grad at one
            # microbatch, the fp32 means under accumulation
            got = args[0] if args else [
                p.grad for p in trainer.model.parameters()]
            grads.append({n: g.detach().clone() for n, g in zip(names, got)})
            return update(*args)

        trainer.optimizer.step = step
        losses = []
        tokens, targets = data[f"tokens_{kind}"], data[f"targets_{kind}"]
        for i in range(len(tokens)):
            half = tokens[i].shape[0] // env.world_size
            rows = slice(env.rank * half, (env.rank + 1) * half)
            batch = (tokens[i][rows], targets[i][rows])
            before.append({n: p.detach().clone()
                           for n, p in trainer.model.named_parameters()})
            losses.append(trainer.train_step(trainer.shard_batch(
                trainer.microbatch(batch))).item())
            digests.append(digest(trainer.model))
        out[kind, accum] = {
            "losses": losses, "digests": digests, "before": before,
            "grads": grads,
            "params": {n: p.detach().clone()
                       for n, p in trainer.model.named_parameters()}}
    torch.save(out, f"{work}/rank{env.rank}.pt")
    dist.barrier()
    # R2: a collective blocked on a peer that is alive but never joins
    # raises after the heartbeat timeout
    if env.rank == 1:
        time.sleep(60)
    t0 = time.monotonic()
    try:
        dist.all_reduce(torch.ones(4))
        print("REDUCED", flush=True)
    except Exception:
        print(f"RAISED {time.monotonic() - t0:.3f}", flush=True)
    os._exit(0)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def batches():
    """{"full": batches that mask no target, "masked": batches whose
    last target is masked, and which mask 5 more on rank 0's first row
    and 12 more on rank 1's last}."""
    cfg = llama.llama_tiny()
    full = [_batch(cfg, b=4, s=32, seed=300 + i, masked=False)
            for i in range(STEPS)]
    masked = [_batch(cfg, b=4, s=32, seed=300 + i) for i in range(STEPS)]
    for _, targets in masked:
        targets[3, :12] = -1
    return {"full": full, "masked": masked}


def _as_jax_microbatches(batch, accum, world=2):
    """The global batch with its rows in the order in which the ranks'
    microbatches make up the JAX step's: microbatch i of the JAX step is
    every rank's microbatch i, rank by rank, as the data-sharded global
    array of the JAX loop is."""
    rows = batch[0].shape[0]
    per = rows // world // accum
    order = [r * (rows // world) + i * per + j
             for i in range(accum) for r in range(world) for j in range(per)]
    return tuple(x[order] for x in batch)


def _jax_run(jtrainer, steps, accum):
    params, opt_state = jtrainer.init(jax.random.key(0))
    losses = []
    for batch in steps:
        params, opt_state, loss = jtrainer.train_step(
            params, opt_state, jtrainer.shard_batch(jtrainer.microbatch(
                _as_jax_microbatches(batch, accum))))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, batches):
    """Both steps from the JAX trainer's starting weights, on both kinds
    of batches, at one and at two microbatches: (the starting weights in
    the port's layout and as the JAX tree, {(kind, accum): the JAX
    step's (losses, params in the port's layout)}, {(kind, accum): [rank
    0's, rank 1's] run}). The ranks run while the JAX trainer does."""
    jcfg = jax_llama.llama_tiny(dtype=np.float32, remat="off")
    mesh = create_mesh([("data", 1)], devices=[jax.devices()[0]])
    trainers = {accum: jax_make_trainer(
        jcfg, mesh, strategy="ddp", accum_steps=accum,
        optimizer=optax.adamw(LR, b1=0.9, b2=0.95)) for accum in (1, 2)}
    jax_start = jax.tree.map(np.array, trainers[1].init(jax.random.key(0))[0])
    tmp_path = tmp_path_factory.mktemp("ddp")
    cfg = llama.llama_tiny(dtype=torch.float32, remat="off")
    model = llama.params_from_jax(jax_start, cfg, device="cpu")
    torch.save(model.state_dict(), tmp_path / "start.pt")
    np.savez(tmp_path / "batches.npz", **{
        f"{leaf}_{kind}": np.stack([b[j] for b in steps]).astype(np.int64)
        for kind, steps in batches.items()
        for j, leaf in enumerate(("tokens", "targets"))})
    start = {n: p.detach().float().numpy().copy()
             for n, p in model.named_parameters()}
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _RANK, str(tmp_path)],
            env={**os.environ, "PYTHONPATH": REPO,
                 "DLROVER_TPU_COORDINATOR_ADDR": f"localhost:{port}",
                 "DLROVER_TPU_PROCESS_ID": str(rank),
                 "DLROVER_TPU_NUM_PROCESSES": "2",
                 "DLROVER_TPU_DIST_HEARTBEAT_TIMEOUT": str(HEARTBEAT_S),
                 "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"},
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for rank in range(2)]
    try:
        jax_out = {}
        for accum, jtrainer in trainers.items():
            for kind, steps in batches.items():
                losses, params = _jax_run(jtrainer, steps, accum)
                jax_out[kind, accum] = (losses, _as_port_layout(params, jcfg))
        # rank 1 sleeps on in its stuck collective; rank 0 ends
        out, err = procs[0].communicate(timeout=120)
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    assert procs[0].returncode == 0, err[-1500:]
    raised = re.search(r"^RAISED (\S+)$", out, re.M)
    assert raised, (out, err[-1500:])
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    port_out = {}
    for key in ranks[0]:
        # the same parameters on both ranks from the seed and after
        # each step
        assert ranks[0][key]["digests"] == ranks[1][key]["digests"]
        assert len(ranks[0][key]["digests"]) == STEPS + 1
        port_out[key] = [{k: _numpy(v) for k, v in r[key].items()}
                         for r in ranks]
    return (start, jax_start), jax_out, port_out, float(raised.group(1))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy() if torch.is_tensor(tree) else tree


@pytest.mark.parametrize("accum", [1, 2])
def test_two_ranks_match_the_jax_ddp_step(runs, accum):
    (start, _), jax_out, port_out, _ = runs
    jax_losses, want = jax_out["full", accum]
    rank0, rank1 = port_out["full", accum]
    # every rank holds the same parameters and reports the same loss
    assert rank0["losses"] == rank1["losses"]
    for name in rank0["params"]:
        assert np.array_equal(rank0["params"][name], rank1["params"][name])
    assert rank0["losses"] == pytest.approx(jax_losses, rel=1e-5)
    _assert_adam_close(rank0["params"], want, start, lr=LR)


def _as_jax_tree(port, like):
    """{port parameter name: array} -> the JAX parameter tree ``like``
    (the inverse of _as_port_layout)."""
    layers = len(next(iter(like["blocks"].values())))

    def block(i, name):
        if name.endswith("norm"):
            return port[f"blocks.{i}.{name}"]
        return port[f"blocks.{i}.{name}.weight"].T

    return {"embed": port["embed"], "final_norm": port["final_norm"],
            "lm_head": port["lm_head.weight"].T,
            "blocks": {name: np.stack([block(i, name) for i in range(layers)])
                       for name in like["blocks"]}}


@pytest.mark.parametrize("accum", [1, 2])
def test_ranks_with_different_unmasked_counts_match_the_jax_step(
        runs, batches, accum):
    """Each rank divides its masked loss sum by the global count of
    unmasked targets, so every step's loss and reduced gradient are the
    JAX step's masked mean over the global batch."""
    jcfg = jax_llama.llama_tiny(dtype=np.float32, remat="off")
    grad_fn = jax.jit(jax.value_and_grad(
        lambda params, batch: jax_llama.next_token_loss(params, batch, jcfg)))
    (start, jax_start), _, port_out, _ = runs
    for name, want in start.items():  # _as_jax_tree inverts the layout
        assert np.array_equal(
            _as_port_layout(_as_jax_tree(start, jax_start), jcfg)[name], want)
    rank0, rank1 = port_out["masked", accum]
    assert rank0["losses"] == rank1["losses"]
    for k, batch in enumerate(batches["masked"]):
        counts = (batch[1].reshape(2, accum, -1) >= 0).sum(axis=-1)
        assert counts[0].sum() != counts[1].sum()  # [rank, microbatch]
        assert len({tuple(c) for c in counts}) == 2
        micros = [x.reshape((accum, -1) + x.shape[1:])
                  for x in _as_jax_microbatches(batch, accum)]
        params = _as_jax_tree(rank0["before"][k], jax_start)
        loss, grads = 0.0, None
        for i in range(accum):
            li, gi = grad_fn(params, (micros[0][i], micros[1][i]))
            gi = _as_port_layout(gi, jcfg)
            loss += float(li) / accum
            grads = {n: g / accum + (grads[n] if grads else 0.0)
                     for n, g in gi.items()}
        np.testing.assert_allclose(rank0["losses"][k], loss, rtol=1e-5)
        _assert_grads_close(rank0["grads"][k], grads, rtol=RTOL, atol=ATOL)
        for name in grads:
            assert np.array_equal(rank0["grads"][k][name],
                                  rank1["grads"][k][name])


def test_a_rank_blocked_on_a_stuck_peer_raises_within_the_heartbeat(runs):
    """R2: the process group's collectives time out after
    DLROVER_TPU_DIST_HEARTBEAT_TIMEOUT (3 s here), not after a fixed
    300 s, so that the agent can re-rendezvous: after the steps, rank 0
    waits in an all_reduce that rank 1, alive, never joins."""
    assert 2.5 <= runs[3] <= 10.0
