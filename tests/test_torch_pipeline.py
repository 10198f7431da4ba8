"""Pipeline parallelism of the port against the JAX package on the CPU
(``parallel/pipeline.py``): two gloo CPU ranks on (pipe 2), started
once for the module, against JAX's functions on the virtual CPU mesh of
the same shape, on inputs made with numpy from a seed, the JAX weights
carried over with ``params_from_jax``:

* ``gpipe_apply`` of a small residual block with an auxiliary term, at
  M = 2 and 4, and ``interleaved_pipeline_apply`` of it at V = 2, M = 4
  with ``schedule_stats``: outputs, the aux, the gradients of the input
  and of every layer's weights, and the measured bubble, equal to JAX's
  and to ``bubble_fraction(2, 4, 2)``;
* ``pipeline_llama_forward`` on llama_tiny (4 layers, fp32) with GPipe
  at M = 2 and 4, and interleaved at V = 2, M = 4 with
  ``schedule_stats`` (held to JAX's GPipe at M = 4: the schedules
  compute the same function): logits and the gradients of every leaf --
  each block's on the stage that holds it, the embedding's on stage 0
  alone, the final norm's and the head's the same on both stages -- and
  the measured bubble;
* the MoE auxiliary loss through the pipeline (llama_moe_tiny) against
  JAX's ``return_aux=True``;
* the remat mapping: under ``"dots_attn_out"`` each block runs as
  ``"dots"`` (attention recomputed in the backward: two calls a layer a
  microbatch), with the same values.

The ranks' ``ppermute`` over JAX's non-cyclic ``[(0, 1)]``: values,
gradient and bytes sent. In the test process: one stage degrades to the
plain stack, and each of JAX's ``ValueError``s is raised with JAX's
message. Tolerances: fp32,
2e-3 for values and 5e-3 for gradients (test_flash_attention.py). The
JAX side compiles on threads while the ranks run."""

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.parallel import pipeline as jax_pipeline
from dlrover_tpu.parallel.compat import shard_map
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.parallel import pipeline
from dlrover_tpu_torch.parallel.mesh import create_mesh

from tests.test_torch_gpt import FAST_COMPILE
from tests.test_torch_strategies import _free_port, _port_view

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the toy stack: 4 layers of d -> f -> d on [batch, seq, d]
TOY = dict(layers=4, b=4, s=8, d=16, f=32)
#: the Llama runs: (name, config, microbatches, chunks, remat)
RUNS = [("gpipe_m2", "dense", 2, 1, "off"),
        ("gpipe_m4", "dense", 4, 1, "off"),
        ("interleaved", "dense", 4, 2, "off"),
        ("moe", "moe", 2, 1, "off"),
        ("remat", "dense", 4, 1, "dots_attn_out")]
TOKENS = dict(b=4, s=16)
#: the JAX runs the Llama runs are held to, by name (the schedules and
#: remat compute the same function: the others reuse GPipe at M = 4)
JAX_RUNS = {"gpipe_m2": "gpipe_m2", "gpipe_m4": "gpipe_m4",
            "moe": "moe", "interleaved": "gpipe_m4", "remat": "gpipe_m4"}

_RANK = textwrap.dedent("""
    import sys, numpy as np, torch
    import torch.distributed as dist
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.parallel import pipeline
    from dlrover_tpu_torch.parallel.mesh import create_mesh
    from dlrover_tpu_torch.trainer.distributed import init_from_env
    work, runs = sys.argv[1], eval(sys.argv[2])
    torch.set_num_threads(1)
    env = init_from_env(timeout_s=60, device="cpu")
    mesh = create_mesh([("pipe", 2)], device="cpu")
    data = np.load(f"{work}/inputs.npz")
    out = {}

    # ppermute over JAX's non-cyclic pair: values, gradient, bytes sent
    from dlrover_tpu_torch.trainer import distributed as coll
    x = torch.from_numpy(data["perm_x"][env.rank]).requires_grad_()
    coll.collective_bytes(reset=True)
    y = coll.ppermute(x, dist.group.WORLD, [(0, 1)])
    sent = coll.collective_bytes(reset=True)["ppermute"]
    (g,) = torch.autograd.grad(
        (y * torch.from_numpy(data["perm_dy"][env.rank])).sum(), x)
    out["ppermute"] = {"y": y.detach(), "grad": g, "sent": (
        sent, coll.collective_bytes(reset=True)["ppermute"])}

    def toy_block(x, p):
        h = torch.tanh(x @ p["w1"])
        return x + h @ p["w2"], (h * h).mean()

    for m, v in ((2, 1), (4, 1), (4, 2)):
        x = torch.from_numpy(data["toy_x"]).requires_grad_()
        layers = [{"w1": torch.from_numpy(w1).requires_grad_(),
                   "w2": torch.from_numpy(w2).requires_grad_()}
                  for w1, w2 in zip(data["toy_w1"], data["toy_w2"])]
        if v == 1:
            y, aux = pipeline.gpipe_apply(toy_block, layers, x, mesh, m)
            stats = None
        else:
            y, aux, stats = pipeline.interleaved_pipeline_apply(
                toy_block, layers, x, mesh, m, num_chunks=v,
                schedule_stats=True)
        own = pipeline.stage_layers(len(layers), 2, env.rank, v)
        leaves = [x] + [layers[i][k] for i in own for k in ("w1", "w2")]
        grads = torch.autograd.grad(
            (y * torch.from_numpy(data["toy_dy"])).sum() + aux, leaves,
            allow_unused=True)
        out[f"toy_m{m}_v{v}"] = {
            "y": y.detach(), "aux": aux.item(), "own": own, "stats": stats,
            "grads": [None if g is None else g.detach() for g in grads]}

    for name, kind, m, v, remat in runs:
        cfg = (llama.llama_moe_tiny(dtype=torch.float32, remat=remat)
               if kind == "moe" else llama.llama_tiny(
                   dtype=torch.float32, remat=remat, num_layers=4))
        model = llama.Llama(cfg, device="cpu")
        model.load_state_dict(torch.load(f"{work}/{kind}.pt"))
        model.keep_layers(pipeline.stage_layers(cfg.num_layers, 2, env.rank,
                                                v))
        calls = [0]

        def attn(q, k, v):
            calls[0] += 1
            return llama.flash_attention(q, k, v, causal=True)

        tokens = torch.from_numpy(data["tokens"]).long()
        got = pipeline.pipeline_llama_forward(
            model, tokens, cfg, mesh, num_microbatches=m, attn_fn=attn,
            return_aux=True, num_chunks=v, schedule_stats=v > 1)
        logits, aux = got[:2]
        named = list(model.named_parameters())
        loss = (logits * torch.from_numpy(data["dlogits"])).sum() + aux
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
        out[name] = {"logits": logits.detach(), "aux": aux.item(),
                     "attn_calls": calls[0],
                     "stats": got[2] if v > 1 else None,
                     "grads": {n: g.detach() for (n, _), g in
                               zip(named, grads) if g is not None}}
    torch.save(out, f"{work}/rank{env.rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
""")


def _cfgs(kind, remat="off"):
    """(port config, JAX config) of a run."""
    if kind == "moe":
        return (llama.llama_moe_tiny(dtype=torch.float32, remat=remat),
                jax_llama.llama_moe_tiny(dtype=np.float32, remat=remat))
    return (llama.llama_tiny(dtype=torch.float32, remat=remat,
                             num_layers=4),
            jax_llama.llama_tiny(dtype=np.float32, remat=remat,
                                 num_layers=4))


def _inputs():
    rng = np.random.default_rng(41)

    def rand(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    c = TOY
    return {"toy_x": rand(c["b"], c["s"], c["d"]),
            "toy_w1": rand(c["layers"], c["d"], c["f"], scale=0.3),
            "toy_w2": rand(c["layers"], c["f"], c["d"], scale=0.3),
            "toy_dy": rand(c["b"], c["s"], c["d"]),
            "tokens": rng.integers(0, 256, (TOKENS["b"], TOKENS["s"])
                                   ).astype(np.int32),
            "dlogits": rand(TOKENS["b"], TOKENS["s"], 256),
            "perm_x": rand(2, 3), "perm_dy": rand(2, 3)}


@functools.lru_cache(maxsize=None)
def _jax_params(kind):
    """The JAX parameter tree of a run as numpy, drawn from a seed: norms
    1, the embedding N(0, 0.02), matrices N(0, 1/fan_in)."""
    rng = np.random.default_rng(5)
    jcfg = _cfgs(kind)[1]
    shapes = jax.eval_shape(lambda key: jax_llama.init_params(key, jcfg),
                            jax.random.key(0))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            return np.ones(leaf.shape, np.float32)
        std = 0.02 if name == "['embed']" else leaf.shape[-2] ** -0.5
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_mesh(pp=2):
    return JaxMesh(np.asarray(jax.devices()[:pp]), ("pipe",))


def _jax_toy(m, v):
    """JAX ``gpipe_apply`` (``interleaved_pipeline_apply`` at v > 1) of
    the toy block: (y, aux, grads of x, w1, w2, stats or None)."""
    a = _inputs()

    def block(x, p):
        h = jnp.tanh(x @ p["w1"])
        return x + h @ p["w2"], jnp.mean(h * h)

    def loss(x, stacked):
        if v == 1:
            out = jax_pipeline.gpipe_apply(block, stacked, x, _jax_mesh(), m)
        else:
            out = jax_pipeline.interleaved_pipeline_apply(
                block, stacked, x, _jax_mesh(), m, num_chunks=v,
                schedule_stats=True)
        return jnp.sum(out[0] * a["toy_dy"]) + out[1], out

    (gx, gp), out = jax.jit(
        jax.grad(loss, argnums=(0, 1), has_aux=True),
        compiler_options=FAST_COMPILE)(
        a["toy_x"], {"w1": a["toy_w1"], "w2": a["toy_w2"]})
    stats = (jax.tree.map(lambda x: float(np.asarray(x)), out[2])
             if v > 1 else None)
    return (np.asarray(out[0]), float(out[1]), np.asarray(gx),
            np.asarray(gp["w1"]), np.asarray(gp["w2"]), stats)


def _jax_llama(kind, m, v, remat, pp=2):
    """JAX ``pipeline_llama_forward``: (logits, aux, grads of every leaf
    in the port's layout, stats or None)."""
    a = _inputs()
    cfg, jcfg = _cfgs(kind, remat)

    def loss(params):
        out = jax_pipeline.pipeline_llama_forward(
            params, a["tokens"], jcfg, _jax_mesh(pp), num_microbatches=m,
            return_aux=True, num_chunks=v, schedule_stats=v > 1)
        return jnp.sum(out[0] * a["dlogits"]) + out[1], out

    grads, out = jax.jit(jax.grad(loss, has_aux=True),
                         compiler_options=FAST_COMPILE)(_jax_params(kind))
    stats = (jax.tree.map(lambda x: float(np.asarray(x)), out[2])
             if v > 1 else None)
    return (np.asarray(out[0]), float(out[1]),
            _port_view(grads, cfg), stats)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results and the JAX side's: {"ranks": [rank 0's,
    rank 1's], "jax": {run: ...}, "toy": {m: ...}}."""
    work = tmp_path_factory.mktemp("pipeline")
    np.savez(work / "inputs.npz", **_inputs())
    for kind in ("dense", "moe"):
        torch.save(llama.params_from_jax(
            _jax_params(kind), _cfgs(kind)[0], device="cpu").state_dict(),
            work / f"{kind}.pt")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(work),
         repr([r for r in RUNS])],
        env={**os.environ, "PYTHONPATH": REPO,
             "DLROVER_TPU_COORDINATOR_ADDR": f"localhost:{port}",
             "DLROVER_TPU_PROCESS_ID": str(rank),
             "DLROVER_TPU_NUM_PROCESSES": "2",
             "DLROVER_TPU_DIST_HEARTBEAT_TIMEOUT": "30",
             "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    try:
        with ThreadPoolExecutor(len(RUNS) + 2) as pool:
            toy = {mv: pool.submit(_jax_toy, *mv)
                   for mv in ((2, 1), (4, 1), (4, 2))}
            runs = {name: pool.submit(_jax_llama, kind, m, v, remat)
                    for name, kind, m, v, remat in RUNS
                    if name in JAX_RUNS.values()}
            out = {"toy": {m: f.result() for m, f in toy.items()},
                   "jax": {n: f.result() for n, f in runs.items()}}
        logs = [p.communicate(timeout=120)[0] for p in procs]
        assert [p.returncode for p in procs] == [0, 0], logs[0][-3000:]
        out["ranks"] = [torch.load(work / f"rank{r}.pt") for r in range(2)]
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def test_ppermute_over_a_permutation_matches_jax(ranks):
    """JAX's ``[(0, 1)]``: rank 1 gets rank 0's tensor and rank 0 zeros;
    the gradient goes back along ``[(1, 0)]``; each rank counts the bytes
    it really sent (rank 0 in the forward, rank 1 in the backward)."""
    a = _inputs()
    spec = jax.sharding.PartitionSpec("pipe")
    perm = shard_map(lambda x: jax.lax.ppermute(x, "pipe", [(0, 1)]),
                     mesh=_jax_mesh(), in_specs=spec, out_specs=spec)
    y = np.asarray(perm(a["perm_x"]))
    grad = np.asarray(jax.grad(lambda x: jnp.sum(perm(x) * a["perm_dy"]))(
        a["perm_x"]))
    for r, got in enumerate(rk["ppermute"] for rk in ranks["ranks"]):
        assert np.array_equal(got["y"].numpy(), y[r])
        assert np.array_equal(got["grad"].numpy(), grad[r])
        assert got["sent"] == ((12, 0) if r == 0 else (0, 12))


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("m,v", [(2, 1), (4, 1), (4, 2)],
                         ids=["gpipe-m2", "gpipe-m4", "interleaved-m4-v2"])
def test_gpipe_and_interleaved_apply_match_jax(ranks, m, v):
    y, aux, gx, gw1, gw2, stats = ranks["toy"][m, v]
    for r, run in enumerate(r[f"toy_m{m}_v{v}"] for r in ranks["ranks"]):
        if stats is not None:
            _bubble_holds(run["stats"], stats)
        _close(run["y"].numpy(), y, 2e-3, "y")
        assert run["aux"] == pytest.approx(aux, rel=2e-3)
        grads = run["grads"]
        if r == 0:  # the feed's gradient arises on the first stage
            _close(grads[0].numpy(), gx, 5e-3, "dx")
        else:
            assert grads[0] is None
        for j, layer in enumerate(run["own"]):
            _close(grads[1 + 2 * j].numpy(), gw1[layer], 5e-3, f"w1[{layer}]")
            _close(grads[2 + 2 * j].numpy(), gw2[layer], 5e-3, f"w2[{layer}]")


def _llama_grads_hold(ranks, name, want_grads):
    """Each block's gradient on its stage, the embedding's on stage 0
    only, the final norm's and the head's equal to the bit on both."""
    got = [r[name]["grads"] for r in ranks]
    assert "embed" in got[0] and "embed" not in got[1]
    for n in ("final_norm", "lm_head.weight"):
        assert torch.equal(got[0][n], got[1][n]), n
    blocks = set()
    for g in got:
        for n, t in g.items():
            _close(t.numpy(), want_grads[n], 5e-3, n)
            blocks.add(n)
    assert blocks == set(want_grads)


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_pipeline_llama_forward_matches_jax(ranks, name):
    logits, aux, grads, _ = ranks["jax"][JAX_RUNS.get(name, name)]
    for r in ranks["ranks"]:
        _close(r[name]["logits"].numpy(), logits, 2e-3, "logits")
        assert r[name]["aux"] == pytest.approx(aux, rel=2e-3, abs=1e-7)
    _llama_grads_hold(ranks["ranks"], name, grads)
    if name == "moe":
        assert aux > 0.0
    if name == "interleaved":  # the toy's JAX schedule is the same
        for r in ranks["ranks"]:
            _bubble_holds(r[name]["stats"], ranks["toy"][4, 2][-1])


def _bubble_holds(got, want):
    """The measured bubble of V = 2, M = 4 on two stages: JAX's, and
    ``bubble_fraction``'s 1/9."""
    assert pipeline.bubble_fraction(2, 4, 2) == pytest.approx(1 / 9)
    assert got["bubble_measured"] == pytest.approx(want["bubble_measured"],
                                                   abs=1e-6)
    assert got["bubble_measured"] == pytest.approx(1 / 9, abs=1e-6)
    assert (got["ticks"], got["slots_total"], got["work_slots_used"]) == (
        want["ticks"], want["slots_total"], want["work_slots_used"]) == (
        9, 18, 16)


def test_remat_maps_dots_attn_out_to_dots(ranks):
    """Under "dots_attn_out" each block runs under "dots": attention is
    recomputed in the backward, twice a layer a microbatch on each
    stage's 2 layers at M = 4; without remat once."""
    for r in ranks["ranks"]:
        assert r["remat"]["attn_calls"] == 2 * 4 * 2
        assert r["gpipe_m4"]["attn_calls"] == 4 * 2
        for n, g in r["remat"]["grads"].items():
            _close(g.numpy(), r["gpipe_m4"]["grads"][n].numpy(), 1e-5, n)


def test_one_stage_is_the_plain_stack():
    """Without a pipe axis (one process): the plain stack, as JAX's."""
    a = _inputs()
    cfg = _cfgs("dense")[0]
    model = llama.params_from_jax(_jax_params("dense"), cfg, device="cpu")
    tokens = torch.from_numpy(a["tokens"]).long()
    mesh = create_mesh([("pipe", 1)], device="cpu")
    with torch.no_grad():
        got = pipeline.pipeline_llama_forward(model, tokens, cfg, mesh)
        assert torch.equal(got, model(tokens))
        x = torch.from_numpy(a["toy_x"])
        layers = [{"w1": torch.from_numpy(w1), "w2": torch.from_numpy(w2)}
                  for w1, w2 in zip(a["toy_w1"], a["toy_w2"])]

        def block(x, p):
            return x + torch.tanh(x @ p["w1"]) @ p["w2"], None

        y, aux = pipeline.gpipe_apply(block, layers, x, mesh, 2)
        want = x
        for p in layers:
            want = block(want, p)[0]
        assert torch.equal(y, want) and aux is None
    jcfg = _cfgs("dense")[1]
    want = jax.jit(functools.partial(
        jax_pipeline.pipeline_llama_forward, cfg=jcfg, mesh=_jax_mesh(1)),
        compiler_options=FAST_COMPILE)(_jax_params("dense"), a["tokens"])
    _close(got.numpy(), np.asarray(want), 2e-3, "logits at one stage")


class _PipeMesh:
    """Two pipe stages, for the checks that raise before any collective."""

    mesh_dim_names = ("pipe",)

    def size(self, i):
        return 2


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_value_errors_match_jax():
    jmesh, mesh = _jax_mesh(), _PipeMesh()
    cfg, jcfg = _cfgs("dense")

    def block(x, p):
        return x, 0.0

    def stack(n):
        return (np.zeros((n, 1), np.float32), [None] * n)

    cases = [  # (JAX call, port call) on (layers, batch, M, V)
        ("gpipe", 3, 4, 2, 1), ("gpipe", 4, 3, 2, 1),
        ("interleaved", 4, 4, 4, 0), ("interleaved", 4, 4, 4, 4),
        ("interleaved", 4, 6, 3, 2), ("interleaved", 4, 6, 4, 2)]
    for kind, n, b, m, v in cases:
        jstack, tstack = stack(n)
        jx, tx = np.zeros((b, 2), np.float32), torch.zeros(b, 2)
        if kind == "gpipe":
            want = _message(lambda: jax_pipeline.gpipe_apply(
                block, jstack, jx, jmesh, m))
            got = _message(lambda: pipeline.gpipe_apply(
                block, tstack, tx, mesh, m))
        else:
            want = _message(lambda: jax_pipeline.interleaved_pipeline_apply(
                block, jstack, jx, jmesh, m, num_chunks=v))
            got = _message(lambda: pipeline.interleaved_pipeline_apply(
                block, tstack, tx, mesh, m, num_chunks=v))
        assert got == want, (kind, n, b, m, v)
    tokens = np.zeros((4, 8), np.int32)
    want = _message(lambda: jax_pipeline.pipeline_llama_forward(
        _jax_params("dense"), tokens, jcfg, jmesh, schedule_stats=True))
    got = _message(lambda: pipeline.pipeline_llama_forward(
        llama.Llama(cfg, device="cpu"), torch.from_numpy(tokens), cfg,
        mesh, schedule_stats=True))
    assert got == want == "schedule_stats needs num_chunks > 1"
    want = _message(lambda: jax_pipeline.pipeline_llama_forward(
        _jax_params("dense"), tokens, dataclasses.replace(
            jcfg, remat="bogus"), jmesh))
    got = _message(lambda: dataclasses.replace(cfg, remat="bogus"))
    assert got == want == "unknown remat policy 'bogus'"
