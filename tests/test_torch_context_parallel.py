"""Context parallelism of the port against the JAX package on the CPU
(``parallel/context_parallel.py``, ``RingFlashAttentionFn``, the
"sequence" strategy of ``trainer/sharded.py``).

Two groups of gloo CPU ranks, started together once for the module,
against the JAX functions and trainers on the virtual CPU mesh of the
same shape, on inputs made with numpy from a seed:

* two ranks on (seq 2): ``ring_attention`` causal and non-causal with
  GQA, forward and gradients; ``ulysses_attention``, with its KV repeat
  where the kv heads do not split over the ranks and its error where the
  heads do not; the RoPE offset -- the "sequence" trainer's loss on the
  global batch equals JAX's, and without the rank's chunk offset it does
  not; a "sequence" save of two steps, every box owned once, restored
  whole into one rank;
* four ranks: ``ring_attention`` on (seq 4); the "sequence" trainer on
  llama_tiny at (data 2, seq 2) and (seq 4), with ring attention (the
  default) and with Ulysses, three adamw steps each against JAX's
  ``make_trainer_for_llama(strategy="sequence")``.

The ring's chunks run the flash kernels' plain versions here (the
kernels on the card: tests/test_torch_context_parallel_gpu.py); they
are also held against ``mha_reference`` on the whole sequence.
Tolerances: fp32, 2e-3 for values and 5e-3 for gradients
(test_flash_attention.py); the steps under test_torch_trainer.py's
``_assert_adam_close``."""

import functools
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.parallel import context_parallel as jax_cp
from dlrover_tpu.trainer import sharded as jax_sharded
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.ops.attention import mha_reference
from dlrover_tpu_torch.trainer import ckpt_store
from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer
from dlrover_tpu_torch.trainer.sharded import adamw, make_trainer_for_llama

from tests.test_torch_gpt import FAST_COMPILE
from tests.test_torch_llama import (  # noqa: F401
    _as_port_layout, _batch, one_thread)
from tests.test_torch_strategies import _FastJax, _free_port
from tests.test_torch_trainer import _assert_adam_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
STEPS = 3
SAVE_STEP = 2
#: attention inputs: batch 2, seq 64, 4 heads over 2 kv heads of 16; the
#: Ulysses repeat case 6 over 3 (3 kv heads do not split over 2 ranks)
ATTN = dict(b=2, s=64, h=4, kvh=2, d=16)
#: the four ranks' trainer runs: (mesh, attention)
RUNS = [((("data", 2), ("seq", 2)), "ring"),
        ((("data", 2), ("seq", 2)), "ulysses"),
        ((("seq", 4),), "ring"), ((("seq", 4),), "ulysses")]

_RANK = textwrap.dedent("""
    import sys, numpy as np, torch
    import torch.distributed as dist
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.parallel import context_parallel as cp
    from dlrover_tpu_torch.parallel.mesh import axis_index, create_mesh
    from dlrover_tpu_torch.trainer.distributed import (
        all_reduce_, init_from_env)
    from dlrover_tpu_torch.trainer.sharded import (
        adamw, make_trainer_for_llama)
    work, runs, steps, save_step = (sys.argv[1], eval(sys.argv[2]),
                                    int(sys.argv[3]), int(sys.argv[4]))
    torch.set_num_threads(1)
    env = init_from_env(timeout_s=60, device="cpu")
    n = env.world_size
    out = {}

    # attention alone, on (seq n)
    data = np.load(f"{work}/attn.npz")
    mesh = create_mesh([("seq", n)], device="cpu")
    i = axis_index(mesh, "seq")

    def chunk(a, grad=True):
        s = a.shape[1] // n
        t = torch.from_numpy(a[:, i * s:(i + 1) * s].copy())
        return t.requires_grad_() if grad else t

    def attention(name, fn, keys="qkv", do="do"):
        q, k, v = (chunk(data[c]) for c in keys)
        o = fn(q, k, v)
        out[name] = [o.detach()] + list(torch.autograd.grad(
            o, (q, k, v), chunk(data[do], grad=False)))

    for causal in (True, False):
        attention(f"ring_{causal}", lambda q, k, v: cp.ring_attention(
            q, k, v, mesh, causal=causal))
    if n == 2:
        attention("ulysses", lambda q, k, v: cp.ulysses_attention(
            q, k, v, mesh))
        attention("ulysses_repeat", lambda q, k, v: cp.ulysses_attention(
            q, k, v, mesh), keys=("q6", "k3", "v3"), do="do6")
        q = chunk(data["q6"])[:, :, :3]
        try:
            cp.ulysses_attention(q, q, q, mesh)
        except ValueError as e:
            out["indivisible"] = str(e)

    # the "sequence" trainer
    cfg = llama.llama_tiny(dtype=torch.float32, remat="off")
    batches = np.load(f"{work}/batches.npz")
    for name, (spec, kind) in runs.items():
        m = create_mesh(list(spec), device="cpu")
        model = llama.Llama(cfg, device="cpu")
        model.load_state_dict(torch.load(f"{work}/start.pt"))
        t = make_trainer_for_llama(
            cfg, device="cpu", strategy="sequence", mesh=m,
            attn_fn=(None if kind == "ring"
                     else cp.make_context_parallel_attn(m, kind)),
            optimizer=adamw(1e-3, b1=0.9, b2=0.95))
        t.init(model=model)

        def mb(s):
            return t.shard_batch(t.microbatch(t.split_batch(
                (batches["tokens"][s], batches["targets"][s]))))

        res = {}
        if name == "save":
            # the loss on the global batch: with the rank's RoPE offset,
            # and without it
            with torch.no_grad():
                first = tuple(x[0] for x in mb(0))
                res["loss"] = all_reduce_(t._mean_loss(first),
                                          dist.group.WORLD).item()
                shard, t.model.seq_shard = t.model.seq_shard, None
                res["loss_no_offset"] = all_reduce_(
                    t._mean_loss(first), dist.group.WORLD).item()
                t.model.seq_shard = shard
        res["losses"] = [t.train_step(mb(s)).item()
                         for s in range(save_step if name == "save"
                                        else steps)]
        res["params"] = {k: p.clone() for k, p in
                         t.gathered_params().items()}
        if name == "save":
            from dlrover_tpu_torch.trainer.checkpoint import (
                FlashCheckpointer)

            ckpt = FlashCheckpointer(f"{work}/store",
                                     ram_dir=f"{work}/ram{env.rank}",
                                     persist_interval=save_step,
                                     commit_timeout=20)
            ckpt.save(save_step, {**t.train_state(), "step": save_step,
                                  "data": ""})
            ckpt.close()  # persisted, and committed by rank 0
        out[name] = res
    torch.save(out, f"{work}/rank{env.rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
""")


def _attn_inputs():
    c = ATTN
    rng = np.random.default_rng(31)

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    b, s, h, kvh, d = (c[x] for x in ("b", "s", "h", "kvh", "d"))
    return {"q": rand(b, s, h, d), "k": rand(b, s, kvh, d),
            "v": rand(b, s, kvh, d), "do": rand(b, s, h, d),
            "q6": rand(b, s, 6, d), "k3": rand(b, s, 3, d),
            "v3": rand(b, s, 3, d), "do6": rand(b, s, 6, d)}


def _batches():
    cfg = llama.llama_tiny()
    return [_batch(cfg, b=4, s=32, seed=900 + i) for i in range(STEPS)]


def _jax_cfg():
    return jax_llama.llama_tiny(dtype=np.float32, remat="off")


def _jax_mesh(spec):
    n = int(np.prod([k for _, k in spec]))
    return JaxMesh(np.asarray(jax.devices()[:n]).reshape(
        [k for _, k in spec]), tuple(a for a, _ in spec))


def _spawn(work, n, runs):
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(work), repr(runs), str(STEPS),
         str(SAVE_STEP)],
        env={**os.environ, "PYTHONPATH": REPO,
             "DLROVER_TPU_COORDINATOR_ADDR": f"localhost:{port}",
             "DLROVER_TPU_PROCESS_ID": str(rank),
             "DLROVER_TPU_NUM_PROCESSES": str(n),
             "DLROVER_TPU_DIST_HEARTBEAT_TIMEOUT": "30",
             "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(n)]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both rank groups, started with the JAX trainers' initial weights,
    then the JAX trainers' steps while they run: {"two": (work dir,
    ranks' results), "four": (...), "jax": {run: (losses, final params
    in the port's layout)}, "start": the initial params in the port's
    layout}."""
    jcfg, cfg = _jax_cfg(), llama.llama_tiny(dtype=torch.float32,
                                             remat="off")
    fast = _FastJax("jax")
    fast.jit = functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    trainers = {}
    saved, jax_sharded.jax = jax_sharded.jax, fast
    try:
        for spec, kind in RUNS:
            mesh = _jax_mesh(spec)
            attn = (None if kind == "ring" else
                    jax_cp.make_context_parallel_attn(mesh, kind))
            trainers[spec, kind] = jax_sharded.make_trainer_for_llama(
                jcfg, mesh, strategy="sequence", attn_fn=attn,
                optimizer=optax.adamw(LR, b1=0.9, b2=0.95))
    finally:
        jax_sharded.jax = saved
    first = trainers[RUNS[0]].init(jax.random.key(0))
    start = jax.tree.map(np.array, first[0])
    batches = _batches()
    dirs, procs = {}, {}
    for name, n, runs in (
            ("two", 2, {"save": ((("seq", 2),), "ring")}),
            ("four", 4, {f"run{j}": r for j, r in enumerate(RUNS)})):
        work = dirs[name] = tmp_path_factory.mktemp(f"cp{n}")
        np.savez(work / "attn.npz", **_attn_inputs())
        np.savez(work / "batches.npz",
                 tokens=np.stack([b[0] for b in batches]).astype(np.int64),
                 targets=np.stack([b[1] for b in batches]).astype(np.int64))
        torch.save(llama.params_from_jax(start, cfg, device="cpu"
                                         ).state_dict(), work / "start.pt")
        procs[name] = _spawn(work, n, runs)

    def steps(run):
        t = trainers[run]
        params, opt_state = (first if run == RUNS[0]
                             else t.init(jax.random.key(0)))
        losses = []
        for b in batches:
            params, opt_state, loss = t.train_step(
                params, opt_state, t.shard_batch(t.microbatch(b)))
            losses.append(float(loss))
        return losses, _as_port_layout(jax.tree.map(np.asarray, params),
                                       jcfg)

    try:
        # the JAX runs on threads (their compiles overlap), and the JAX
        # attention of the attention tests meanwhile
        with ThreadPoolExecutor(len(RUNS) + 1) as pool:
            stepped = {run: pool.submit(steps, run) for run in RUNS}
            attention = pool.submit(lambda: [
                _jax_attention(kind, sp, causal, repeat)
                for kind, sp, causal, repeat in (
                    ("ring", 2, True, False), ("ring", 2, False, False),
                    ("ring", 4, True, False), ("ring", 4, False, False),
                    ("ulysses", 2, True, False), ("ulysses", 2, True, True))])
            out = {"jax": {run: f.result() for run, f in stepped.items()},
                   "start": _as_port_layout(start, jcfg)}
            attention.result()
        for name, ps in procs.items():
            logs = [p.communicate(timeout=120)[0] for p in ps]
            assert [p.returncode for p in ps] == [0] * len(ps), \
                logs[0][-3000:]
            out[name] = (dirs[name], [torch.load(dirs[name] / f"rank{r}.pt")
                                      for r in range(len(ps))])
        return out
    finally:
        for p in (p for ps in procs.values() for p in ps):
            if p.poll() is None:
                p.kill()


@functools.lru_cache(maxsize=None)
def _jax_attention(kind: str, sp: int, causal: bool, repeat: bool):
    """JAX's ring or Ulysses attention on (seq sp): (out, dq, dk, dv) of
    sum(out * do)."""
    a = _attn_inputs()
    q, k, v, do = ((a["q6"], a["k3"], a["v3"], a["do6"]) if repeat
                   else (a["q"], a["k"], a["v"], a["do"]))
    mesh = _jax_mesh((("seq", sp),))
    fn = jax_cp.ring_attention if kind == "ring" else jax_cp.ulysses_attention

    def loss(q, k, v):
        o = fn(q, k, v, mesh, causal=causal)
        return jnp.sum(o * do), o

    grads, o = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True),
                       compiler_options=FAST_COMPILE)(q, k, v)
    return [np.asarray(x) for x in (o,) + tuple(grads)]


def _joined(ranks, name):
    """The ranks' chunks of (out, dq, dk, dv), joined along the seq."""
    return [torch.cat([r[name][j] for r in ranks], dim=1).numpy()
            for j in range(4)]


def _close(got, want):
    for j, (g, w) in enumerate(zip(got, want)):
        tol = 2e-3 if j == 0 else 5e-3
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                   err_msg=("out", "dq", "dk", "dv")[j])


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(groups, sp, causal):
    ranks = groups["two" if sp == 2 else "four"][1]
    got = _joined(ranks, f"ring_{causal}")
    _close(got, _jax_attention("ring", sp, causal, False))
    # the plain path of the ring Function against mha_reference whole
    a = {k: torch.from_numpy(v).requires_grad_()
         for k, v in _attn_inputs().items()}
    o = mha_reference(a["q"], a["k"], a["v"], causal=causal)
    grads = torch.autograd.grad(o, (a["q"], a["k"], a["v"]),
                                a["do"].detach())
    _close(got, [x.detach().numpy() for x in (o,) + grads])


def test_ulysses_matches_jax(groups):
    """At sp 2: 4 heads over 2 kv heads (split as they are), 6 over 3
    (repeated first: 3 kv heads do not split two ways), and 3 heads,
    which do not split, raise as JAX's do."""
    ranks = groups["two"][1]
    _close(_joined(ranks, "ulysses"),
           _jax_attention("ulysses", 2, True, False))
    _close(_joined(ranks, "ulysses_repeat"),
           _jax_attention("ulysses", 2, True, True))
    for r in ranks:
        assert "must divide by seq-parallel size 2" in r["indivisible"]


def test_rope_offset(groups):
    """The "sequence" trainer's loss on the global batch at (seq 2)
    equals JAX's; with the rank's chunk offset dropped from its RoPE
    tables it does not."""
    ranks = groups["two"][1]
    jcfg = _jax_cfg()
    tokens, targets = _batches()[0]
    params = jax_llama.init_params(jax.random.key(0), jcfg)
    want = float(jax.jit(functools.partial(
        jax_llama.next_token_loss, cfg=jcfg), compiler_options=FAST_COMPILE)(
        params, (tokens, targets)))
    for r in ranks:
        assert r["save"]["loss"] == pytest.approx(want, rel=2e-3)
        assert r["save"]["loss_no_offset"] != pytest.approx(want, rel=2e-3)


@pytest.mark.parametrize("run", RUNS, ids=[
    f"{kind}-{'x'.join(f'{a}{k}' for a, k in spec)}"
    for spec, kind in RUNS])
def test_sequence_trainer_matches_jax(groups, run):
    ranks = groups["four"][1]
    name = f"run{RUNS.index(run)}"
    jax_losses, want = groups["jax"][run]
    for r in ranks:
        assert r[name]["losses"][0] == pytest.approx(jax_losses[0],
                                                     rel=1e-5)
        assert r[name]["losses"] == pytest.approx(jax_losses, rel=1e-4)
    got = {k: v.numpy() for k, v in ranks[0][name]["params"].items()}
    _assert_adam_close(got, want, groups["start"], lr=LR)
    for r in ranks[1:]:  # every rank gathers the same parameters
        assert all(torch.equal(r[name]["params"][k],
                               ranks[0][name]["params"][k]) for k in got)


def test_sequence_save_restores_whole_into_one_rank(groups, tmp_path):
    """The (seq 2) save of step 2: every box replicated over seq, owned
    by one rank, restored whole into one rank bitwise."""
    work, ranks = groups["two"]
    store = ckpt_store.get_store(str(work / "store"))
    assert ckpt_store.committed_steps(store) == [SAVE_STEP]
    man = ckpt_store.step_manifest(store, SAVE_STEP)
    for leaf in man["leaves"]:
        for d in leaf.get("domains", []):
            assert d["replicas"] == [0, 1] and d["owner"] in (0, 1)
    trainer = make_trainer_for_llama(
        llama.llama_tiny(dtype=torch.float32, remat="off"), device="cpu",
        strategy="sequence", optimizer=adamw(LR, b1=0.9, b2=0.95))
    trainer.init(seed=5)
    solo = FlashCheckpointer(str(work / "store"),
                             ram_dir=str(tmp_path / "ram-solo"))
    got, step = solo.restore(
        target={**trainer.train_state(), "step": 0, "data": ""})
    solo.close()
    assert step == SAVE_STEP
    trainer.load_train_state(got)
    for name, p in trainer.gathered_params().items():
        assert torch.equal(p, ranks[0]["save"]["params"][name]), name
