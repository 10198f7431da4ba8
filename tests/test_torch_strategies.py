"""Each sharding strategy of the port against the JAX ``ShardedTrainer``
of the same strategy on a CPU mesh of the same shape: llama_tiny in
fp32, three adamw steps on the same seeded global batches from the
same starting weights (the JAX tree drawn with numpy from a seed,
carried over with ``params_from_jax`` and sharded by the port). Gloo CPU ranks (spawned once per rank count, every case in
the same processes) hold the losses and the gathered parameters to the
tolerances of test_torch_trainer.py::_assert_adam_close, every rank
ends with the same gathered parameters, and each rank keeps the bytes
its layout says: half the parameters under fsdp and tp at two ranks,
half the optimizer state under the ZeRO strategies and fsdp.

Cases: zero1, zero2 (also at two microbatches), fsdp and tp at two
ranks, tp_fsdp at four (fsdp 2 x tensor 2), all under adamw; and zero1
under the guarded ``bf16_adamw`` (fp32 masters and its moments the
ZeRO slices, the guard's norm the global one) against JAX's
``bf16_adamw``. "pipeline" on (pipe 2) with GPipe and with two chunks a
stage, and on (pipe 2, tensor 2) at four ranks, on llama_tiny cut to
4 layers: each rank holds its stage's blocks only, the replicated
leaves (embed, final norm, head) are equal to the bit on both stages,
and the gathered blocks of the stages together are held to the JAX
trainer's. An MoE "pipeline" case (llama_moe_tiny on (pipe 2)) gates
per pipeline microbatch, as ``pipeline_llama_forward`` does, where the
JAX trainer gates on the whole batch: it is held against a JAX
``ShardedTrainer`` whose loss is ``pipeline_llama_forward(...,
return_aux=True)``'s logits' cross entropy plus the aux. The two ranks
then run test_torch_ckpt_sharded.py's fsdp and pipeline saves and
restores and test_torch_rowwise.py's rowwise cases (``rank_groups``
starts the groups once for the three modules).

The other families and planned tables on the mesh: GPT (gpt_tiny, fp32)
under fsdp and zero1 on (fsdp 2), tp_fsdp on (fsdp 2, tensor 2) (the JAX
``test_gpt.py`` set), and tp on (tensor 2) at a vocab of 257, which
splits unevenly (129 and 128 rows); the CNN under fsdp
on (fsdp 2), its fc dims gathered before use; two planned tables
registered in ``sharding.STRATEGIES`` on both sides, the planner's
``{'batch': ('fsdp',), 'mlp': 'fsdp'}`` on (fsdp 2) and ``{'batch':
None, 'layers': 'tensor'}`` on (tensor 2), under which each rank owns
its layers whole. Each against the JAX trainer of the same table and
mesh shape, but the uneven tp case: JAX's ``jit`` refuses a sharded dim
that does not divide, so the port's two ranks are held to the JAX
trainer on one device there. The two ranks then run
``auto_accelerate(dryrun_top_k=2)`` with a planted per-rank skew in the
measured times: rank 1 measures the two candidates slower and in the
opposite order, and both ranks must still hold the same strategy and the
same agreed seconds; and a search whose tp candidate cannot split 5
heads over 2 ranks, which both ranks report unfit. The four ranks build
a table that shards one dim over two mesh axes, which must raise."""

import contextlib
import dataclasses
import functools
import multiprocessing
import os
import socket
import subprocess
import sys
import textwrap
import types
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from dlrover_tpu.models import cnn as jax_cnn
from dlrover_tpu.models import gpt as jax_gpt
from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.optim import bf16 as jax_bf16
from dlrover_tpu.parallel import sharding as jax_shd
from dlrover_tpu.parallel import pipeline as jax_pipeline
from dlrover_tpu.trainer import sharded as jax_sharded
from dlrover_tpu.trainer.sharded import (
    make_trainer_for_llama as jax_make_trainer,
)
from dlrover_tpu_torch.models import cnn, gpt, llama

from tests.test_torch_ddp import _as_jax_microbatches
from tests.test_torch_gpt import FAST_COMPILE
from tests.test_torch_llama import _batch
from tests.test_torch_trainer import _assert_adam_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
STEPS = 3
#: (strategy, mesh, accum, optimizer[, model and schedule]) by rank
#: count; the last, as (key, value) pairs: "layers" cuts llama_tiny to
#: that depth, "moe" takes llama_moe_tiny, "num_microbatches" and
#: "num_chunks" set the pipeline's schedule, "family" takes gpt_tiny or
#: mnist_cnn ("vocab_size" resizes gpt_tiny's), "rules" registers the
#: planned table under the strategy's name, "jax_spec" is the JAX
#: trainer's mesh where it differs (JAX's jit refuses a sharded dim that
#: does not divide, so vocab 257 under tp is held to one JAX device)
CASES = {
    2: [("zero1", (("fsdp", 2),), 1, "adamw"),
        ("zero2", (("fsdp", 2),), 1, "adamw"),
        ("zero2", (("fsdp", 2),), 2, "adamw"),
        ("fsdp", (("fsdp", 2),), 1, "adamw"),
        ("tp", (("tensor", 2),), 1, "adamw"),
        ("zero1", (("fsdp", 2),), 1, "bf16_adamw"),
        ("pipeline", (("pipe", 2),), 1, "adamw", (("layers", 4),)),
        ("pipeline", (("pipe", 2),), 1, "adamw",
         (("layers", 4), ("num_chunks", 2))),
        ("pipeline", (("pipe", 2),), 1, "adamw",
         (("moe", True), ("num_microbatches", 2))),
        ("fsdp", (("fsdp", 2),), 1, "adamw", (("family", "gpt"),)),
        ("zero1", (("fsdp", 2),), 1, "adamw", (("family", "gpt"),)),
        ("tp", (("tensor", 2),), 1, "adamw",
         (("family", "gpt"), ("vocab_size", 257),
          ("jax_spec", (("tensor", 1),)))),
        ("fsdp", (("fsdp", 2),), 1, "adamw", (("family", "cnn"),)),
        ("planned_mlp", (("fsdp", 2),), 1, "adamw",
         (("rules", (("batch", ("fsdp",)), ("mlp", "fsdp"))),)),
        ("planned_layers", (("tensor", 2),), 1, "adamw",
         (("rules", (("batch", None), ("layers", "tensor"))),))],
    4: [("tp_fsdp", (("fsdp", 2), ("tensor", 2)), 1, "adamw"),
        ("pipeline", (("pipe", 2), ("tensor", 2)), 1, "adamw",
         (("layers", 4),)),
        ("tp_fsdp", (("fsdp", 2), ("tensor", 2)), 1, "adamw",
         (("family", "gpt"),))],
}
#: optimizer state bytes per fp32 parameter byte: two fp32 moments;
#: an fp32 master, a bf16 mu and an fp32 nu
STATE_PER_BYTE = {"adamw": 2, "bf16_adamw": 2.5}
ALL = [(n, c) for n in CASES for c in CASES[n]]
#: worker processes of the JAX side
JAX_WORKERS = 6

_RANK = textwrap.dedent("""
    import dataclasses, sys, numpy as np, torch
    import torch.distributed as dist
    from dlrover_tpu_torch.models import cnn, gpt, llama, make_trainer_for
    from dlrover_tpu_torch.parallel import sharding as shd
    from dlrover_tpu_torch.parallel.mesh import create_mesh
    from dlrover_tpu_torch.trainer.distributed import init_from_env
    from dlrover_tpu_torch.optim import bf16_adamw
    from dlrover_tpu_torch.trainer.sharded import (
        adamw, make_trainer_for_llama)
    work, cases = sys.argv[1], eval(sys.argv[2])
    torch.set_num_threads(1)  # the ranks and the JAX runs share the cores
    env = init_from_env(timeout_s=60, device="cpu")
    data = np.load(f"{work}/batches.npz")
    out = {}
    for i, (strategy, spec, accum, opt, *kw) in enumerate(cases):
        kw = dict(kw[0]) if kw else {}
        if "rules" in kw:
            shd.STRATEGIES[strategy] = lambda r=dict(kw["rules"]): dict(r)
        optimizer = {"adamw": adamw, "bf16_adamw": lambda *a, **k:
                     bf16_adamw(*a, guard_nonfinite=True, **k)}[opt](
            1e-3, b1=0.9, b2=0.95)
        mesh = create_mesh(list(spec), device="cpu")
        family = kw.get("family", "llama")
        if family == "llama":
            cfg = (llama.llama_moe_tiny if kw.get("moe")
                   else llama.llama_tiny)(
                dtype=torch.float32, remat="off",
                num_layers=kw.get("layers", 2))
            model = llama.Llama(cfg, device="cpu")
            trainer = make_trainer_for_llama(
                cfg, device="cpu", strategy=strategy, accum_steps=accum,
                mesh=mesh, num_microbatches=kw.get("num_microbatches", 4),
                num_chunks=kw.get("num_chunks", 1), optimizer=optimizer)
        else:
            if family == "gpt":
                cfg = dataclasses.replace(
                    gpt.gpt_tiny(dtype=torch.float32),
                    vocab_size=kw.get("vocab_size", 256))
                model = gpt.GPT(cfg, device="cpu")
            else:
                cfg = cnn.mnist_cnn()
                model = cnn.CNN(cfg, device="cpu")
            trainer = make_trainer_for(
                cfg, device="cpu", strategy=strategy, accum_steps=accum,
                mesh=mesh, optimizer=optimizer)
        model.load_state_dict(torch.load(f"{work}/start{i}.pt"))
        trainer.init(model=model)
        losses = []
        for s in range(len(data[f"tokens{i}"])):
            batch = trainer.split_batch(
                (data[f"tokens{i}"][s], data[f"targets{i}"][s]))
            losses.append(trainer.train_step(trainer.shard_batch(
                trainer.microbatch(batch))).item())
        out[i] = {"losses": losses, "bytes": trainer.state_bytes(),
                  "params": {n: p.clone() for n, p in
                             trainer.gathered_params().items()}}
    torch.save(out, f"{work}/rank{env.rank}.pt")
""")
_END = "dist.barrier()\ndist.destroy_process_group()\n"
#: run by the two ranks after their cases: ``auto_accelerate`` with
#: real dryruns of the top 2 and a planted skew on each measured time --
#: rank 0 adds 1 s to the first candidate and 2 s to the second, rank 1
#: 3 s and 2 s -- so that, left to itself, each rank would pick another
#: winner; then one step of the winner
_AUTO_JOB = textwrap.dedent("""
    def auto_job(work, rank):
        from dlrover_tpu_torch.auto import accelerate
        real, local = accelerate._measure, []

        def skewed(cfg, s, *a, **kw):
            seconds = real(cfg, s, *a, **kw) + (
                (1.0, 2.0) if rank == 0 else (3.0, 2.0))[len(local)]
            local.append((s.to_json(), seconds))
            return seconds

        accelerate._measure = skewed
        cfg = llama.llama_tiny()
        try:
            res = accelerate.auto_accelerate(cfg, 8, 32, device="cpu",
                                             dryrun_top_k=2, hbm_bytes=16e9)
        finally:
            accelerate._measure = real
        t = res.trainer
        t.init(seed=0)
        x = np.random.default_rng(3).integers(0, cfg.vocab_size, (8, 33))
        loss = t.train_step(t.shard_batch(t.microbatch(t.split_batch(
            (x[:, :-1], x[:, 1:]))))).item()
        torch.save({"strategy": res.strategy.to_json(), "local": local,
                    "loss": loss,
                    "agreed": [(r.strategy.to_json(), r.measured_step_seconds)
                               for r in res.reports
                               if r.measured_step_seconds is not None]},
                   f"{work}/auto_rank{rank}.pt")

    auto_job(work, env.rank)

    def unfit_job(work, rank):
        # 5 heads do not split over tensor 2: the tp candidate's dryrun
        # fails on both ranks, its report carries the reason, ddp wins
        from dlrover_tpu_torch.auto import accelerate, strategy
        cfg = dataclasses.replace(gpt.gpt_tiny(), hidden_size=80,
                                  num_heads=5)
        cands = [strategy.Strategy(mesh_spec=(("tensor", 2),),
                                   sharding="tp"),
                 strategy.Strategy(mesh_spec=(("data", 2),),
                                   sharding="ddp")]
        res = accelerate.auto_accelerate(cfg, 4, 16, device="cpu",
                                         strategies=cands, dryrun_top_k=2,
                                         hbm_bytes=16e9)
        torch.save({"strategy": res.strategy.to_json(),
                    "errors": [(r.strategy.to_json(), r.fits, r.error)
                               for r in res.reports]},
                   f"{work}/unfit_rank{rank}.pt")

    unfit_job(work, env.rank)
""")
#: run by the four ranks after their cases: a table that shards one dim
#: over two mesh axes, which the step can neither hold nor gather
_NEITHER_JOB = textwrap.dedent("""
    shd.STRATEGIES["neither"] = lambda: {"batch": ("fsdp",),
                                         "embed": ("fsdp", "tensor")}
    try:
        t = make_trainer_for_llama(
            llama.llama_tiny(), device="cpu", strategy="neither",
            mesh=create_mesh([("fsdp", 2), ("tensor", 2)], device="cpu"))
        t.init(seed=0)
        neither = None
    except NotImplementedError as e:
        neither = str(e)
    torch.save(neither, f"{work}/neither_rank{env.rank}.pt")
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp(spec) -> int:
    return int(np.prod([k for a, k in spec if a in ("data", "fsdp")]))


def _family(kw, jax_side=False):
    """The model module of a case: the port's, or the JAX package's."""
    name = dict(kw).get("family", "llama")
    return ({"llama": jax_llama, "gpt": jax_gpt, "cnn": jax_cnn}
            if jax_side else {"llama": llama, "gpt": gpt, "cnn": cnn})[name]


def _cfg(kw, jax_side=False):
    """A case's llama_tiny (or llama_moe_tiny), gpt_tiny or mnist_cnn,
    fp32, remat off."""
    kw = dict(kw)
    lib, dtype = (jax_llama, np.float32) if jax_side else (llama,
                                                          torch.float32)
    if kw.get("family") == "gpt":
        lib = jax_gpt if jax_side else gpt
        return dataclasses.replace(lib.gpt_tiny(dtype=dtype),
                                   vocab_size=kw.get("vocab_size", 256))
    if kw.get("family") == "cnn":
        return (jax_cnn if jax_side else cnn).mnist_cnn()
    make = lib.llama_moe_tiny if kw.get("moe") else lib.llama_tiny
    return make(dtype=dtype, remat="off", num_layers=kw.get("layers", 2))


def _batches(spec, accum, kw=()):
    """Each step's global batch in the order the ranks' microbatches make
    the JAX step's (for the port), and as the JAX step takes it: token
    pairs, or the CNN's (images, labels)."""
    cfg = llama.llama_tiny()
    port, jax_order = [], []
    for i in range(STEPS):
        if dict(kw).get("family") == "cnn":
            rng = np.random.default_rng(500 + i)
            batch = (rng.standard_normal((4, 28, 28, 1)).astype(np.float32),
                     rng.integers(0, 10, 4).astype(np.int32))
        else:
            batch = _batch(cfg, b=4, s=32, seed=500 + i, masked=False)
        port.append(batch)
        jax_order.append(_as_jax_microbatches(batch, accum, _dp(spec)))
    return port, jax_order


_JAX_OPTIMIZERS = {
    "adamw": optax.adamw,
    "bf16_adamw": lambda *a, **k: jax_bf16.bf16_adamw(
        *a, guard_nonfinite=True, **k)}


class _FastJax(types.ModuleType):
    """``jax`` for the JAX trainer's module, whose ``jit`` compiles with
    XLA's cheap codegen (test_torch_gpt.py's FAST_COMPILE)."""

    def __getattr__(self, name):
        return getattr(jax, name)


def _pipelined_moe_trainer(jcfg, mesh, optimizer, num_microbatches):
    """A JAX trainer under "pipeline" whose loss runs
    ``pipeline_llama_forward`` (its MoE gating per pipeline microbatch):
    the cross entropy of its logits plus its aux."""
    def loss(params, batch):
        tokens, targets = batch
        logits, aux = jax_pipeline.pipeline_llama_forward(
            params, tokens, jcfg, mesh, num_microbatches=num_microbatches,
            return_aux=True)
        nll, cnt = jax_llama._masked_nll(logits, targets)
        return nll / jnp.maximum(cnt, 1.0) + aux

    return jax_sharded.ShardedTrainer(
        loss, lambda rng: jax_llama.init_params(rng, jcfg),
        jax_llama.param_axes(jcfg), mesh, strategy="pipeline",
        optimizer=optimizer)


def _np_start(jcfg, seed=0, mod=jax_llama):
    """Starting weights of the JAX parameter tree of ``jcfg`` (a model of
    ``mod``), drawn with numpy from ``seed``: norms and LayerNorm scales
    1, vectors (biases) and the embeddings N(0, 0.02), the other
    matrices N(0, 1/fan_in)."""
    shapes = jax.eval_shape(lambda key: mod.init_params(key, jcfg),
                            jax.random.key(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "norm" in name or "scale" in name:
            return np.ones(leaf.shape, np.float32)
        small = (name in ("['embed']", "['pos_embed']")
                 or len(leaf.shape) == 1 or (
                     name.startswith("['blocks']") and len(leaf.shape) == 2))
        std = 0.02 if small else leaf.shape[-2] ** -0.5
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_trainer(strategy, spec, accum, opt, kw=None):
    """The JAX trainer of a case, its step built."""
    kw = dict(kw or ())
    jcfg = _cfg(kw, jax_side=True)
    spec = kw.get("jax_spec", spec)
    n = int(np.prod([k for _, k in spec]))
    mesh = JaxMesh(np.asarray(jax.devices()[:n]).reshape(
        [k for _, k in spec]), tuple(a for a, _ in spec))
    optimizer = _JAX_OPTIMIZERS[opt](LR, b1=0.9, b2=0.95)
    if "rules" in kw:
        jax_shd.STRATEGIES[strategy] = lambda r=dict(kw["rules"]): dict(r)
    if kw.get("moe"):
        jtrainer = _pipelined_moe_trainer(jcfg, mesh, optimizer,
                                          kw["num_microbatches"])
    elif kw.get("family"):
        jtrainer = _family(kw, jax_side=True).make_trainer(
            jcfg, mesh, strategy=strategy, accum_steps=accum,
            optimizer=optimizer)
    else:
        jtrainer = jax_make_trainer(jcfg, mesh, strategy=strategy,
                                    accum_steps=accum, optimizer=optimizer)
    _ = jtrainer.train_step  # builds its jit now, with the cheap codegen
    return jtrainer


@contextlib.contextmanager
def _cheap_codegen():
    """The JAX trainers' ``jit`` compiles with XLA's cheap codegen
    (test_torch_gpt.py's FAST_COMPILE) while the block runs."""
    fast = _FastJax("jax")
    fast.jit = functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    saved, jax_sharded.jax = jax_sharded.jax, fast
    try:
        yield
    finally:
        jax_sharded.jax = saved


def _jax_run(case, start):
    """The JAX side of ``case`` (run in a worker process, whose JAX
    trainer compiles with XLA's cheap codegen): the trainer from the
    numpy weights ``start``, three steps: (losses, final params in the
    port's layout)."""
    with _cheap_codegen():
        jtrainer = _jax_trainer(*case)
    # jit, not device_put: GSPMD pads a dim that does not divide (vocab
    # 257 over tensor 2), which device_put refuses
    params = jax.jit(lambda tree: tree,
                     out_shardings=jtrainer.param_shardings)(start)
    opt_state = jax.jit(jtrainer.optimizer.init,
                        out_shardings=jtrainer.opt_shardings)(params)
    return _jax_steps(case[1], case[2], jtrainer, (params, opt_state),
                      *case[4:])


def _jax_steps(spec, accum, jtrainer, state, kw=None):
    params, opt_state = state
    losses = []
    for batch in _batches(spec, accum, kw or ())[1]:
        params, opt_state, loss = jtrainer.train_step(
            params, opt_state,
            jtrainer.shard_batch(jtrainer.microbatch(batch)))
        losses.append(float(loss))
    return losses, _port_view(jax.tree.map(np.asarray, params),
                              _cfg(kw or ()))


def _port_view(tree, cfg):
    """{port parameter name: its box of the JAX tree, in the port's
    layout} (``jax_coordinates``)."""
    from dlrover_tpu_torch.models import model_module_for

    mod = model_module_for(cfg)
    out = {}
    for name in mod.param_axes(cfg):
        leaf = mod.jax_coordinates(cfg, name)
        arr = tree
        for k in leaf.path:
            arr = arr[k]
        arr = np.asarray(arr)
        if leaf.layer is not None:
            arr = arr[leaf.layer:leaf.layer + 1]
        out[name] = leaf.from_jax(torch.from_numpy(np.array(arr))).numpy()
    return out


def _spawn(tmp, n, cases, job=""):
    """The ``n`` ranks of ``cases``; ``job``: code they run after them."""
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, "-c", _RANK + job + _END, str(tmp), repr(cases)],
        env={**os.environ, "PYTHONPATH": REPO,
             "DLROVER_TPU_COORDINATOR_ADDR": f"localhost:{port}",
             "DLROVER_TPU_PROCESS_ID": str(rank),
             "DLROVER_TPU_NUM_PROCESSES": str(n),
             "DLROVER_TPU_DIST_HEARTBEAT_TIMEOUT": "30",
             "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(n)]


def _jax_case(case):
    """The JAX side of a case: the JAX trainer under "pipeline" runs no
    schedule, so the port's GPipe and interleaved cases share one."""
    if len(case) < 5:
        return case
    return case[:4] + (tuple((k, v) for k, v in case[4]
                             if k != "num_chunks"),)


def _start(tmp_path_factory):
    """Each case's starting weights (numpy, from a seed) in the port's
    layout and its batches written for the ranks, the ranks started, and
    the JAX cases started in JAX_WORKERS worker processes beside them
    (tracing holds one process's interpreter; XLA's compiles of several
    processes overlap). The two ranks also run
    test_torch_ckpt_sharded.py's and test_torch_rowwise.py's jobs after
    their cases."""
    from tests import test_torch_ckpt_sharded as ckpt
    from tests import test_torch_rowwise as rowwise

    jax_cases = list(dict.fromkeys(_jax_case(c) for _, c in ALL))
    start_of = {c: _np_start(_cfg(c[4] if len(c) > 4 else (),
                                  jax_side=True),
                             mod=_family(c[4] if len(c) > 4 else (),
                                         jax_side=True))
                for c in jax_cases}
    pool = ProcessPoolExecutor(
        JAX_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    # the longest first: the pipelined MoE step's compile
    stepped = {c: pool.submit(_jax_run, c, start_of[c])
               for c in sorted(jax_cases, key=lambda c: "moe" not in str(c))}
    pool.shutdown(wait=False)
    starts, procs, dirs = {}, {}, {}
    for n, cases in CASES.items():
        tmp = dirs[n] = tmp_path_factory.mktemp(f"strategies{n}")
        arrays = {}
        for i, (_, spec, accum, _, *kw) in enumerate(cases):
            start = start_of[_jax_case(cases[i])]
            kw = kw[0] if kw else ()
            model = _family(kw).params_from_jax(start, _cfg(kw),
                                                device="cpu")
            torch.save(model.state_dict(), tmp / f"start{i}.pt")
            port = _batches(spec, accum, kw)[0]
            for j, leaf in enumerate(("tokens", "targets")):
                arrays[f"{leaf}{i}"] = np.stack([b[j] for b in port])
                if arrays[f"{leaf}{i}"].dtype.kind == "i":
                    arrays[f"{leaf}{i}"] = arrays[f"{leaf}{i}"].astype(
                        np.int64)
            starts[n, cases[i]] = {
                k: v.detach().numpy().copy()
                for k, v in model.named_parameters()}
        np.savez(tmp / "batches.npz", **arrays)
        job = (ckpt.rank_job(tmp) + rowwise.rank_job(tmp) + _AUTO_JOB
               if n == 2 else _NEITHER_JOB)
        procs[n] = _spawn(tmp, n, cases, job)
    return {"stepped": stepped, "starts": starts, "procs": procs,
            "dirs": dirs}


def _finish(stepped, starts, procs, dirs):
    """{(n, case): (start params in the port's layout, the JAX losses,
    the JAX final params, [each rank's run])}."""
    try:
        out = {}
        for n, ps in procs.items():
            logs = [p.communicate(timeout=120)[0] for p in ps]
            assert [p.returncode for p in ps] == [0] * n, logs[0][-3000:]
            ranks = [torch.load(dirs[n] / f"rank{r}.pt") for r in range(n)]
            for i, case in enumerate(CASES[n]):
                out[n, case] = (starts[n, case],
                                *stepped[_jax_case(case)].result(
                                    timeout=120),
                                [r[i] for r in ranks])
        return out
    finally:
        for p in (p for ps in procs.values() for p in ps):
            if p.poll() is None:
                p.kill()


#: the session's rank groups, shared with test_torch_ckpt_sharded.py
_GROUPS = {}


def rank_groups(tmp_path_factory, wait=True):
    """The rank groups, started once for the session: ``"dirs"``, each
    group's work directory by rank count, and with ``wait`` ``"runs"``,
    the cases' results (:func:`_finish`)."""
    if "started" not in _GROUPS:
        _GROUPS["started"] = _start(tmp_path_factory)
    if wait and "runs" not in _GROUPS:
        _GROUPS["runs"] = _finish(**_GROUPS["started"])
    return {"dirs": _GROUPS["started"]["dirs"], "runs": _GROUPS.get("runs")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return rank_groups(tmp_path_factory)["runs"]


@pytest.mark.parametrize("n,case", ALL, ids=[
    f"{c[0]}-accum{c[2]}-{'x'.join(f'{a}{k}' for a, k in c[1])}"
    + ("" if c[3] == "adamw" else f"-{c[3]}")
    + "".join(f"-{k}{v}" for k, v in (c[4] if len(c) > 4 else ())
              if k not in ("rules", "jax_spec"))
    for _, c in ALL])
def test_strategy_matches_the_jax_sharded_trainer(runs, n, case):
    start, jax_losses, want, ranks = runs[n, case]
    for run in ranks:
        assert run["losses"][0] == pytest.approx(jax_losses[0], rel=1e-5)
        assert run["losses"] == pytest.approx(jax_losses, rel=1e-4)
    # the ranks' gathered parameters together (each pipeline stage
    # gathers its own blocks)
    whole = {}
    for run in ranks:
        for k, v in run["params"].items():
            whole.setdefault(k, v)
    got = {k: v.numpy() for k, v in whole.items()}
    _assert_adam_close(got, want, start, lr=LR)
    for run in ranks:  # every rank gathers the same parameters
        assert all(torch.equal(v, whole[k]) for k, v in run["params"].items())
    if case[0] == "pipeline":  # a block on its stage's ranks only
        for k in got:
            held = [k in run["params"] for run in ranks]
            assert all(held) if not k.startswith("blocks.") else (
                sum(held) == len(ranks) // 2), k


def test_bytes_per_rank_follow_the_layout(runs):
    """Parameters halve under fsdp and tp at two ranks (the norms, tiny,
    stay whole under fsdp); the optimizer state halves under zero1,
    zero2 and fsdp; tp_fsdp at 2 x 2 keeps a quarter. bf16_adamw keeps
    10 bytes a parameter where AdamW keeps 8."""
    for (n, (strategy, spec, _, opt_name, *kw)), (*_, ranks) in \
            runs.items():
        if kw and ("family" in dict(kw[0]) or "rules" in dict(kw[0])):
            continue  # the other families' and planned tables' below
        cfg = _cfg(kw[0] if kw else ())
        whole = 4 * llama.param_count(cfg)
        norms = 4 * cfg.hidden_size * (2 * cfg.num_layers + 1)
        if strategy == "pipeline":
            # a stage's blocks (half), embed, final norm and head whole;
            # under tensor 2 every matrix's half
            layer = (whole - 4 * (2 * cfg.vocab_size + 1) * cfg.hidden_size
                     ) // cfg.num_layers
            tp = dict(spec).get("tensor", 1)
            layer_norms = 4 * 2 * cfg.hidden_size
            held = (cfg.num_layers // 2 * (
                (layer - layer_norms) // tp + layer_norms)
                + 4 * 2 * cfg.vocab_size * cfg.hidden_size // tp
                + 4 * cfg.hidden_size)
            for run in ranks:
                assert run["bytes"]["params"] == held
                assert run["bytes"]["optimizer"] == 2 * held
            continue
        for run in ranks:
            params, opt = run["bytes"]["params"], run["bytes"]["optimizer"]
            sharded = {"zero1": 1, "zero2": 1, "fsdp": 2, "tp": 2,
                       "tp_fsdp": 4}[strategy]
            opt_parts = 4 if strategy == "tp_fsdp" else 2
            assert params == (whole - norms) // sharded + norms
            assert opt == STATE_PER_BYTE[opt_name] * (
                (whole - norms) // opt_parts + norms)


def test_auto_accelerate_ranks_agree_under_a_planted_skew(runs,
                                                          tmp_path_factory):
    """Each rank, by its own times, would pick another winner; the agreed
    times (the MAX over the ranks) give both the same strategy and the
    same seconds, and the winner's step the same loss."""
    work = rank_groups(tmp_path_factory)["dirs"][2]
    got = [torch.load(work / f"auto_rank{r}.pt") for r in range(2)]
    own = [min(g["local"], key=lambda sv: sv[1])[0] for g in got]
    assert own[0] != own[1]  # the skew alone would split the ranks
    assert got[0]["strategy"] == got[1]["strategy"]
    assert got[0]["agreed"] == got[1]["agreed"] and len(got[0]["agreed"]) == 2
    for name, seconds in got[0]["agreed"]:
        assert seconds == max(dict(g["local"])[name] for g in got)
    assert got[0]["strategy"] == min(got[0]["agreed"],
                                     key=lambda sv: sv[1])[0]
    assert got[0]["loss"] == got[1]["loss"]


def test_indivisible_heads_fail_the_dryrun_on_both_ranks(runs,
                                                         tmp_path_factory):
    """5 heads over tensor 2: the tp candidate's failure agreed over the
    ranks, in its report's ``error``, the reason an expected one."""
    work = rank_groups(tmp_path_factory)["dirs"][2]
    got = [torch.load(work / f"unfit_rank{r}.pt") for r in range(2)]
    assert got[0] == got[1]
    (tp, tp_fits, tp_error), (_, ddp_fits, ddp_error) = got[0]["errors"]
    assert '"tp"' in tp and not tp_fits and "do not split over" in tp_error
    assert ddp_fits and ddp_error is None
    assert '"ddp"' in got[0]["strategy"]


def test_a_dim_over_two_axes_raises_naming_its_axis(runs,
                                                   tmp_path_factory):
    """A dim sharded over two mesh axes can be neither held nor gathered:
    the trainer raises and names the logical axis."""
    work = rank_groups(tmp_path_factory)["dirs"][4]
    for r in range(4):
        err = torch.load(work / f"neither_rank{r}.pt")
        assert err and "'embed'" in err, err


def test_owned_layers_are_held_once(runs):
    """Under {'batch': None, 'layers': 'tensor'} each rank keeps one of
    llama_tiny's two layers whole, and both keep the embedding, the
    head and the final norm."""
    case = next(c for c in CASES[2] if c[0] == "planned_layers")
    *_, ranks = runs[2, case]
    cfg = _cfg(case[4])
    whole = 4 * llama.param_count(cfg)
    shared = 4 * (2 * cfg.vocab_size + 1) * cfg.hidden_size
    layer = (whole - shared) // cfg.num_layers
    for run in ranks:
        assert run["bytes"]["params"] == shared + layer
        assert run["bytes"]["optimizer"] == 2 * (shared + layer)
