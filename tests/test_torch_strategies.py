"""Each sharding strategy of the port against the JAX ``ShardedTrainer``
of the same strategy on a CPU mesh of the same shape: llama_tiny in
fp32, three adamw steps on the same seeded global batches, the JAX
starting weights carried over with ``params_from_jax`` and sharded by
the port. Gloo CPU ranks (spawned once per rank count, every case in
the same processes) hold the losses and the gathered parameters to the
tolerances of test_torch_trainer.py::_assert_adam_close, every rank
ends with the same gathered parameters, and each rank keeps the bytes
its layout says: half the parameters under fsdp and tp at two ranks,
half the optimizer state under the ZeRO strategies and fsdp.

Cases: zero1, zero2 (also at two microbatches), fsdp and tp at two
ranks, tp_fsdp at four (fsdp 2 x tensor 2). The two ranks then run
test_torch_ckpt_sharded.py's fsdp save and restore (``rank_groups``
starts the groups once for both modules)."""

import functools
import os
import socket
import subprocess
import sys
import textwrap
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.trainer import sharded as jax_sharded
from dlrover_tpu.trainer.sharded import (
    make_trainer_for_llama as jax_make_trainer,
)
from dlrover_tpu_torch.models import llama

from tests.test_torch_ddp import _as_jax_microbatches
from tests.test_torch_gpt import FAST_COMPILE
from tests.test_torch_llama import _as_port_layout, _batch
from tests.test_torch_trainer import _assert_adam_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
STEPS = 3
#: (strategy, mesh, accum) by rank count
CASES = {
    2: [("zero1", (("fsdp", 2),), 1), ("zero2", (("fsdp", 2),), 1),
        ("zero2", (("fsdp", 2),), 2), ("fsdp", (("fsdp", 2),), 1),
        ("tp", (("tensor", 2),), 1)],
    4: [("tp_fsdp", (("fsdp", 2), ("tensor", 2)), 1)],
}
ALL = [(n, c) for n in CASES for c in CASES[n]]

_RANK = textwrap.dedent("""
    import sys, numpy as np, torch
    import torch.distributed as dist
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.parallel.mesh import create_mesh
    from dlrover_tpu_torch.trainer.distributed import init_from_env
    from dlrover_tpu_torch.trainer.sharded import (
        adamw, make_trainer_for_llama)
    work, cases = sys.argv[1], eval(sys.argv[2])
    torch.set_num_threads(1)  # the ranks and the JAX runs share the cores
    env = init_from_env(timeout_s=60, device="cpu")
    cfg = llama.llama_tiny(dtype=torch.float32, remat="off")
    data = np.load(f"{work}/batches.npz")
    out = {}
    for i, (strategy, spec, accum) in enumerate(cases):
        model = llama.Llama(cfg, device="cpu")
        model.load_state_dict(torch.load(f"{work}/start{i}.pt"))
        trainer = make_trainer_for_llama(
            cfg, device="cpu", strategy=strategy, accum_steps=accum,
            mesh=create_mesh(list(spec), device="cpu"),
            optimizer=adamw(1e-3, b1=0.9, b2=0.95))
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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp(spec) -> int:
    return int(np.prod([k for a, k in spec if a in ("data", "fsdp")]))


def _batches(spec, accum):
    """Each step's global batch in the order the ranks' microbatches make
    the JAX step's (for the port), and as the JAX step takes it."""
    cfg = llama.llama_tiny()
    port, jax_order = [], []
    for i in range(STEPS):
        batch = _batch(cfg, b=4, s=32, seed=500 + i, masked=False)
        port.append(batch)
        jax_order.append(_as_jax_microbatches(batch, accum, _dp(spec)))
    return port, jax_order


class _FastJax(types.ModuleType):
    """``jax`` for the JAX trainer's module, whose ``jit`` compiles with
    XLA's cheap codegen (test_torch_gpt.py's FAST_COMPILE)."""

    def __getattr__(self, name):
        return getattr(jax, name)


def _jax_trainer(strategy, spec, accum):
    """The JAX trainer of a case and its initial (params, opt_state)."""
    jcfg = jax_llama.llama_tiny(dtype=np.float32, remat="off")
    n = int(np.prod([k for _, k in spec]))
    mesh = JaxMesh(np.asarray(jax.devices()[:n]).reshape(
        [k for _, k in spec]), tuple(a for a, _ in spec))
    jtrainer = jax_make_trainer(jcfg, mesh, strategy=strategy,
                                accum_steps=accum,
                                optimizer=optax.adamw(LR, b1=0.9, b2=0.95))
    _ = jtrainer.train_step  # builds its jit now, with the cheap codegen
    return jtrainer, jtrainer.init(jax.random.key(0))


def _jax_steps(spec, accum, jtrainer, state):
    params, opt_state = state
    losses = []
    for batch in _batches(spec, accum)[1]:
        params, opt_state, loss = jtrainer.train_step(
            params, opt_state,
            jtrainer.shard_batch(jtrainer.microbatch(batch)))
        losses.append(float(loss))
    return losses, _as_port_layout(
        jax.tree.map(np.asarray, params),
        jax_llama.llama_tiny(dtype=np.float32, remat="off"))


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


def _start(tmp_path_factory):
    """Each case's JAX trainer and initial state (built on threads: their
    compiles overlap), its starting weights in the port's layout and its
    batches written for the ranks, the ranks started, and the JAX steps
    started on threads. The two ranks also run
    test_torch_ckpt_sharded.py's job after their cases."""
    from tests import test_torch_ckpt_sharded as ckpt

    cfg = llama.llama_tiny(dtype=torch.float32, remat="off")
    fast = _FastJax("jax")
    fast.jit = functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    pool = ThreadPoolExecutor(len(ALL))
    saved, jax_sharded.jax = jax_sharded.jax, fast
    try:
        built = dict(zip(ALL, pool.map(lambda nc: _jax_trainer(*nc[1]),
                                       ALL)))
    finally:
        jax_sharded.jax = saved
    starts, procs, dirs = {}, {}, {}
    for n, cases in CASES.items():
        tmp = dirs[n] = tmp_path_factory.mktemp(f"strategies{n}")
        arrays = {}
        for i, (_, spec, accum) in enumerate(cases):
            start = jax.tree.map(np.array, built[n, cases[i]][1][0])
            model = llama.params_from_jax(start, cfg, device="cpu")
            torch.save(model.state_dict(), tmp / f"start{i}.pt")
            port = _batches(spec, accum)[0]
            for j, leaf in enumerate(("tokens", "targets")):
                arrays[f"{leaf}{i}"] = np.stack(
                    [b[j] for b in port]).astype(np.int64)
            starts[n, cases[i]] = {
                k: v.detach().numpy().copy()
                for k, v in model.named_parameters()}
        np.savez(tmp / "batches.npz", **arrays)
        job = ckpt.rank_job(tmp) if n == 2 else ""
        procs[n] = _spawn(tmp, n, cases, job)
    stepped = {nc: pool.submit(_jax_steps, nc[1][1], nc[1][2], *built[nc])
               for nc in ALL}
    pool.shutdown(wait=False)
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
                                *stepped[n, case].result(timeout=120),
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
    for _, c in ALL])
def test_strategy_matches_the_jax_sharded_trainer(runs, n, case):
    start, jax_losses, want, ranks = runs[n, case]
    for run in ranks:
        assert run["losses"][0] == pytest.approx(jax_losses[0], rel=1e-5)
        assert run["losses"] == pytest.approx(jax_losses, rel=1e-4)
    got = {k: v.numpy() for k, v in ranks[0]["params"].items()}
    _assert_adam_close(got, want, start, lr=LR)
    for run in ranks[1:]:  # every rank gathers the same parameters
        assert all(torch.equal(run["params"][k], ranks[0]["params"][k])
                   for k in got)


def test_bytes_per_rank_follow_the_layout(runs):
    """Parameters halve under fsdp and tp at two ranks (the norms, tiny,
    stay whole under fsdp); the optimizer state halves under zero1,
    zero2 and fsdp; tp_fsdp at 2 x 2 keeps a quarter."""
    cfg = llama.llama_tiny(dtype=torch.float32)
    whole = 4 * llama.param_count(cfg)
    norms = 4 * cfg.hidden_size * (2 * cfg.num_layers + 1)
    for (n, (strategy, _, _)), (*_, ranks) in runs.items():
        for run in ranks:
            params, opt = run["bytes"]["params"], run["bytes"]["optimizer"]
            sharded = {"zero1": 1, "zero2": 1, "fsdp": 2, "tp": 2,
                       "tp_fsdp": 4}[strategy]
            opt_parts = 4 if strategy == "tp_fsdp" else 2
            assert params == (whole - norms) // sharded + norms
            assert opt == 2 * ((whole - norms) // opt_parts + norms)
