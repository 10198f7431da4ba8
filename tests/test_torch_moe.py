"""The MoE Llama and expert parallelism of the port against the JAX
package on the CPU (``parallel/moe.py``, ``models/llama.py``).

One process: ``topk_gating`` (k 1 and 2, capacity drops, k == 1 keeping
the raw gate) and ``moe_mlp`` (values and gradients) against JAX's on
the same seeded inputs; ``params_from_jax`` carrying every MoE leaf;
llama_moe_tiny's loss (with its auxiliary term) and gradients. Four
gloo CPU ranks on (data 2, expert 2), started once for the module: (a)
``moe_mlp`` on a split batch whose global gating drops tokens -- each
rank's rows and experts against the JAX function on the whole batch, and
the same rows gated alone shown to differ; (b) the tp_fsdp trainer on
llama_moe_tiny against JAX's tp_fsdp ``ShardedTrainer`` on the same mesh
shape: every reduced gradient of the first batch (the router's counted
once), three adamw steps' losses and gathered parameters. Tolerances:
fp32, 2e-3 for values and 5e-3 for gradients (test_flash_attention.py);
the steps under test_torch_trainer.py's ``_assert_adam_close``."""

import functools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.parallel import moe as jax_moe
from dlrover_tpu.trainer.sharded import (
    make_trainer_for_llama as jax_make_trainer,
)
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.parallel import moe

from dlrover_tpu.trainer import sharded as jax_sharded
from tests.test_torch_gpt import FAST_COMPILE
from tests.test_torch_llama import _batch, one_thread  # noqa: F401
from tests.test_torch_strategies import _FastJax, _free_port
from tests.test_torch_trainer import _assert_adam_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
STEPS = 3
MESH = (("data", 2), ("expert", 2))
#: the split-batch case: 4 rows of 16 tokens, 4 experts of width 32 on
#: hidden 16, top-2 at capacity factor 0.5 (capacity 16 of 64 tokens)
SPLIT = dict(b=4, s=16, h=16, m=32, e=4, k=2, cf=0.5)

_RANK = textwrap.dedent("""
    import sys, numpy as np, torch
    import torch.distributed as dist
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.parallel import mesh as mesh_lib
    from dlrover_tpu_torch.parallel import moe
    from dlrover_tpu_torch.parallel.sharding import local_slices
    from dlrover_tpu_torch.trainer.distributed import (
        all_reduce_, init_from_env)
    from dlrover_tpu_torch.trainer.sharded import (
        adamw, make_trainer_for_llama)
    work, mesh_spec, split = sys.argv[1], eval(sys.argv[2]), eval(sys.argv[3])
    torch.set_num_threads(1)
    env = init_from_env(timeout_s=60, device="cpu")
    mesh = mesh_lib.create_mesh(list(mesh_spec), device="cpu")
    out = {}

    # (a) moe_mlp on this rank's rows and experts, the gating global
    data = np.load(f"{work}/split.npz")
    d, e = mesh_lib.axis_index(mesh, "data"), mesh_lib.axis_index(mesh, "expert")
    rows = slice(d * split["b"] // 2, (d + 1) * split["b"] // 2)
    mine = slice(e * split["e"] // 2, (e + 1) * split["e"] // 2)
    x = torch.from_numpy(data["x"][rows]).requires_grad_()
    gate_w = torch.from_numpy(data["gate_w"]).requires_grad_()
    experts = [torch.from_numpy(data[n][mine]).requires_grad_()
               for n in ("w_gate", "w_up", "w_down")]
    data_group = mesh_lib.axes_group(mesh, ("data",))
    shard = moe.ExpertShard(
        expert_start=mine.start,
        expert_group=mesh_lib.axes_group(mesh, ("expert",)),
        batch_group=data_group)
    routing = []
    y, aux = moe.moe_mlp(x, gate_w, *experts, k=split["k"],
                         capacity_factor=split["cf"], shard=shard,
                         routing=routing)
    # the rank's share of sum(out * dout) + aux: aux counted once in the sum
    loss = (y * torch.from_numpy(data["dout"][rows])).sum() + aux / 2
    loss.backward()
    grads = [gate_w.grad] + [w.grad for w in experts]
    for g in grads:  # summed over the ranks that hold other tokens
        all_reduce_(g, data_group)
    out["split"] = {"out": y.detach(), "aux": aux.item(),
                    "routing": routing[0], "dx": x.grad,
                    "dgate_w": grads[0],
                    "dexperts": [g for g in grads[1:]]}

    # (b) the tp_fsdp trainer
    cfg = llama.llama_moe_tiny(dtype=torch.float32, remat="off")
    batches = np.load(f"{work}/batches.npz")
    model = llama.Llama(cfg, device="cpu")
    model.load_state_dict(torch.load(f"{work}/start.pt"))
    t = make_trainer_for_llama(
        cfg, device="cpu", strategy="tp_fsdp", mesh=mesh,
        optimizer=adamw(1e-3, b1=0.9, b2=0.95))
    t.init(model=model)

    def mb(i):
        return t.shard_batch(t.microbatch(t.split_batch(
            (batches["tokens"][i], batches["targets"][i]))))

    t._gather_params()
    _, g = t._loss_and_grads(tuple(x[0] for x in mb(0)))
    g = t._reduce_to_opt([gi if gi is not None else torch.zeros_like(p)
                          for gi, p in zip(g, t._trained())])
    t._release_params()
    out["grads"] = {lay.name: (local_slices(lay.opt, lay.shape, mesh), gi)
                    for lay, gi in zip(t._layouts, g)}
    out["losses"] = [t.train_step(mb(i)).item()
                     for i in range(len(batches["tokens"]))]
    out["params"] = {n: p.clone() for n, p in t.gathered_params().items()}
    out["bytes"] = t.state_bytes()
    torch.save(out, f"{work}/rank{env.rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
""")


def _split_inputs():
    c = SPLIT
    rng = np.random.default_rng(21)

    def rand(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"x": rand(c["b"], c["s"], c["h"]),
            "gate_w": rand(c["h"], c["e"], scale=0.5),
            "w_gate": rand(c["e"], c["h"], c["m"], scale=0.3),
            "w_up": rand(c["e"], c["h"], c["m"], scale=0.3),
            "w_down": rand(c["e"], c["m"], c["h"], scale=0.3),
            "dout": rand(c["b"], c["s"], c["h"])}


def _jax_moe_tiny():
    return jax_llama.llama_moe_tiny(dtype=np.float32, remat="off")


def _port_view(tree, names):
    """{port parameter name: its box of the JAX tree, in the port's
    layout} (``jax_coordinates``: the stacked experts keep JAX's order,
    the other matrices are transposed)."""
    cfg = llama.llama_moe_tiny()
    out = {}
    for name in names:
        leaf = llama.jax_coordinates(cfg, name)
        arr = tree
        for k in leaf.path:
            arr = arr[k]
        arr = np.asarray(arr)
        if leaf.layer is not None:
            arr = arr[leaf.layer:leaf.layer + 1]
        out[name] = leaf.from_jax(torch.from_numpy(np.array(arr))).numpy()
    return out


def _batches():
    cfg = llama.llama_moe_tiny()
    return [_batch(cfg, b=4, s=32, seed=700 + i, masked=False)
            for i in range(STEPS)]


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The four ranks, started before the module's first test (their
    inputs from the JAX trainer's initial parameters): (JAX trainer,
    its initial state, the work directory, the processes). The one-rank
    tests run while the ranks do."""
    work = tmp_path_factory.mktemp("moe")
    np.savez(work / "split.npz", **_split_inputs())
    jcfg = _jax_moe_tiny()
    mesh = JaxMesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                   tuple(a for a, _ in MESH))
    fast = _FastJax("jax")
    fast.jit = functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    saved, jax_sharded.jax = jax_sharded.jax, fast
    try:
        jtrainer = jax_make_trainer(
            jcfg, mesh, strategy="tp_fsdp",
            optimizer=optax.adamw(LR, b1=0.9, b2=0.95))
        _ = jtrainer.train_step  # builds its jit now, with the cheap codegen
    finally:
        jax_sharded.jax = saved
    params, opt_state = jtrainer.init(jax.random.key(0))
    start = jax.tree.map(np.array, params)
    cfg = llama.llama_moe_tiny(dtype=torch.float32, remat="off")
    torch.save(llama.params_from_jax(start, cfg, device="cpu").state_dict(),
               work / "start.pt")
    batches = _batches()
    np.savez(work / "batches.npz",
             tokens=np.stack([b[0] for b in batches]).astype(np.int64),
             targets=np.stack([b[1] for b in batches]).astype(np.int64))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(work), repr(MESH), repr(SPLIT)],
        env={**os.environ, "PYTHONPATH": REPO,
             "DLROVER_TPU_COORDINATOR_ADDR": f"localhost:{port}",
             "DLROVER_TPU_PROCESS_ID": str(rank),
             "DLROVER_TPU_NUM_PROCESSES": "4",
             "DLROVER_TPU_DIST_HEARTBEAT_TIMEOUT": "30",
             "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(4)]
    yield jtrainer, (params, opt_state), work, procs
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def ranks(started):
    """The JAX tp_fsdp steps, then the ranks' results: (JAX start and
    final params as numpy trees, JAX losses, each rank's results)."""
    jtrainer, (params, opt_state), work, procs = started
    start = jax.tree.map(np.array, params)
    batches = _batches()
    try:
        losses = []
        for b in batches:
            params, opt_state, loss = jtrainer.train_step(
                params, opt_state, jtrainer.shard_batch(
                    jtrainer.microbatch(b)))
            losses.append(float(loss))
        final = jax.tree.map(np.asarray, params)
        logs = [p.communicate(timeout=120)[0] for p in procs]
        assert [p.returncode for p in procs] == [0] * 4, logs[0][-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    runs = [torch.load(work / f"rank{r}.pt") for r in range(4)]
    return start, losses, final, runs


@functools.lru_cache(maxsize=None)
def _jax_split():
    """JAX's moe_mlp on the whole split batch: (out, aux, dispatch, grads
    of sum(out * dout) + aux by x, gate_w, w_gate, w_up, w_down)."""
    c, a = SPLIT, {k: jnp.asarray(v) for k, v in _split_inputs().items()}

    def loss(x, gate_w, w_gate, w_up, w_down):
        out, aux = jax_moe.moe_mlp(x, gate_w, w_gate, w_up, w_down,
                                   k=c["k"], capacity_factor=c["cf"])
        return jnp.sum(out * a["dout"]) + aux, (out, aux)

    args = (a["x"], a["gate_w"], a["w_gate"], a["w_up"], a["w_down"])
    grads, (out, aux) = jax.jit(
        jax.grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True),
        compiler_options=FAST_COMPILE)(*args)
    n = c["b"] * c["s"]
    logits = a["x"].reshape(n, c["h"]) @ a["gate_w"]
    dispatch, _, _ = jax_moe.topk_gating(
        logits, c["k"], max(1, int(c["cf"] * n * c["k"] / c["e"])))
    return (np.asarray(out), float(aux), np.asarray(dispatch),
            [np.asarray(g) for g in grads])


# ---------------------------------------------------------------- one rank

@pytest.mark.parametrize("k,capacity,logits", [
    (1, 16, "normal"), (2, 16, "normal"), (2, 6, "normal"),
    (1, 4, "one_expert"), (2, 4, "one_expert")])
def test_topk_gating_matches_jax(k, capacity, logits):
    """Dispatch equal, combine and aux within fp32 rounding; capacity
    drops (the one-expert logits overflow it); k == 1 keeps the raw gate
    (its combine is the softmax probability, not 1)."""
    rng = np.random.default_rng(k * 100 + capacity)
    if logits == "normal":
        x = rng.standard_normal((32, 4)).astype(np.float32)
    else:
        x = np.tile(np.array([[10.0, 0.0, 0.0, 0.0]], np.float32), (32, 1))
        x += rng.standard_normal((32, 4)).astype(np.float32) * 0.1
    jd, jc, ja = jax_moe.topk_gating(jnp.asarray(x), k, capacity)
    d, c, a = moe.topk_gating(torch.from_numpy(x), k, capacity)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-7)
    assert a.item() == pytest.approx(float(ja), rel=1e-6)
    if logits == "one_expert":  # expert 0 full, the overflow dropped
        assert d[:, 0].sum().item() == capacity
        assert d.sum().item() < 32 * k
    if k == 1:
        probs = torch.softmax(torch.from_numpy(x), -1)
        kept = d.sum(dim=(1, 2)) > 0
        assert torch.allclose(c.sum(dim=(1, 2))[kept],
                              probs.max(dim=-1).values[kept])
        assert (c.sum(dim=(1, 2))[kept] < 1.0).all()


def test_moe_mlp_values_and_grads_match_jax():
    jout, jaux, _, jgrads = _jax_split()
    a = {k: torch.from_numpy(v).requires_grad_()
         for k, v in _split_inputs().items() if k != "dout"}
    out, aux = moe.moe_mlp(a["x"], a["gate_w"], a["w_gate"], a["w_up"],
                           a["w_down"], k=SPLIT["k"],
                           capacity_factor=SPLIT["cf"])
    ((out * torch.from_numpy(_split_inputs()["dout"])).sum() + aux
     ).backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=2e-3,
                               atol=2e-3)
    assert aux.item() == pytest.approx(jaux, rel=2e-3)
    for name, want in zip(("x", "gate_w", "w_gate", "w_up", "w_down"),
                          jgrads):
        np.testing.assert_allclose(a[name].grad.numpy(), want, rtol=5e-3,
                                   atol=5e-3, err_msg=name)


def test_params_from_jax_carries_every_moe_leaf():
    """Every port parameter is its box of the JAX tree bit for bit, every
    JAX leaf is carried, and the counts follow JAX's."""
    jcfg = _jax_moe_tiny()
    cfg = llama.llama_moe_tiny(dtype=torch.float32)
    tree = jax.tree.map(np.asarray,
                        jax_llama.init_params(jax.random.key(4), jcfg))
    model = llama.params_from_jax(tree, cfg, device="cpu")
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    want = _port_view(tree, got)
    for name in got:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    carried = {llama.jax_coordinates(cfg, n).path for n in got}
    assert carried == {("embed",), ("final_norm",), ("lm_head",)} | {
        ("blocks", k) for k in tree["blocks"]}
    assert {"router", "w_gate", "w_up", "w_down"} <= set(tree["blocks"])
    assert sum(p.numel() for p in model.parameters()) == \
        llama.param_count(cfg) == jax_llama.param_count(jcfg)
    assert llama.flops_per_token(cfg, 128) == \
        jax_llama.flops_per_token(jcfg, 128)
    assert llama.param_axes(cfg)["blocks.1.w_down"] == (
        "expert", "mlp", "embed")


def test_moe_tiny_loss_and_grads_match_jax():
    """llama_moe_tiny at one rank: the loss with its auxiliary term, and
    every gradient."""
    jcfg = _jax_moe_tiny()
    cfg = llama.llama_moe_tiny(dtype=torch.float32, remat="off")
    params = jax_llama.init_params(jax.random.key(1), jcfg)
    tokens, targets = _batch(cfg, b=2, s=32, seed=3)
    loss_fn = functools.partial(jax_llama.next_token_loss, cfg=jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, (tokens, targets))),
        compiler_options=FAST_COMPILE)(params)
    model = llama.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    nll, cnt, aux = llama.next_token_sums(
        model, (torch.from_numpy(tokens).long(),
                torch.from_numpy(targets).long()))
    assert aux is not None and aux.item() > 0
    loss = nll / cnt + aux
    loss.backward()
    assert loss.item() == pytest.approx(float(jloss), rel=2e-3)
    want = jax.tree.map(np.asarray, jgrads)
    for name, p in model.named_parameters():
        leaf = llama.jax_coordinates(cfg, name)
        arr = want[leaf.path[0]] if len(leaf.path) == 1 else \
            want[leaf.path[0]][leaf.path[1]]
        box = arr[tuple(slice(a, b) for a, b in leaf.index(
            [[0, k] for k in p.shape]))]
        np.testing.assert_allclose(leaf.to_jax(p.grad).numpy(), box,
                                   rtol=5e-3, atol=5e-3, err_msg=name)


# ------------------------------------------------------------ four ranks

def test_split_batch_gates_globally(ranks):
    """Each rank's rows and experts of the split batch against the JAX
    function on the whole: the same dispatch, outputs, auxiliary loss and
    gradients; and the rows gated alone would drop other tokens."""
    *_, runs = ranks
    jout, jaux, jdispatch, jgrads = _jax_split()
    c = SPLIT
    assert float(jdispatch.sum()) < c["b"] * c["s"] * c["k"]  # drops
    slots = np.where(jdispatch.sum(-1) > 0,
                     (jdispatch * np.arange(jdispatch.shape[-1])).sum(-1),
                     -1)
    for rank, run in enumerate(runs):
        d, e = divmod(rank, 2)
        rows = slice(d * c["b"] // 2, (d + 1) * c["b"] // 2)
        mine = slice(e * c["e"] // 2, (e + 1) * c["e"] // 2)
        s = run["split"]
        np.testing.assert_array_equal(s["routing"].numpy(), slots)
        np.testing.assert_allclose(s["out"].numpy(), jout[rows], rtol=2e-3,
                                   atol=2e-3)
        assert s["aux"] == pytest.approx(jaux, rel=2e-3)
        np.testing.assert_allclose(s["dx"].numpy(), jgrads[0][rows],
                                   rtol=5e-3, atol=5e-3)
        np.testing.assert_allclose(s["dgate_w"].numpy(), jgrads[1],
                                   rtol=5e-3, atol=5e-3)
        for got, want in zip(s["dexperts"], jgrads[2:]):
            np.testing.assert_allclose(got.numpy(), want[mine], rtol=5e-3,
                                       atol=5e-3)
    # the first rows gated on their own: another capacity, other drops
    a = {k: torch.from_numpy(v) for k, v in _split_inputs().items()}
    alone, _ = moe.moe_mlp(a["x"][:2], a["gate_w"], a["w_gate"], a["w_up"],
                           a["w_down"], k=c["k"], capacity_factor=c["cf"])
    assert not np.allclose(alone.numpy(), jout[:2], rtol=2e-3, atol=2e-3)


def test_tp_fsdp_gradients_counted_once(ranks):
    """The first batch's gradients, reduced to each rank's boxes (its two
    experts), against JAX's gradient of the loss on the global batch:
    the router's and the auxiliary term's counted once."""
    start, *_, runs = ranks
    jcfg = _jax_moe_tiny()
    params = jax.tree.map(jnp.asarray, start)
    tokens, targets = _batches()[0]
    grads = jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda p: jax_llama.next_token_loss(p, (tokens, targets), jcfg)),
        compiler_options=FAST_COMPILE)(params))
    cfg = llama.llama_moe_tiny(dtype=torch.float32)
    for run in runs:
        assert any(n.endswith("router.weight") for n in run["grads"])
        for name, (box, g) in run["grads"].items():
            leaf = llama.jax_coordinates(cfg, name)
            arr = grads[leaf.path[0]] if len(leaf.path) == 1 else \
                grads[leaf.path[0]][leaf.path[1]]
            want = arr[tuple(slice(a, b) for a, b in leaf.index(box))]
            np.testing.assert_allclose(leaf.to_jax(g).numpy(), want,
                                       rtol=5e-3, atol=5e-3, err_msg=name)


def test_tp_fsdp_steps_match_the_jax_sharded_trainer(ranks):
    """Three adamw steps: losses, every rank's gathered parameters, and
    each rank keeping half of the experts' bytes."""
    start, jax_losses, final, runs = ranks
    for run in runs:
        assert run["losses"][0] == pytest.approx(jax_losses[0], rel=1e-5)
        assert run["losses"] == pytest.approx(jax_losses, rel=1e-4)
    got = {k: v.numpy() for k, v in runs[0]["params"].items()}
    _assert_adam_close(got, _port_view(final, got), _port_view(start, got),
                       lr=LR)
    for run in runs[1:]:
        assert all(torch.equal(run["params"][k], runs[0]["params"][k])
                   for k in got)
    cfg = llama.llama_moe_tiny(dtype=torch.float32)
    experts = 3 * cfg.num_layers * cfg.num_experts * cfg.hidden_size \
        * cfg.intermediate_size
    for run in runs:
        assert run["bytes"]["params"] == 4 * (
            llama.param_count(cfg) - experts // 2)


@pytest.mark.parametrize("remat", ["dots", "dots_attn_out", "minimal"])
def test_moe_aux_under_every_remat_policy(remat):
    """The MoE block returns (x, aux) through each remat policy: the loss
    (with aux) and every gradient equal those without remat."""
    cfg = llama.llama_moe_tiny(dtype=torch.float32, remat="off")
    tokens, targets = (torch.from_numpy(x).long()
                       for x in _batch(cfg, b=2, s=32, seed=5))
    runs = []
    for policy in ("off", remat):
        model = llama.init_params(
            llama.llama_moe_tiny(dtype=torch.float32, remat=policy),
            seed=2, device="cpu")
        loss = llama.next_token_loss(model, (tokens, targets))
        loss.backward()
        runs.append((loss.item(), {n: p.grad for n, p in
                                   model.named_parameters()}))
    (want, want_g), (got, got_g) = runs
    assert got == pytest.approx(want, rel=1e-6)
    for name, g in got_g.items():
        torch.testing.assert_close(g, want_g[name], rtol=1e-5, atol=1e-6)
