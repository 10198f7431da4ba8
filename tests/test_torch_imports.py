"""The port stands alone: no module of ``dlrover_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, optax, orbax, ml_dtypes, grpc or the JAX
package, the smoke script refuses to run without the package or
without a GPU, and the modules the agent and the master load -- the
telemetry surface, the stats pipeline, the resource monitor and their
entry points -- import no torch, nor do the modules the shm data plane's
coworker processes load."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "dlrover_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "ml_dtypes", "dlrover_tpu",
             "grpc")
FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.lineno, node.args[0].value


def test_the_data_plane_is_under_the_rule():
    data = {p.name for p in FILES if p.parent == PORT / "data"}
    assert {"shm_ring.py", "shm_dataloader.py", "elastic_shm.py",
            "synth.py", "__init__.py"} <= data


def test_the_model_families_are_under_the_rule():
    ported = {str(p.relative_to(PORT)) for p in FILES if p.is_relative_to(PORT)}
    assert {"models/llama.py", "models/gpt.py", "models/cnn.py",
            "models/dlrm.py", "parallel/embedding.py",
            "examples/cnn_train.py", "examples/dlrm_train.py",
            "examples/shard_loop.py"} <= ported


def test_the_multi_process_modules_are_under_the_rule():
    ported = {str(p.relative_to(PORT)) for p in FILES if p.is_relative_to(PORT)}
    assert {"checkpoint/saver.py", "checkpoint/loader.py",
            "checkpoint/peer.py", "agent/elastic/network_check.py",
            "trainer/distributed.py", "trainer/ckpt_store.py",
            "telemetry/http.py"} <= ported


def test_the_mesh_modules_are_under_the_rule():
    ported = {str(p.relative_to(PORT)) for p in FILES if p.is_relative_to(PORT)}
    assert {"parallel/mesh.py", "parallel/sharding.py",
            "parallel/tensor_parallel.py", "parallel/context_parallel.py",
            "parallel/moe.py", "parallel/pipeline.py",
            "trainer/sharded.py"} <= ported


def test_the_strategy_search_is_under_the_rule():
    ported = {str(p.relative_to(PORT)) for p in FILES if p.is_relative_to(PORT)}
    assert {"auto/strategy.py", "auto/analyser.py", "auto/bo.py",
            "auto/planner.py", "auto/accelerate.py", "auto/probe.py",
            "auto/device_context.py", "examples/auto_train.py"} <= ported


def test_the_reshard_and_state_modules_are_under_the_rule():
    ported = {str(p.relative_to(PORT)) for p in FILES if p.is_relative_to(PORT)}
    assert {"reshard/__init__.py", "reshard/order.py",
            "reshard/coordinator.py", "reshard/transition.py",
            "reshard/migrate.py", "reshard/spare.py",
            "util/__init__.py", "util/state_store.py",
            "util/event_queue.py", "master/state_journal.py",
            "examples/stream_train.py"} <= ported


def test_the_optimizers_are_under_the_rule():
    ported = {str(p.relative_to(PORT)) for p in FILES if p.is_relative_to(PORT)}
    assert {"optim/__init__.py", "optim/bf16.py", "optim/optimizers.py",
            "optim/state.py", "optim/wsam.py"} <= ported


@pytest.mark.parametrize(
    "path", FILES, ids=[str(p.relative_to(REPO)) for p in FILES])
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, mod) for line, mod in _imported_modules(tree)
           if _forbidden(mod)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _every_module():
    return [
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in sorted(PORT.rglob("*.py"))
    ]


def test_importing_every_module_loads_no_jax(interpreters):
    modules = _every_module()
    out = interpreters["every_module"]
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(modules) >= 10


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.Popen(
        [sys.executable, "chip_smoke.py"], cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env,
    )


def test_chip_smoke_alone_fails(interpreters):
    out = interpreters["smoke_alone"]
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_without_gpu_fails(interpreters):
    if "smoke" not in interpreters:
        pytest.skip("this machine has a GPU: chip_smoke.py runs here")
    out = interpreters["smoke"]
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert '"ok"' not in out.stdout


#: modules the agent and the master load: the telemetry surface, the
#: stats pipeline, the resource monitor (torch only inside its device
#: probe) and their entry points
TORCH_FREE = (
    "dlrover_tpu_torch.telemetry.goodput",
    "dlrover_tpu_torch.telemetry.http",
    "dlrover_tpu_torch.telemetry.flight_recorder",
    "dlrover_tpu_torch.telemetry.lockwatch",
    "dlrover_tpu_torch.telemetry.dump",
    "dlrover_tpu_torch.master.stats",
    "dlrover_tpu_torch.agent.monitor.resource",
    "dlrover_tpu_torch.master.main",
    "dlrover_tpu_torch.master.local_master",
    "dlrover_tpu_torch.agent.elastic.training",
    "dlrover_tpu_torch.agent.elastic.network_check",
    "dlrover_tpu_torch.trainer.elastic_run",
    # the peer tier's endpoint, which the telemetry server loads
    "dlrover_tpu_torch.checkpoint.peer",
    # the shm data plane's producer side: what a coworker process loads
    # to run an ElasticShmDataLoader's producer on a synth batch_fn
    "dlrover_tpu_torch.data.shm_ring",
    "dlrover_tpu_torch.data.shm_dataloader",
    "dlrover_tpu_torch.data.elastic_shm",
    "dlrover_tpu_torch.data.synth",
    "dlrover_tpu_torch.agent.sharding.client",
    "dlrover_tpu_torch.trainer.sampler",
    "dlrover_tpu_torch.trainer.evaluator",
    # the master's side of reshard-in-place and its durable state
    "dlrover_tpu_torch.reshard.coordinator",
    "dlrover_tpu_torch.master.state_journal",
    "dlrover_tpu_torch.util",
    "dlrover_tpu_torch.examples.stream_train",
)


#: unpickling and running an ElasticShmDataLoader's producer, as a
#: spawned coworker does, up to its first master call
_COWORKER = (
        "import pickle, sys\n"
        "from dlrover_tpu_torch.data import elastic_shm, synth\n"
        "from dlrover_tpu_torch.data.shm_dataloader import _producer_main\n"
        "p = pickle.loads(pickle.dumps(elastic_shm._ShardedProducer(\n"
        "    synth.ShardBatch(8, 16), 'd', 2, 8, 1, False, 1, None)))\n"
        "p.batch_fn(0, 2)\n"
        "import dlrover_tpu_torch.agent.master_client\n"
        "bad = [m for m in sys.modules if m == 'torch' "
        "or m.startswith('torch.')]\n"
        "assert not bad, bad[:5]\n"
)


def test_a_coworker_process_imports_no_torch(interpreters):
    out = interpreters["coworker"]
    assert out.returncode == 0, out.stderr


@pytest.fixture(scope="module")
def interpreters(tmp_path_factory):
    """The module's interpreters, all started together: every port
    module imported in one ("every_module"), chip_smoke.py in a directory
    that holds nothing else ("smoke_alone") and without a GPU ("smoke";
    on a machine without one), a coworker's producer ("coworker"), and
    each TORCH_FREE module alone; {name: completed process}."""
    every = (
        "import importlib, sys\n"
        f"for m in {_every_module()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if any(m == f or m.startswith(f + '.')"
        f" for f in {FORBIDDEN!r})]\n"
        "assert not bad, bad\n"
        f"print(len({_every_module()!r}))\n"
    )
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for name, code in (("every_module", every), ("coworker", _COWORKER))}
    alone = tmp_path_factory.mktemp("smoke_alone")
    shutil.copy(REPO / "chip_smoke.py", alone / "chip_smoke.py")
    procs["smoke_alone"] = _run_smoke(alone)
    if not torch.cuda.is_available():
        procs["smoke"] = _run_smoke(REPO)
    for module in TORCH_FREE:
        code = (
            "import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            "bad = [m for m in sys.modules if m == 'torch' "
            "or m.startswith('torch.')]\n"
            "assert not bad, bad[:5]\n"
        )
        procs[module] = subprocess.Popen(
            [sys.executable, "-c", code], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out = {}
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=120)
            out[name] = subprocess.CompletedProcess(p.args, p.returncode,
                                                    stdout, stderr)
        return out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()


@pytest.mark.parametrize("module", TORCH_FREE)
def test_agent_and_master_modules_load_without_torch(module, interpreters):
    out = interpreters[module]
    assert out.returncode == 0, out.stderr
