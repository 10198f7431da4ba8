"""The port's copies of the JAX-free control-plane modules -- constants,
the global context, the wire codec, telemetry, the master's shard
managers, the in-process master client and the sharding clients --
against the JAX package's.

Two kinds of test: the same inputs through both packages must give the
same shard sequences and the same dataset-checkpoint JSON; and cases of
the JAX package's own tests (``tests/test_sharding.py``,
``test_shard_dispatch.py``, ``test_common.py``) run once per package, the
port's run with every import of a module the port has re-pointed at the
port (:func:`load_repointed`).
"""

import ast
import functools
import gc
import importlib
import inspect
import json
import re
import sys
import types
from pathlib import Path

import pytest

from dlrover_tpu.agent.master_client import (
    LocalMasterClient as JaxLocalMasterClient,
)
from dlrover_tpu.agent.sharding.client import (
    ShardingClient as JaxShardingClient,
)
from dlrover_tpu.master.shard.dataset_splitter import (
    new_dataset_splitter as jax_new_dataset_splitter,
)
from dlrover_tpu.master.shard.task_manager import TaskManager as JaxTaskManager
from dlrover_tpu_torch.agent import master_client as port_master_client
from dlrover_tpu_torch.agent.master_client import LocalMasterClient
from dlrover_tpu_torch.agent.sharding.client import ShardingClient
from dlrover_tpu_torch.common.constants import NodeEnv, NodeType
from dlrover_tpu_torch.master.shard.dataset_splitter import (
    new_dataset_splitter,
)
from dlrover_tpu_torch.master.shard.task_manager import TaskManager

TESTS = Path(__file__).resolve().parent
PORT = TESTS.parent / "dlrover_tpu_torch"
JAX = TESTS.parent / "dlrover_tpu"
PACKAGES = ("dlrover_tpu", "dlrover_tpu_torch")


# ------------------------------------------------- re-pointed JAX tests


def _is_module(root: Path, dotted: str) -> bool:
    p = root.joinpath(*dotted.split(".")) if dotted else root
    return p.with_suffix(".py").is_file() or (p / "__init__.py").is_file()


def _port_has(module: str, name: str) -> bool:
    """Whether ``from dlrover_tpu_torch.<module> import <name>`` works."""
    if _is_module(PORT, f"{module}.{name}" if module else name):
        return True
    mod = importlib.import_module(
        "dlrover_tpu_torch" + (f".{module}" if module else ""))
    return hasattr(mod, name)


def _dotted(match: re.Match) -> str:
    """``dlrover_tpu.a.b.c`` re-pointed when its longest prefix that is
    a module of the JAX package is a module of the port too."""
    parts = match.group(1).lstrip(".").split(".")
    for n in range(len(parts), 0, -1):
        prefix = ".".join(parts[:n])
        if _is_module(JAX, prefix):
            if _is_module(PORT, prefix):
                return "dlrover_tpu_torch." + ".".join(parts)
            break
    return match.group(0)


_KEEP = "__keep_dlrover_tpu__"


def repoint_source(src: str) -> str:
    """A JAX test module's source with its imports of modules the port
    has taken from the port: each ``from dlrover_tpu.X import a, b`` is
    split by which names the port's X has, and other dotted references
    (strings included, such as monkeypatch targets) are re-pointed where
    the port has the module."""
    lines = src.splitlines()
    edits = []
    for node in ast.walk(ast.parse(src)):
        if not (isinstance(node, ast.ImportFrom) and node.level == 0
                and node.module and (node.module == "dlrover_tpu"
                                     or node.module.startswith(
                                         "dlrover_tpu."))):
            continue
        sub = node.module[len("dlrover_tpu"):].lstrip(".")
        if not _is_module(PORT, sub):
            continue
        port = [a for a in node.names if _port_has(sub, a.name)]
        rest = [a for a in node.names if a not in port]

        def names(aliases):
            return ", ".join(
                a.name + (f" as {a.asname}" if a.asname else "")
                for a in aliases)

        indent = " " * node.col_offset
        new = []
        if port:
            new.append(f"{indent}from dlrover_tpu_torch"
                       f"{'.' + sub if sub else ''} import {names(port)}")
        if rest:  # kept from the dotted rewrite below by a marker
            new.append(f"{indent}from {_KEEP}{node.module[11:]} import "
                       f"{names(rest)}")
        edits.append((node.lineno, node.end_lineno, new))
    for start, end, new in sorted(edits, reverse=True):
        lines[start - 1:end] = new
    out = "\n".join(lines) + "\n"
    out = re.sub(r"\bdlrover_tpu((?:\.\w+)+)", _dotted, out)
    return out.replace(_KEEP, "dlrover_tpu")


@functools.lru_cache(maxsize=None)
def load_repointed(test_file: str, pkg: str) -> types.ModuleType:
    """The JAX package's test module ``test_file``, as is (``pkg`` =
    ``"dlrover_tpu"``) or re-pointed at the port."""
    path = TESTS / test_file
    src = path.read_text()
    if pkg == "dlrover_tpu_torch":
        src = repoint_source(src)
    name = f"_repointed_{pkg}_{path.stem}"
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    sys.modules[name] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def run_repointed(test_file: str, pkg: str, test_name: str,
                  request) -> None:
    """Run one test of ``test_file`` in ``pkg``'s version. The fixtures
    the module defines (its autouse ones first) are set up from the
    module itself, so a test that names one gets that package's value;
    any other fixture comes from pytest."""
    mod = load_repointed(test_file, pkg)
    fixtures = {
        n: obj for n, obj in vars(mod).items()
        if getattr(obj, "_fixture_function_marker", None) is not None
    }
    values, finalizers = {}, []

    def resolve(name):
        if name in values:
            return values[name]
        if name not in fixtures:
            return request.getfixturevalue(name)
        fn = fixtures[name]._get_wrapped_function()
        out = fn(**{p: resolve(p)
                    for p in inspect.signature(fn).parameters})
        if inspect.isgenerator(out):
            finalizers.append(out)
            out = next(out)
        values[name] = out
        return out

    try:
        for name, obj in fixtures.items():
            if obj._fixture_function_marker.autouse:
                resolve(name)
        test = getattr(mod, test_name)
        test(**{p: resolve(p)
                for p in inspect.signature(test).parameters})
    finally:
        for gen in reversed(finalizers):
            next(gen, None)


def stop_background_loops(threads=None) -> None:
    """Stop the status reporters and metrics servers, of either package,
    that agents and masters of finished tests left running (all of
    them, or those whose threads are in ``threads``): they would go on
    reporting to a master that is gone. A reporter is only told to
    stop; one inside an RPC ends when that RPC returns."""
    for obj in gc.get_objects():
        if (type(obj).__name__ in ("StatusReporter", "MetricsServer")
                and type(obj).__module__.startswith("dlrover_tpu")):
            thread = getattr(obj, "_thread", None)
            if (thread is None or not thread.is_alive()
                    or (threads is not None and thread not in threads)):
                continue
            if type(obj).__name__ == "MetricsServer":
                obj.stop()
            else:
                obj._stopped.set()


#: cases of the JAX tests that touch only modules the port has copied
REPOINTED = {
    "test_sharding.py": [
        "test_table_splitter_basic",
        "test_table_splitter_huge_dataset_lazy",
        "test_text_splitter_shuffle",
        "test_streaming_splitter_offsets",
        "test_batch_manager_dispatch_and_report",
        "test_batch_manager_node_failure_recovery",
        "test_batch_manager_checkpoint_roundtrip",
        "test_task_manager_end_to_end",
        "test_task_manager_shard_checkpoint",
        "test_wait_task_for_peer_work_but_not_own_tail",
        "test_incarnation_reclaim_requeues_dead_predecessors_shards",
    ],
    "test_shard_dispatch.py": [
        "test_task_batch_wire_roundtrip",
        "test_get_dataset_tasks_pops_up_to_n",
        "test_wait_and_exhausted_returned_alone",
        "test_lookahead_window_drains_exactly_once",
        "test_resize_mid_shard_keeps_exactly_once",
        "test_resize_updates_reconnect_rehello_params",
        "test_resize_mid_chunk_index_stream_exactly_once",
        "test_lookahead_surfaces_fetch_errors",
        "test_report_batch_done_rpc_runs_outside_lock",
        "test_report_batch_done_keeps_reject_semantics",
        "test_index_client_chunked_delivery",
        "test_index_client_mixed_sample_and_batch_reads",
    ],
    "test_common.py": [
        "test_context_singleton_and_override",
        "test_wire_codec_round_trips_nested_and_typed_keys",
        "test_wire_codec_rejects_unknown_and_malformed",
        "test_wire_codec_refuses_unencodable_values",
        "test_wire_codec_map_keys_must_be_primitive",
        "test_wire_codec_coerces_numpy_scalars",
    ],
}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", [
    (f, t) for f, names in REPOINTED.items() for t in names
], ids=lambda c: f"{c[0][:-3]}::{c[1]}")
def test_jax_case_in_both_packages(case, pkg, request):
    test_file, test_name = case
    run_repointed(test_file, pkg, test_name, request)


def test_repointing_reaches_the_port():
    mod = load_repointed("test_shard_dispatch.py", "dlrover_tpu_torch")
    assert mod.TaskManager is TaskManager
    assert mod.LocalMasterClient is LocalMasterClient
    assert mod.MasterClient is port_master_client.MasterClient
    # the state journal, ported since, is the port's too
    assert (mod.build_master_state_journal.__module__
            == "dlrover_tpu_torch.master.state_journal")


# ------------------------------------------- same inputs, both packages


SPLITS = [
    dict(dataset_size=100, batch_size=4, minibatches=3, epochs=3,
         shuffle=False),
    dict(dataset_size=100, batch_size=4, minibatches=3, epochs=3,
         shuffle=True),
    dict(dataset_size=37, batch_size=5, minibatches=1, epochs=2,
         shuffle=True),
]


def _drain(tm, splitter_fn, p, seed, ckpt_every=3):
    """Every shard a TaskManager hands out over all epochs, with the
    dataset checkpoint JSON every ``ckpt_every`` shards; the splitter's
    shuffle is seeded."""
    import random

    random.seed(seed)
    splitter = splitter_fn(
        shuffle=p["shuffle"], shard_size=p["batch_size"] * p["minibatches"],
        dataset_size=p["dataset_size"], num_epochs=p["epochs"],
        dataset_name="ds")
    tm.new_dataset(p["batch_size"], p["dataset_size"], "ds", splitter)
    shards, ckpts = [], []
    while True:
        task = tm.get_dataset_task(NodeType.WORKER, 0, "ds")
        if task is None or task.task_id < 0:
            break
        shards.append((task.shard.start, task.shard.end,
                       task.shard.record_indices, tm.get_dataset_epoch("ds")))
        tm.report_dataset_task("ds", task.task_id, True)
        if len(shards) % ckpt_every == 0:
            ckpts.append(json.loads(tm.get_dataset_checkpoint("ds").to_json()))
    return shards, ckpts


@pytest.mark.parametrize("p", SPLITS, ids=lambda p: "shuffle" if
                         p["shuffle"] else "in_order")
def test_task_manager_shards_and_checkpoints_match_jax(p):
    want = _drain(JaxTaskManager(), jax_new_dataset_splitter, p, seed=7)
    got = _drain(TaskManager(), new_dataset_splitter, p, seed=7)
    assert want[0], "no shards"
    assert got == want
    epochs = {s[3] for s in got[0]}
    assert len(epochs) == p["epochs"]


def _client_run(master_cls, client_cls, steps, restore=None):
    master = master_cls()
    client = client_cls("ds", 4, num_epochs=2, dataset_size=40,
                        shuffle=False, num_minibatches_per_shard=2,
                        master_client=master)
    if restore is not None:
        client.restore_shard_from_checkpoint(restore)
    batches, ckpt = [], None
    for i in range(steps):
        shard = client.fetch_shard()
        if shard is None:
            break
        for off in range(shard.start, shard.end, 4):
            batches.append((off, min(off + 4, shard.end)))
            client.report_batch_done()
        if i == 3:
            ckpt = client.get_shard_checkpoint()
    return batches, ckpt


def test_sharding_client_batches_and_resume_match_jax():
    want, want_ckpt = _client_run(JaxLocalMasterClient, JaxShardingClient, 8)
    got, got_ckpt = _client_run(LocalMasterClient, ShardingClient, 8)
    assert got == want and len(got) == 16
    assert json.loads(got_ckpt) == json.loads(want_ckpt)
    # checkpoint after four shards, restore in a fresh master: the next
    # shard is the fifth, in both packages
    resumed, _ = _client_run(LocalMasterClient, ShardingClient, 4,
                             restore=got_ckpt)
    jax_resumed, _ = _client_run(JaxLocalMasterClient, JaxShardingClient, 4,
                                 restore=want_ckpt)
    assert resumed == jax_resumed == got[8:16]


def test_build_master_client_without_an_address_is_local(monkeypatch):
    """No master address, given or in the env: the in-process client
    (an address gives the RPC client: test_torch_master_service.py)."""
    monkeypatch.delenv(NodeEnv.MASTER_ADDR, raising=False)
    client = port_master_client.build_master_client()
    assert isinstance(client, LocalMasterClient)
    assert port_master_client.get_master_client() is client
