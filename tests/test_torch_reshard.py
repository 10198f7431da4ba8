"""The port's reshard plane (``dlrover_tpu_torch/reshard/``) against the
JAX package's.

``tests/test_reshard.py``'s classes for the wire format, the env gates,
the master's ``TransitionCoordinator`` and the worker's
``MeshTransition`` run again here on the port's modules (the JAX module
re-pointed, as ``test_torch_control_plane.py`` does); the same event
sequences go to both packages' coordinators, each over a KV of its own,
and must give the same order bytes and the same actions. The migration
classes are the port's own, over ``ShardedLeaf`` states (a JAX device is
a rank here): the stats vocabulary, ``reshard_arrays`` and a live
migration from a virtual world of four processes. The servicer's
``report_reshard`` over the RPC transport, the ``note_node_running``
hook, the elastic trainer's hooks and the injector's ``node_lost`` and
``node_join`` close the module."""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import dlrover_tpu.reshard as jax_reshard
import dlrover_tpu.reshard.migrate as jax_migrate
import dlrover_tpu_torch.reshard as port_reshard
import dlrover_tpu_torch.telemetry as T
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.checkpoint import manifest as mf
from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.master.elastic_training.kv_store_service import (
    KVStoreService,
)
from dlrover_tpu_torch.master.servicer import create_master_service
from dlrover_tpu_torch.reshard import (
    KIND_GROW,
    KIND_SHRINK,
    TRANSITION_ORDER_KEY,
    MeshTransition,
    TransitionCoordinator,
    TransitionOrder,
)
from dlrover_tpu_torch.reshard.migrate import (
    LiveShardSource,
    empty_stats,
    merge_stats,
    migrate_from_checkpoint,
    migrate_live,
    reshard_arrays,
)
from dlrover_tpu_torch.telemetry.journal import EventJournal
from dlrover_tpu_torch.trainer.ckpt_store import ShardedLeaf

from tests.test_torch_control_plane import load_repointed
from tests.test_torch_llama import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_TESTS = load_repointed("test_reshard.py", "dlrover_tpu_torch")


@pytest.fixture(autouse=True)
def _fresh_journal():
    jr = T.set_default_journal(EventJournal(None))
    yield jr
    T.set_default_journal(EventJournal(None))


# the JAX module's classes on the port's modules (its imports re-pointed)
TestTransitionOrder = _JAX_TESTS.TestTransitionOrder
TestEnvGates = _JAX_TESTS.TestEnvGates
TestTransitionCoordinator = _JAX_TESTS.TestTransitionCoordinator
TestMeshTransition = _JAX_TESTS.TestMeshTransition
FakeKV = _JAX_TESTS.FakeKV
FakeMasterClient = _JAX_TESTS.FakeMasterClient


def test_the_repointed_classes_run_the_port():
    assert _JAX_TESTS.TransitionCoordinator is TransitionCoordinator
    assert _JAX_TESTS.MeshTransition is MeshTransition
    assert _JAX_TESTS.ReshardResponse is comm.ReshardResponse


# ------------------------------------------------ both coordinators alike

#: event sequences: ("running", r) | ("seal",) | ("lost", r) |
#: ("join", r) | ("phase", r, phase) on the active order | ("abort",) |
#: ("spare", r) registers a spare | ("tick", dt) the abort watchdog
SEQUENCES = {
    "shrink_then_grow": [
        ("running", 0), ("running", 1), ("seal",), ("lost", 1),
        ("phase", 0, "adopted"), ("phase", 0, "migrated"),
        ("phase", 0, "completed"), ("running", 2),
        ("phase", 0, "completed"), ("phase", 2, "completed"),
        ("running", 2)],
    "second_casualty_aborts": [
        ("running", 0), ("running", 1), ("running", 2), ("running", 3),
        ("seal",), ("lost", 2), ("phase", 0, "migrated"), ("lost", 1),
        ("running", 1), ("phase", 0, "completed")],
    "refusal_and_budget": [
        ("running", 0), ("running", 1), ("running", 2), ("seal",),
        ("lost", 2), ("phase", 1, "aborted"), ("running", 2), ("seal",),
        ("lost", 0), ("phase", 1, "completed"), ("phase", 2, "completed"),
        ("lost", 1)],
    "spare_promotion": [
        ("running", 0), ("running", 1), ("running", 2), ("seal",),
        ("spare", 7), ("running", 7), ("lost", 1), ("phase", 0, "completed"),
        ("phase", 2, "completed"), ("phase", 7, "completed"), ("lost", 2),
        ("join", 9)],
    "watchdog": [
        ("running", 0), ("running", 1), ("seal",), ("join", 4),
        ("tick", 5.0), ("phase", 4, "completed"), ("tick", 200.0),
        ("join", 4), ("lost", 4)],
}


def _drive(pkg, events, max_transitions=2):
    """One coordinator of ``pkg`` over a FakeKV: (each event's order
    JSON or action, each broadcast's bytes, the final world and count)."""
    kv = FakeKV()
    fallbacks = []
    coord = pkg.TransitionCoordinator(
        kv, max_transitions=max_transitions, abort_timeout=120.0,
        fallback_fn=lambda o: fallbacks.append(o.to_json()))
    out, wire, t0 = [], [], 0.0
    import time as _time

    for ev in events:
        kind = ev[0]
        if kind == "running":
            got = coord.note_node_running(ev[1])
        elif kind == "seal":
            got = coord.seal_world()
        elif kind == "lost":
            got = coord.note_node_lost(ev[1], reason="drill")
        elif kind == "join":
            got = coord.note_node_join(ev[1], reason="drill")
        elif kind == "abort":
            got = coord.abort("drill")
        elif kind == "spare":
            kv.set(f"{pkg.SPARE_KEY_PREFIX}{ev[1]}", b"{}")
            got = None
        elif kind == "tick":
            t0 += ev[1]
            got = coord.check_abort(now=_time.time() + t0)
        else:
            active = coord.active_order
            got = coord.note_worker_phase(
                ev[1], active.id if active else 0, ev[2])
        out.append(got.to_json() if hasattr(got, "to_json") else got)
        wire.append(kv.data.get(pkg.TRANSITION_ORDER_KEY))
    return out, wire, coord.world, coord.transitions_done, fallbacks


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_coordinators_cut_the_same_orders(name):
    jax_run = _drive(jax_reshard, SEQUENCES[name])
    port_run = _drive(port_reshard, SEQUENCES[name])
    assert port_run == jax_run
    assert any(w for w in port_run[1])  # an order went on the wire


def test_order_bytes_equal_for_the_same_fields():
    fields = dict(id=3, kind="promote", step=120, old_world_size=4,
                  world_size=4, survivors=[0, 1, 3, 7], lost=[2],
                  joined=[7], reason="heartbeat", trace="ab-cd")
    assert (port_reshard.TransitionOrder(**fields).to_json()
            == jax_reshard.TransitionOrder(**fields).to_json())
    assert port_reshard.__all__ == jax_reshard.__all__


# ---------------------------------------------------------------- migration


def _leaf(shape, boxes, held, values, replicas=None):
    """A ShardedLeaf of ``values`` (the whole tensor) holding ``held``
    of ``boxes``, box i on rank i unless ``replicas`` says otherwise."""
    replicas = replicas or [[i] for i in range(len(boxes))]
    return ShardedLeaf(
        tuple(shape), values.dtype,
        [(boxes[i], values[tuple(slice(a, b) for a, b in boxes[i])].clone())
         for i in held],
        [{"idx": b, "replicas": r} for b, r in zip(boxes, replicas)])


class TestMigrate:
    def test_stats_vocabulary(self):
        stats = empty_stats()
        assert set(stats) == set(jax_migrate.empty_stats()) == {
            "live", "local", "peer", "store", "device",
            "digest_mismatch", "bytes",
        }
        merged = merge_stats({"peer": 1}, {"peer": 2, "bytes": 8}, None)
        assert merged == jax_migrate.merge_stats(
            {"peer": 1}, {"peer": 2, "bytes": 8}, None)
        assert merged["peer"] == 3 and merged["bytes"] == 8
        # a port restore record's tier, step and seconds are not counts
        assert merge_stats({"tier": "ram", "step": 4, "seconds": 0.5,
                            "live": 2})["live"] == 2

    def test_reshard_arrays_moves_only_what_changed(self):
        w = torch.arange(32, dtype=torch.float32).reshape(8, 4)
        halves = [[[0, 4], [0, 4]], [[4, 8], [0, 4]]]
        whole = [[[0, 8], [0, 4]]]
        state = {"w": _leaf((8, 4), whole, [0], w), "step": 3}
        # world 1 -> 2: this rank keeps the lower half, cut on the device
        target = {"w": _leaf((8, 4), halves, [0], torch.zeros(8, 4)),
                  "step": None}
        new_state, stats = reshard_arrays(state, target)
        assert stats["device"] == 1 and new_state["step"] == 3
        (box, t), = new_state["w"].pieces
        assert box == halves[0] and torch.equal(t, w[:4])
        assert new_state["w"].domains == target["w"].domains
        # already in the target layout: zero-copy, zero moves
        again, stats2 = reshard_arrays(new_state, target)
        assert stats2["device"] == 0
        assert again["w"].pieces[0][1] is new_state["w"].pieces[0][1]
        # 2 -> 1: the upper half is on another rank
        with pytest.raises(ValueError, match="not held"):
            reshard_arrays(new_state, {"w": state["w"], "step": None})

    def test_migrate_from_checkpoint_merges_loader_stats(self):
        class FakeCheckpointer:
            last_restore_stats = {"peer": 3, "store": 1, "bytes": 4096,
                                  "tier": "persistent", "step": 40}

            def restore(self, target=None, step=None,
                        extra_sources=None):
                return {"w": [1, 2]}, 40

        state, step, stats = migrate_from_checkpoint(FakeCheckpointer())
        assert state == {"w": [1, 2]} and step == 40
        assert stats["peer"] == 3 and stats["store"] == 1

    def test_migrate_from_checkpoint_nothing_restorable(self):
        class EmptyCheckpointer:
            def restore(self, target=None, step=None,
                        extra_sources=None):
                return None, None

        state, step, stats = migrate_from_checkpoint(EmptyCheckpointer())
        assert state is None and step is None
        assert stats == empty_stats()

    def test_live_source_serves_held_boxes_by_replica(self):
        w = torch.arange(32, dtype=torch.float32).reshape(8, 4)
        quarters = [[[2 * i, 2 * i + 2], [0, 4]] for i in range(4)]
        state = {"w": _leaf((8, 4), quarters, range(4), w),
                 "b": torch.ones(3)}
        src = LiveShardSource(state, step=5, held_fn=lambda r: r != 2)
        assert src.step == 5 and src.tier == "live"
        b, w_key = (mf.path_key([{"t": "dict", "k": k}]) for k in "bw")
        assert src.fetch(b, "full", None) is state["b"]
        served = [i for i, box in enumerate(quarters)
                  if src.fetch(w_key, mf.index_key(box), None) is not None]
        assert served == [0, 1, 3]  # rank 2's box did not survive


def _saved_world(tmp_path, step=7):
    """Four virtual processes flash-save one row-sharded tensor (two
    rows each; the JAX test's (dp 4) layout); returns the state the
    virtual world holds (every box)."""
    from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer

    w = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    quarters = [[[2 * i, 2 * i + 2], [0, 4]] for i in range(4)]
    ckpts = [
        FlashCheckpointer(
            str(tmp_path / "store"), ram_dir=str(tmp_path / f"ram{p}"),
            persist_interval=1, process_index=p, n_processes=4,
            commit_timeout=60)
        for p in range(4)
    ]
    for p, c in enumerate(ckpts):
        c.save(step, {"w": _leaf((8, 4), quarters, [p], w), "step": step},
               force_persist=True)
    for c in ckpts:
        c.wait()
        c.close()
    return {"w": _leaf((8, 4), quarters, range(4), w), "step": step}, w


class TestLiveMigration:
    DEAD = 2  # the old process whose rows did not survive

    def _survivor_ckpt(self, tmp_path):
        from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer

        # the post-transition identity: one process over the whole
        # tensor, a fresh RAM dir -- only the store holds the dead
        # rank's rows
        return FlashCheckpointer(
            str(tmp_path / "store"), ram_dir=str(tmp_path / "ram-new"),
            persist_interval=0, process_index=0, n_processes=1)

    def _target(self):
        return {"w": _leaf((8, 4), [[[0, 8], [0, 4]]], [0],
                           torch.zeros(8, 4)), "step": -1}

    def test_survivor_shards_move_live(self, tmp_path):
        state, w = _saved_world(tmp_path, step=7)
        r = self._survivor_ckpt(tmp_path)
        got, step, stats = migrate_live(
            r, state, target=self._target(), step=7, live_step=7,
            held_fn=lambda rank: rank != self.DEAD)
        r.close()
        assert step == 7
        assert torch.equal(got["w"].pieces[0][1], w)
        assert got["step"] == 7
        # the survivors' rows moved in process, no npz round trip; only
        # the dead rank's rows needed a checkpoint tier
        assert stats["live"] == 3
        assert stats["local"] + stats["peer"] + stats["store"] == 1
        assert stats["digest_mismatch"] == 0

    def test_stale_live_state_is_skipped(self, tmp_path):
        state, w = _saved_world(tmp_path, step=7)
        r = self._survivor_ckpt(tmp_path)
        # the live state is one step AHEAD of the restore candidate:
        # serving it would mix steps -- the pinned source steps aside
        got, step, stats = migrate_live(
            r, state, target=self._target(), step=7, live_step=8,
            held_fn=lambda rank: rank != self.DEAD)
        r.close()
        assert step == 7 and stats["live"] == 0
        assert torch.equal(got["w"].pieces[0][1], w)

    def test_the_target_takes_the_saved_dtypes(self, tmp_path):
        from dlrover_tpu_torch.trainer import ckpt_store

        state, w = _saved_world(tmp_path, step=7)
        store = ckpt_store.get_store(str(tmp_path / "store"))
        assert list(ckpt_store.step_dtypes(store, 7).values()) == [
            "float32"]
        # a new trainer that would hold the leaf in bf16 (AdamW's
        # moments after one microbatch) restores the fp32 step as saved
        low = {"w": _leaf((8, 4), [[[0, 8], [0, 4]]], [0],
                          torch.zeros(8, 4, dtype=torch.bfloat16)),
               "step": -1}
        target = ckpt_store.with_dtypes(low, ckpt_store.step_dtypes(store, 7))
        assert target["w"].dtype == torch.float32
        assert target["w"].pieces[0][1].dtype == torch.float32
        assert target["w"].domains == low["w"].domains
        r = self._survivor_ckpt(tmp_path)
        got, step, stats = migrate_live(
            r, state, target=target, step=7, live_step=7,
            held_fn=lambda rank: rank != self.DEAD)
        r.close()
        assert step == 7 and stats["live"] == 3
        assert torch.equal(got["w"].pieces[0][1], w)


# ------------------------------------------------- servicer, client, hooks


def test_report_reshard_without_a_coordinator_answers_none():
    from dlrover_tpu_torch.master.servicer import MasterServicer

    resp = MasterServicer().handle("report_reshard", comm.ReshardReport(
        node_id=0, order_id=1, phase="completed"))
    assert resp.action == "none"


def test_a_transition_over_the_rpc_transport():
    """A servicer built with a coordinator (the distributed master's
    part played by the test): two RUNNING reports widen the world, a
    loss cuts a shrink order the survivor adopts over the KV RPC, and
    its reports over ``report_reshard`` complete it."""
    kv = KVStoreService()
    coord = TransitionCoordinator(kv, max_transitions=4)
    server, _ = create_master_service(0, kv_store=kv,
                                      transition_coordinator=coord)
    server.start()
    try:
        clients = [MasterClient(f"localhost:{server.port}", node_id=r,
                                node_type="worker") for r in (0, 1)]
        for c in clients:
            c.update_node_status("running")
        assert coord.world == [0, 1]
        coord.seal_world()
        order = coord.note_node_lost(1, reason="exit")
        mt = MeshTransition(clients[0], node_rank=0)
        got = mt.poll_order()
        assert got == order and got.kind == KIND_SHRINK
        assert mt.agree_step(got, lambda: 3) == 3
        assert mt.note_migrated(got, {"live": 2, "store": 2}) == "ok"
        assert mt.complete(got) == "ok"
        assert coord.transitions_done == 1 and coord.world == [0]
        # a joiner's RUNNING report on the sealed world cuts a grow
        joiner = MasterClient(f"localhost:{server.port}", node_id=2,
                              node_type="worker")
        joiner.update_node_status("running")
        grow = TransitionOrder.from_json(kv.get(TRANSITION_ORDER_KEY))
        assert grow.kind == KIND_GROW and grow.survivors == [0, 2]
        for c in clients + [joiner]:
            c.close()
    finally:
        server.stop(grace=0.5)


def test_elastic_trainer_adopts_orders_in_report_step(monkeypatch):
    from dlrover_tpu_torch.trainer.elastic import ElasticTrainer

    class Trainer:
        accum_steps = 1

        def set_accum_steps(self, n):
            self.accum_steps = n

    client = FakeMasterClient()
    monkeypatch.delenv("DLROVER_TPU_RESHARD", raising=False)
    elastic = ElasticTrainer(Trainer(), 2, 2, master_client=client)
    assert elastic.mesh_transition is not None
    assert elastic.pending_reshard() is None
    client.kv.set(TRANSITION_ORDER_KEY, _JAX_TESTS._shrink(
        survivors=(0,), lost=(1,)).to_json())
    elastic.report_step(1)
    assert elastic.pending_reshard().id == 1
    assert elastic.wait_reshard(0.1).id == 1
    monkeypatch.setenv("DLROVER_TPU_RESHARD", "0")
    off = ElasticTrainer(Trainer(), 2, 2, master_client=client)
    assert off.mesh_transition is None and off.pending_reshard() is None
    assert off.wait_reshard(0.1) is None


_VICTIM = textwrap.dedent("""
    import os
    from dlrover_tpu_torch.fault_tolerance.injection import FaultInjector
    os.setpgid(0, 0)
    inj = FaultInjector(os.environ["SPEC"], node_rank=int(os.environ["R"]))
    for step in range(1, 6):
        inj.maybe_inject(step)
        print(f"step {step}", flush=True)
""")


@pytest.mark.parametrize("rank,spec", [
    (1, "node_lost@3:host=1"), (0, "node_lost@3:host=1"),
    (0, "node_join@2,node_lost@4")])
def test_node_lost_kills_the_group_and_node_join_marks(rank, spec):
    proc = subprocess.run(
        [sys.executable, "-c", _VICTIM], cwd=REPO, capture_output=True,
        text=True, timeout=60, env={**os.environ, "SPEC": spec,
                                    "R": str(rank)})
    out = proc.stdout
    if spec.startswith("node_join"):
        assert "INJECTED NODE JOIN at step 2" in out
        assert proc.returncode == -9 and "step 3" in out
        assert "INJECTED NODE LOST at step 4" in out
        assert "step 4" not in out.splitlines()
    elif rank == 1:
        assert proc.returncode == -9  # SIGKILL, no relaunch code
        assert "INJECTED NODE LOST at step 3" in out
        assert out.splitlines()[:2] == ["step 1", "step 2"]
        assert "step 3" not in out.splitlines()
    else:  # another rank's fault
        assert proc.returncode == 0 and "step 5" in out
        assert "INJECTED" not in out


@pytest.mark.parametrize("strategy", ["ddp", "fsdp"])
def test_a_step_that_raises_in_its_update_flags_the_state(
        strategy, one_thread):  # noqa: F811
    """``ShardedTrainer.updating``: False after a whole step and after
    one that failed before its first in-place write (the state is the
    last finished step's, a live source for a mesh transition), True
    after one that raised inside its update (never live)."""
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.parallel.mesh import create_mesh
    from dlrover_tpu_torch.trainer.sharded import make_trainer_for_llama

    torch.manual_seed(0)
    t = make_trainer_for_llama(
        llama.llama_tiny(), device="cpu", strategy=strategy,
        mesh=create_mesh([("data", 1), ("fsdp", 1)], device="cpu"))
    t.init(seed=0)
    tokens = torch.randint(0, 256, (2, 17))
    batch = t.shard_batch(t.microbatch((tokens[:, :-1], tokens[:, 1:])))
    t.train_step(batch)
    assert not t.updating

    def fail_before():
        raise RuntimeError("a collective failed")

    t.before_update = fail_before
    with pytest.raises(RuntimeError):
        t.train_step(batch)
    assert not t.updating
    t.before_update = None
    step = t.optimizer.step

    def fail_inside(*args, **kwargs):
        step(*args, **kwargs)
        raise RuntimeError("a gather after the update failed")

    t.optimizer.step = fail_inside
    with pytest.raises(RuntimeError):
        t.train_step(batch)
    assert t.updating


def test_kinds_parse_alike():
    from dlrover_tpu.fault_tolerance import injection as jax_injection
    from dlrover_tpu_torch.fault_tolerance import injection

    for spec in ("node_lost@8:host=2", "node_join@12", "node_lost@now"):
        assert [json.dumps(f.__dict__) for f in injection.parse_spec(spec)
                ] == [json.dumps(f.__dict__)
                      for f in jax_injection.parse_spec(spec)]
    assert injection.RESHARD_KINDS == jax_injection.RESHARD_KINDS
