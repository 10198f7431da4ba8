"""The port's silent-failure sentinel against the JAX package's: the
worker-side ``TrainingSentinel``, the master's ``report_anomaly`` with
its quarantine, the ``last_good`` tag of the flash checkpoint and its
restore walk-down, and the ``nan``/``sdc`` fault kinds.

Three kinds of test: cases of ``tests/test_sentinel.py`` run once per
package (the port's run re-pointed at the port, as
``test_torch_control_plane.load_repointed`` does); the same inputs, made
from a numpy seed, through both packages, which must answer alike; and
one process drill, llama_tiny under ``elastic_run`` on the CPU, whose
injected NaN the master rolls back to the last clean save."""

import json
import math
import re
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu import telemetry as jax_telemetry
from dlrover_tpu.common import comm as jax_comm
from dlrover_tpu.fault_tolerance import injection as jax_injection
from dlrover_tpu.fault_tolerance.sentinel import (
    TrainingSentinel as JaxTrainingSentinel,
)
from dlrover_tpu.master.monitor.error_monitor import (
    ErrorMonitor as JaxErrorMonitor,
)
from dlrover_tpu.master.node.local_job_manager import (
    LocalJobManager as JaxLocalJobManager,
)
from dlrover_tpu.master.node.quarantine import (
    QuarantineManager as JaxQuarantineManager,
)
from dlrover_tpu.master.servicer import MasterServicer as JaxMasterServicer
from dlrover_tpu.telemetry.journal import EventJournal as JaxEventJournal
from dlrover_tpu.trainer import ckpt_store as jax_ckpt_store
from dlrover_tpu.trainer.checkpoint import (
    FlashCheckpointer as JaxFlashCheckpointer,
)
from dlrover_tpu.trainer.checkpoint import _local_shards
from dlrover_tpu_torch import telemetry
from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.fault_tolerance import injection
from dlrover_tpu_torch.fault_tolerance.sentinel import (
    ROLLBACK_ORDER_KEY,
    TrainingSentinel,
)
from dlrover_tpu_torch.master.monitor.error_monitor import ErrorMonitor
from dlrover_tpu_torch.master.node.local_job_manager import LocalJobManager
from dlrover_tpu_torch.master.node.quarantine import QuarantineManager
from dlrover_tpu_torch.master.servicer import MasterServicer
from dlrover_tpu_torch.telemetry import read_journal
from dlrover_tpu_torch.telemetry.journal import EventJournal
from dlrover_tpu_torch.trainer import ckpt_store
from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer

from tests.test_torch_control_plane import PACKAGES, run_repointed
from tests.test_torch_launcher import launch, step_losses

PKGS = {
    "dlrover_tpu": dict(
        sentinel=JaxTrainingSentinel, servicer=JaxMasterServicer,
        comm=jax_comm, error_monitor=JaxErrorMonitor,
        quarantine=JaxQuarantineManager, injection=jax_injection,
        telemetry=jax_telemetry, journal=JaxEventJournal),
    "dlrover_tpu_torch": dict(
        sentinel=TrainingSentinel, servicer=MasterServicer, comm=comm,
        error_monitor=ErrorMonitor, quarantine=QuarantineManager,
        injection=injection, telemetry=telemetry, journal=EventJournal),
}


@pytest.fixture(autouse=True)
def fresh_telemetry():
    for mods in PKGS.values():
        mods["telemetry"].set_default_registry(None)
        mods["telemetry"].set_default_journal(mods["journal"](None))
    yield
    for mods in PKGS.values():
        mods["telemetry"].set_default_registry(None)
        mods["telemetry"].set_default_journal(mods["journal"](None))


#: the journal's vocabulary of the sentinel, the servicer's anomaly and
#: preemption RPCs, the quarantine and the restore walk-down (background
#: threads that earlier tests left write other events into the same
#: journal)
SLICE_EVENTS = ("anomaly.", "rollback.", "preempt.", "quarantine.",
                "checkpoint.restore_fallback")


def _events(pkg, kind=None):
    """The default journal's events of ``pkg`` of this slice, as
    (kind, data) pairs."""
    evs = PKGS[pkg]["telemetry"].default_journal().events(kind)
    return [(e["kind"], e["data"]) for e in evs
            if e["kind"].startswith(SLICE_EVENTS)]


# ------------------------------------------------- re-pointed JAX tests

#: cases of tests/test_sentinel.py that need nothing outside this slice
REPOINTED = [
    # the worker-side detector and the rollback-order client
    "test_nonfinite_loss_trips",
    "test_nonfinite_grad_trips_before_loss",
    "test_spike_trips_after_warmup",
    "test_degenerate_constant_window",
    "test_anomaly_window_gates_note_checkpoint",
    "test_note_restored_resets_spike_baseline",
    "test_adopt_order_from_kv_exactly_once",
    "test_bad_order_json_is_ignored",
    "test_check_polls_order_on_step_cadence",
    "test_report_adopts_master_rollback_order",
    "test_report_job_failed_verdict",
    "test_report_quarantined_verdict_rides_the_rollback",
    "test_report_masterless_fallback",
    "test_from_env_knobs",
    # the master's report_anomaly and the quarantine
    "test_servicer_orders_rollback_and_recovers",
    "test_servicer_no_clean_checkpoint_means_no_rollback",
    "test_servicer_rollback_budget_exhausts_to_job_failed",
    "test_servicer_quarantines_repeat_offender_host",
    "test_quarantine_threshold_strikes_and_sink",
    "test_quarantine_disabled_and_anonymous",
    "test_quarantine_threshold_from_env",
    # the nan/sdc injection grammar
    "test_parse_spec_corruption_kinds",
    "test_parse_spec_kv_continuation_extends_previous_fault",
    "test_host_filter_scopes_corruption_to_one_rank",
    "test_corrupt_loss_fires_once_outside_maybe_inject",
    "test_sdc_flip_is_finite_but_wrong",
    "test_restart_count_gates_corruption_faults",
    "test_from_env_none_without_spec",
]


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("name", REPOINTED)
def test_jax_sentinel_case_in_both_packages(name, pkg, request):
    run_repointed("test_sentinel.py", pkg, name, request)


# --------------------------------------------------- the same inputs

def _loss_streams(seed: int):
    """Loss sequences from a numpy seed: noisy decays with planted
    spikes, a non-finite value, a flat stretch and a rollback."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(24, 48))
    losses = 3.0 * np.exp(-np.arange(n) / 30.0) + rng.normal(0, 0.05, n)
    for i in rng.choice(np.arange(18, n), 3, replace=False):
        losses[i] *= float(rng.choice([4.0, 30.0, 1.02]))
    stream = [float(x) for x in losses]
    stream[int(rng.integers(10, n))] = float(
        rng.choice([np.nan, np.inf, -np.inf]))
    return stream + [2.0] * 10 + [2.0 + float(rng.uniform(0.5, 4.0))]


def _trip_trace(pkg, stream):
    """What the sentinel answers at every step, with a save every 4
    steps and a restore after every trip."""
    s = PKGS[pkg]["sentinel"](window=16, zmax=4.0, min_steps=6)
    out = []
    for step, loss in enumerate(stream, 1):
        r = s.check(step, loss)
        out.append(r)
        if step % 4 == 0:
            s.note_checkpoint(step)
        if r is not None and step % 3 == 0:
            s.note_restored(s.last_good_step or 0, rollback_id=step)
        out.append((s.is_clean(), s.last_good_step, s.anomaly_count))
    return out, _events(pkg)


@pytest.mark.parametrize("seed", range(6))
def test_same_losses_give_the_same_trips_and_zscores(seed):
    stream = _loss_streams(seed)
    want = _trip_trace("dlrover_tpu", stream)
    got = _trip_trace("dlrover_tpu_torch", stream)
    assert got == want
    trips = [r for r in got[0][::2] if r is not None]
    assert {r["kind"] for r in trips} >= {"nonfinite_loss", "loss_spike"}
    assert any(r["zscore"] for r in trips)


W0 = dict(node_type="worker", node_id=0)
W1 = dict(node_type="worker", node_id=1)


def _reports(seed: int):
    """A sequence of anomaly reports, preemption notices and RUNNING
    reports from a numpy seed."""
    rng = np.random.default_rng(seed)
    kinds = ["nonfinite_loss", "nonfinite_grad", "loss_spike"]
    seq = []
    for i in range(int(rng.integers(10, 16))):
        w = (W0, W1)[int(rng.integers(0, 2))]
        pick = int(rng.integers(0, 4))
        if pick <= 1:
            seq.append(("report_anomaly", "AnomalyReport", dict(
                kind=kinds[int(rng.integers(0, 3))], step=10 + i,
                value=float(rng.normal()), zscore=float(rng.uniform(0, 9)),
                host=f"host-{int(rng.integers(0, 3))}",
                last_good_step=int(rng.integers(-1, 3)) * 4,
                restart_count=int(rng.integers(0, 2)), **w)))
        elif pick == 2:
            seq.append(("report_preemption", "PreemptionNotice", dict(
                reason="signal-sigterm", notice_budget_s=30.0,
                deadline_ts=1000.0 + i, restart_count=0, **w)))
        else:
            seq.append(("update_node_status", "NodeStatusRequest", dict(
                status="running", **w)))
        seq.append(("kv_store_get", "KVStoreGetRequest", dict(
            key=ROLLBACK_ORDER_KEY)))
    return seq


class _Rdzv:
    def __init__(self):
        self.removed = []

    def remove_alive_node(self, rank):
        self.removed.append(rank)

    def mark_node_succeeded(self, rank):
        pass


def _servicer_trace(pkg, seq, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_MAX_ROLLBACKS", "2")
    mods = PKGS[pkg]
    rdzv = _Rdzv()
    sv = mods["servicer"](
        rdzv_managers={"elastic-training": rdzv},
        error_monitor=mods["error_monitor"](
            quarantine=mods["quarantine"](threshold=3)))
    replies = []
    for method, msg, fields in seq:
        reply = sv.handle(method, getattr(mods["comm"], msg)(**fields))
        replies.append(json.loads(mods["comm"].serialize(reply)))
    return replies, rdzv.removed, _events(pkg)


@pytest.mark.parametrize("seed", range(4))
def test_same_reports_give_the_same_answers_and_kv_order(seed, monkeypatch):
    seq = _reports(seed)
    want = _servicer_trace("dlrover_tpu", seq, monkeypatch)
    got = _servicer_trace("dlrover_tpu_torch", seq, monkeypatch)
    assert got == want
    methods = [m for m, _, _ in seq]
    assert "report_anomaly" in methods and "report_preemption" in methods


def test_spent_budget_fails_the_job_under_the_local_job_manager(
        monkeypatch):
    """Under ``--platform local`` the JAX servicer calls the local job
    manager's ``mark_job_failed``, which it lacks, and the RPC raises;
    the port's answers ``job_failed`` (ROADMAP.md section C)."""
    monkeypatch.setenv("DLROVER_TPU_MAX_ROLLBACKS", "1")

    def run(pkg, job_manager):
        mods = PKGS[pkg]
        sv = mods["servicer"](job_manager=job_manager)
        report = getattr(mods["comm"], "AnomalyReport")(
            kind="nonfinite_loss", step=6, last_good_step=4, **W0)
        assert sv.handle("report_anomaly", report).action == "rollback"
        sv.handle("update_node_status", getattr(
            mods["comm"], "NodeStatusRequest")(status="running", **W0))
        return sv.handle("report_anomaly", report)

    with pytest.raises(AttributeError, match="mark_job_failed"):
        run("dlrover_tpu", JaxLocalJobManager())
    assert run("dlrover_tpu_torch", LocalJobManager()).action == "job_failed"
    (_, ev), = _events("dlrover_tpu_torch", "rollback.budget_exhausted")
    assert ev["rollbacks"] == 1 and ev["budget"] == 1


@pytest.mark.parametrize("seed", range(3))
def test_corrupt_loss_gives_the_same_bits(seed):
    rng = np.random.default_rng(seed)
    for loss in rng.lognormal(0.5, 1.0, 8):
        for flip in (0, 1, 2, 5, 10, 99):
            spec = f"sdc@3:flip={flip}"
            got = injection.FaultInjector(spec).corrupt_loss(3, float(loss))
            want = jax_injection.FaultInjector(spec).corrupt_loss(
                3, float(loss))
            assert struct.pack("<d", got) == struct.pack("<d", want)
            assert struct.pack("<d", got) != struct.pack("<d", loss)
        assert math.isnan(
            injection.FaultInjector("nan@3").corrupt_loss(3, float(loss)))


def test_only_four_kinds_still_wait_for_their_modules():
    assert sorted(injection.WAITS_FOR) == ["master_crash", "serve_kill"]
    assert injection.CORRUPTION_KINDS == jax_injection.CORRUPTION_KINDS


# ------------------------------------------------------ last_good tag

def _port_state(v):
    return {"w": torch.full((4,), float(v)), "step": int(v)}


def _jax_state(v):
    return {"w": jnp.full((4,), float(v), jnp.float32), "step": int(v)}


def _write(pkg, tmp, tags):
    """Saves at steps 2, 4, 6 tagged ``tags`` (persisted, sync staging)."""
    clean = [True]
    if pkg == "dlrover_tpu":
        ckpt = JaxFlashCheckpointer(
            persist_dir=str(tmp / "bucket"), ram_dir=str(tmp / "ram_w"),
            persist_interval=1, use_orbax=False, stage="sync")
        state = _jax_state
    else:
        ckpt = FlashCheckpointer(
            str(tmp / "bucket"), ram_dir=str(tmp / "ram_w"),
            persist_interval=1, stage="sync")
        state = _port_state
    ckpt.set_clean_fn(lambda: clean[0])
    for step, tag in zip((2, 4, 6), tags):
        clean[0] = tag
        ckpt.save(step, state(step), force_persist=True)
    ckpt.close()


def _read(pkg, tmp, name):
    """The steps an auto-restore and an explicit one pick, each
    archive's tag through ``archive_last_good`` and the COMMIT's through
    ``step_last_good``, read by ``pkg``."""
    store_mod = jax_ckpt_store if pkg == "dlrover_tpu" else ckpt_store
    if pkg == "dlrover_tpu":
        reader = JaxFlashCheckpointer(
            persist_dir=str(tmp / "bucket"), ram_dir=str(tmp / name),
            persist_interval=0, use_orbax=False)
    else:
        reader = FlashCheckpointer(str(tmp / "bucket"),
                                   ram_dir=str(tmp / name),
                                   persist_interval=0)
    store = store_mod.LocalFsStore(str(tmp / "bucket"))
    tags = {}
    for step in (2, 4, 6):
        with store.open_read(store_mod.step_key(step, 0)) as f:
            tags[step] = (store_mod.archive_last_good(f),
                          store_mod.step_last_good(store, step))
    state, auto = reader.restore()
    _, explicit = reader.restore(step=6)
    reader.close()
    return auto, int(state["step"]), explicit, tags


@pytest.mark.parametrize("tags", [(True, False, False), (True, True, False),
                                  (False, True, True)])
@pytest.mark.parametrize("writer", PACKAGES)
def test_tagged_archives_cross_read_and_walk_down_alike(writer, tags,
                                                        tmp_path):
    """Archives one package wrote with the tag read the same in the
    other: the same tags, and the restore walk-down skips the same
    steps (an explicit step is restored as asked)."""
    _write(writer, tmp_path, tags)
    got = [_read(pkg, tmp_path, f"ram_{pkg}") for pkg in PACKAGES]
    assert got[0] == got[1]
    auto, auto_state, explicit, read_tags = got[1]
    clean = [s for s, t in zip((2, 4, 6), tags) if t is not False]
    assert auto == auto_state == clean[-1] and explicit == 6
    assert read_tags == {s: (t, t) for s, t in zip((2, 4, 6), tags)}
    skipped = sorted(e["step"] for _, e in _events(
        "dlrover_tpu_torch", "checkpoint.restore_fallback")
        if e["reason"] == "anomaly_window")
    assert skipped == [s for s in (2, 4, 6) if s > auto]


def test_port_tags_the_ram_tier_too(tmp_path):
    """The writer's own RAM tier holds the tainted newest archive: the
    manifest peek rejects it before the persist walk-down, as in JAX."""
    port = FlashCheckpointer(str(tmp_path / "bucket"),
                             ram_dir=str(tmp_path / "ram"),
                             persist_interval=1, stage="sync")
    clean = [True]
    port.set_clean_fn(lambda: clean[0])
    port.save(2, _port_state(2))
    clean[0] = False
    port.save(4, _port_state(4))
    port.wait()
    with open(port._ram_path(4), "rb") as f:
        assert ckpt_store.archive_last_good(f) is False
        assert jax_ckpt_store.archive_last_good(f) is False
    state, step = port.restore()
    assert step == 2 and int(state["step"]) == 2
    tiers = {e["tier"] for _, e in _events(
        "dlrover_tpu_torch", "checkpoint.restore_fallback")
        if e["reason"] == "anomaly_window"}
    assert tiers == {"ram", "persistent"}
    port.close()
    with open(tmp_path / "jax.ckpt", "wb") as f:
        jax_ckpt_store.snapshot_to_file(_local_shards(_jax_state(1)), 1, f,
                                        last_good=False)
    with open(tmp_path / "jax.ckpt", "rb") as f:
        assert ckpt_store.archive_last_good(f) is False
        tree, step = ckpt_store.snapshot_from_file(f)
    assert step == 1 and torch.equal(tree["w"], torch.ones(4))


# ------------------------------------------------ the trainer's hooks

def test_trainer_feeds_the_sentinel_and_tags_its_saves(tmp_path,
                                                       monkeypatch):
    """``report_step`` routes the loss through ``corrupt_loss`` to the
    sentinel, a save inside the anomaly window is tagged, and a save's
    step becomes the last clean one only outside it."""
    from dlrover_tpu_torch.agent.master_client import LocalMasterClient
    from dlrover_tpu_torch.trainer.elastic import ElasticTrainer

    class Trainer:
        accum_steps = 1
        before_update = None

        def set_accum_steps(self, n):
            self.accum_steps = n

    monkeypatch.setenv(injection.ENV_SPEC, "nan@3")
    monkeypatch.delenv("DLROVER_TPU_RESTART_COUNT", raising=False)
    elastic = ElasticTrainer(Trainer(), 1, 1,
                             master_client=LocalMasterClient())
    ckpt = FlashCheckpointer(str(tmp_path / "p"),
                             ram_dir=str(tmp_path / "r"),
                             persist_interval=0, stage="sync")
    elastic.attach_checkpointer(ckpt, save_interval=2)
    try:
        for step in range(1, 5):
            elastic.report_step(step, loss=torch.tensor(1.0 / step))
            elastic.maybe_checkpoint(_port_state(step))
    finally:
        elastic.drain.disarm()
        ckpt.close()
    sentinel = elastic.sentinel
    assert sentinel.anomaly_count == 1 and not sentinel.is_clean()
    assert sentinel.last_good_step == 2
    tags = []
    for step in (2, 4):
        with open(ckpt._ram_path(step), "rb") as f:
            tags.append(ckpt_store.archive_last_good(f))
    assert tags == [True, False]
    (_, trip), = _events("dlrover_tpu_torch", "anomaly.detected")
    assert trip["anomaly"] == "nonfinite_loss" and trip["step"] == 3


# ------------------------------------------------------ process drill

def test_nan_drill_rolls_back_to_the_last_clean_save(tmp_path):
    """llama_tiny under the launcher with ``nan@10`` and saves every 4
    steps: the sentinel trips at step 10, the master orders a rollback
    to step 8, the worker restores it in place, replays step 9 to the
    last bit and ends at step 12 -- one process, no restart."""
    journal = str(tmp_path / "journal.jsonl")
    proc, text, fields = launch(str(tmp_path), steps=12, save_interval=4,
                                env={"DLROVER_FAULT_INJECT": "nan@10",
                                     "DLROVER_TPU_JOURNAL": journal})
    assert proc.returncode == 0, text[-3000:]
    assert "INJECTED NAN LOSS at step 10" in proc.stdout
    assert "ROLLBACK to step 8" in proc.stdout
    assert "FINAL step=12" in proc.stdout
    assert int(fields[0]) == 12 and int(fields[2]) == 0
    first, second = step_losses(proc.stdout)
    assert sorted(first) == list(range(1, 11))
    assert sorted(second) == [9, 10, 11, 12]
    assert math.isnan(first[10]) and math.isfinite(second[10])
    assert second[9] == first[9]
    events = read_journal(journal)
    kinds = [e["kind"] for e in events]
    order = ["fault.injected", "anomaly.detected", "anomaly.reported",
             "rollback.initiated", "rollback.ordered", "rollback.restored",
             "rollback.recovered"]
    assert all(k in kinds for k in order), kinds
    assert [kinds.index(k) for k in order] == sorted(
        kinds.index(k) for k in order)
    initiated = events[kinds.index("rollback.initiated")]["data"]
    assert initiated["step"] == 8 and initiated["anomaly"] == "nonfinite_loss"
    assert "scale.restart" not in kinds
    assert kinds.count("train.model_ready") == 1
    assert re.search(r"SENTINEL TRIP: nonfinite_loss at step 10 .*"
                     r"last_good=8", text)
