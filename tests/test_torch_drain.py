"""The port's preemption drain against the JAX package's: the
``DrainCoordinator`` sequence, the agent's side of it (exit code 21, the
DRAIN action) and the master's ``report_preemption``.

Cases of ``tests/test_drain.py`` run once per package (re-pointed at the
port as ``test_torch_control_plane.load_repointed`` does); the same stub
inputs through both coordinators must journal the same sequence; and
the port's own design is held where it differs from the JAX package's
(ROADMAP.md section C): a notice that lands inside a step drains at the
step's end, so the emergency save holds a whole step. One process
drill, llama_tiny under ``elastic_run`` on the CPU, is preempted and
relaunched from its emergency save.

Every test starts with SIGTERM at its default disposition and gets back
whatever was installed before: trainers of other modules arm drain
handlers of either package in this process."""

import os
import shutil
import signal
import subprocess
import sys
import time

import pytest
import torch

from dlrover_tpu import telemetry as jax_telemetry
from dlrover_tpu.fault_tolerance.drain import (
    DrainCoordinator as JaxDrainCoordinator,
)
from dlrover_tpu.telemetry.journal import EventJournal as JaxEventJournal
from dlrover_tpu_torch import telemetry
from dlrover_tpu_torch.agent.elastic.training import (
    ElasticLaunchConfig,
    ElasticTrainingAgent,
    WorkerState,
)
from dlrover_tpu_torch.agent.master_client import LocalMasterClient
from dlrover_tpu_torch.common.constants import (
    NodeAction,
    NodeExitReason,
    NodeStatus,
)
from dlrover_tpu_torch.examples import llama_train
from dlrover_tpu_torch.fault_tolerance import injection
from dlrover_tpu_torch.fault_tolerance.drain import (
    DRAIN_EXIT_CODE,
    DrainCoordinator,
)
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.telemetry import read_journal
from dlrover_tpu_torch.telemetry.journal import EventJournal
from dlrover_tpu_torch.trainer import ckpt_store
from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from dlrover_tpu_torch.trainer.sharded import adamw, make_trainer_for_llama

from tests.test_torch_control_plane import PACKAGES, run_repointed
from tests.test_torch_launcher import launch, step_losses
from tests.test_torch_llama import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def isolated():
    """SIGTERM at its default disposition and fresh telemetry of both
    packages for the test; the previous disposition afterwards."""
    prev = signal.signal(signal.SIGTERM, signal.SIG_DFL)
    for mod, journal in ((jax_telemetry, JaxEventJournal),
                         (telemetry, EventJournal)):
        mod.set_default_registry(None)
        mod.set_default_journal(journal(None))
    yield
    signal.signal(signal.SIGTERM, prev)


def _wait_for(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert cond()


# ------------------------------------------------- re-pointed JAX tests

#: cases of tests/test_drain.py that need nothing outside this slice
REPOINTED = [
    "test_notice_budget_from_env",
    "test_drain_never_blocks_past_the_deadline",
    "test_emergency_checkpoint_falls_back_to_ram_tier",
    "test_drain_survives_failing_dependencies",
    "test_arm_is_idempotent_and_disarm_restores",
    "test_sigterm_triggers_drain_and_distinct_exit_code",
    "test_chained_coordinator_never_double_drains",
]


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("name", REPOINTED)
def test_jax_drain_case_in_both_packages(name, pkg, request):
    run_repointed("test_drain.py", pkg, name, request)


class StubClient:
    """The master's side of the drain, recorded."""

    def __init__(self):
        self.calls = []

    def report_preemption(self, reason="", notice_budget_s=0.0,
                          deadline_ts=0.0, restart_count=0):
        self.calls.append(("report_preemption", reason, notice_budget_s,
                           restart_count))

    def relinquish_shards(self, dataset_name=""):
        self.calls.append(("relinquish_shards",))
        return 3

    def report_goodput(self, final=False):
        self.calls.append(("report_goodput", final))


class StubCkpt:
    def __init__(self, error=None):
        self.calls = []
        self.error = error

    def save(self, step, state, force_persist=False, durable=False):
        if self.error is not None:
            raise self.error
        self.calls.append(("save", step, state, force_persist, durable))
        return 1.0

    def wait(self):
        self.calls.append(("wait",))


#: journal fields that time the sequence, or that only the port records
_TIMED = {"remaining_s", "elapsed_s", "deferred", "ram_s", "persist_s",
          "pin_wait_s", "error", "goodput"}


def _sequence(cls, mod, budget, provided):
    client, ckpt = StubClient(), StubCkpt()
    d = cls(master_client_fn=lambda: client, checkpointer_fn=lambda: ckpt,
            state_provider=lambda: provided, notice_budget_s=budget,
            restart_count=2)
    result = d.drain(reason="unit-test")
    # preempt.* only: background threads that earlier tests left write
    # other events into the same journal
    events = [(e["kind"], {k: v for k, v in e["data"].items()
                           if k not in _TIMED})
              for e in mod.default_journal().events()
              if e["kind"].startswith("preempt.")]
    result = {k: {kk: vv for kk, vv in v.items() if kk != "error"}
              if isinstance(v, dict) else v
              for k, v in result.items()}
    return events, client.calls, ckpt.calls, result


@pytest.mark.parametrize("budget,provided", [
    (10.0, (7, {"w": 1})), (2.0, (4, {"w": 2})), (10.0, None)])
def test_same_notice_gives_the_same_sequence(budget, provided):
    """The same stubs through both coordinators: the same RPCs, the
    final goodput snapshot among them, the same save (durable above the
    floor, the RAM tier below it), the same journal and the same
    result, whose goodput step is ok."""
    want = _sequence(JaxDrainCoordinator, jax_telemetry, budget, provided)
    got = _sequence(DrainCoordinator, telemetry, budget, provided)
    assert got == want
    assert ("report_goodput", True) in got[1]
    assert got[3]["goodput"]["ok"] and "skipped" not in got[3]["goodput"]
    kinds = [k for k, _ in got[0]]
    assert kinds[0] == "preempt.notice" and kinds[-1] == "preempt.drained"


# ------------------------------------------------------ the step window

def _coordinator(exits, ckpt=None, provided=(5, {"w": 1}), budget=10.0,
                 stalled=lambda: False):
    client = StubClient()
    d = DrainCoordinator(
        master_client_fn=lambda: client,
        checkpointer_fn=lambda: ckpt,
        state_provider=lambda: provided() if callable(provided)
        else provided,
        notice_budget_s=budget, exit_fn=exits.append, stalled_fn=stalled)
    assert d.arm()
    return d, client


def test_notice_inside_a_step_drains_at_its_end():
    exits, ckpt = [], StubCkpt()
    step = [5]
    d, client = _coordinator(exits, ckpt,
                             provided=lambda: (step[0], {"w": step[0]}))
    try:
        d.hold()
        os.kill(os.getpid(), signal.SIGTERM)
        assert d.pending and not d.draining and exits == []
        assert client.calls == [] and ckpt.calls == []
        time.sleep(0.2)
        step[0] = 6  # the step ends
        d.release()
    finally:
        d.disarm()
    assert exits == [DRAIN_EXIT_CODE]
    assert ckpt.calls[0] == ("save", 6, {"w": 6}, True, True)
    jr = telemetry.default_journal()
    (notice,) = jr.events("preempt.notice")
    assert notice["data"]["deferred"] and notice["data"]["step"] == 5
    (drained,) = jr.events("preempt.drained")
    # the deadline counts from the notice, not from the step's end
    assert drained["data"]["remaining_s"] <= 10.0 - 0.2
    d.release()  # nothing pending any more
    assert exits == [DRAIN_EXIT_CODE]


def test_notice_between_steps_drains_at_once():
    exits, ckpt = [], StubCkpt()
    d, client = _coordinator(exits, ckpt)
    try:
        d.hold()
        d.release()
        os.kill(os.getpid(), signal.SIGTERM)
        _wait_for(lambda: exits)
    finally:
        d.disarm()
    assert exits == [DRAIN_EXIT_CODE] and not d.pending
    assert ckpt.calls[0] == ("save", 5, {"w": 1}, True, True)
    assert [c[0] for c in client.calls] == ["report_preemption",
                                            "relinquish_shards",
                                            "report_goodput"]


def test_notice_inside_a_stalled_step_drains_at_once_without_the_save():
    """A hung step never reaches its end, and its state is half
    updated: the drain reports and relinquishes at once, and saves
    nothing."""
    exits, ckpt = [], StubCkpt()
    d, client = _coordinator(exits, ckpt, stalled=lambda: True)
    try:
        d.hold()
        os.kill(os.getpid(), signal.SIGTERM)
        _wait_for(lambda: exits)
    finally:
        d.disarm()
    assert exits == [DRAIN_EXIT_CODE] and not d.pending
    assert ckpt.calls == []
    assert [c[0] for c in client.calls] == ["report_preemption",
                                            "relinquish_shards",
                                            "report_goodput"]


def test_preempt_kind_signals_its_own_process(monkeypatch):
    """The kind signals the whole group only from a group's leader (a
    worker the agent started in its own session); here the test runs as
    a process in its caller's group, so the rest of that group (a shell
    pipeline with job control, say) is left alone."""
    monkeypatch.setattr(injection.os, "getpgid", lambda pid: -1)
    exits = []
    d, _ = _coordinator(exits, StubCkpt())
    try:
        d.hold()
        injection.FaultInjector("preempt@2").maybe_inject(2)
        assert d.pending
        d.release()
    finally:
        d.disarm()
    assert exits == [DRAIN_EXIT_CODE]
    (fault,) = telemetry.default_journal().events("fault.injected")
    assert fault["data"]["fault"] == "preempt"


# ------------------------------------------- the trainer and the saves

def _tiny_trainer():
    trainer = make_trainer_for_llama(llama.llama_tiny(), device="cpu",
                                     optimizer=adamw(1e-3))
    trainer.init(seed=0)
    return trainer


def _batch(trainer, elastic, seed):
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, trainer.model.cfg.vocab_size, (4, 16),
                           generator=gen)
    return trainer.shard_batch(elastic.microbatch((tokens, tokens)))


def _flat(tree):
    return {ckpt_store._path_json(p): leaf
            for p, leaf in ckpt_store.flatten_with_path(tree)}


def test_mid_step_notice_archives_a_whole_step(tmp_path):
    """SIGTERM from inside ``before_update`` (between the backward pass
    and the optimizer's in-place writes): the emergency save waits for
    the step's end, so its parameters and both moments are those after
    the whole step -- not the first moment after it and the second
    before it."""
    trainer = _tiny_trainer()
    elastic = ElasticTrainer(trainer, max_nodes=1, cur_nodes=1,
                             master_client=LocalMasterClient())
    ckpt = FlashCheckpointer(str(tmp_path / "persist"),
                             ram_dir=str(tmp_path / "ram"),
                             persist_interval=0)
    elastic.attach_checkpointer(ckpt, save_interval=0)
    exits = []
    elastic.drain._exit_fn = exits.append
    wait_staged = trainer.before_update

    def before_update():
        if elastic.global_step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
            assert elastic.drain.pending
        wait_staged()

    trainer.before_update = before_update
    try:
        for step in (1, 2):
            loss = elastic.train_step(_batch(trainer, elastic, step))
            elastic.report_step(step, loss=loss)
            assert exits == []
            elastic.maybe_checkpoint(
                lambda: {**trainer.train_state(), "step": step})
        assert exits == [DRAIN_EXIT_CODE]
        live = _flat({**trainer.train_state(), "step": 2})
    finally:
        elastic.drain.disarm()
    restored, step = ckpt.restore()
    ckpt.close()
    assert step == 2
    archived = _flat(restored)
    assert archived.keys() == live.keys()
    for key, leaf in live.items():
        if isinstance(leaf, torch.Tensor):
            assert torch.equal(archived[key], leaf), key
        else:
            assert archived[key] == leaf, key
    assert restored["optimizer"]["count"] == 2
    with ckpt_store.open_step(ckpt._store, 2, 0) as f:
        assert ckpt_store.read_manifest(f)["step"] == 2


def test_notice_during_the_cadence_save_drains_after_it(tmp_path):
    """SIGTERM from inside ``FlashCheckpointer.save`` (its ``clean_fn``
    runs on the train thread between staging and submit): the drain
    waits for the cadence save to end, so the emergency save does not
    contend with it for the pinned block and the serializer, and lands
    the same step durable within the budget."""
    trainer = _tiny_trainer()
    elastic = ElasticTrainer(trainer, max_nodes=1, cur_nodes=1,
                             master_client=LocalMasterClient())
    ckpt = FlashCheckpointer(str(tmp_path / "persist"),
                             ram_dir=str(tmp_path / "ram"),
                             persist_interval=0)
    elastic.attach_checkpointer(ckpt, save_interval=2)
    exits = []
    elastic.drain._exit_fn = exits.append
    #: (notice pending, exits so far) just after the signal
    signalled = []

    def clean_fn():
        if elastic.global_step == 2 and not signalled:
            os.kill(os.getpid(), signal.SIGTERM)
            signalled.append((elastic.drain.pending, list(exits)))
        return True

    ckpt.set_clean_fn(clean_fn)
    try:
        for step in (1, 2):
            loss = elastic.train_step(_batch(trainer, elastic, step))
            elastic.report_step(step, loss=loss)
            elastic.maybe_checkpoint(
                lambda: {**trainer.train_state(), "step": step},
                durable=True)
        assert signalled == [(True, [])]
        assert exits == [DRAIN_EXIT_CODE]
    finally:
        elastic.drain.disarm()
        ckpt.close()
    journal = telemetry.default_journal()
    (notice,) = journal.events("preempt.notice")
    assert notice["data"]["deferred"]
    (eck,) = journal.events("preempt.emergency_ckpt")
    assert eck["data"]["ok"] and eck["data"]["durable"]
    assert not eck["data"]["timed_out"] and eck["data"]["step"] == 2
    # on the persist tier alone, as the replacement node finds it
    shutil.rmtree(tmp_path / "ram")
    fresh = FlashCheckpointer(str(tmp_path / "persist"))
    try:
        restored, step = fresh.restore()
    finally:
        fresh.close()
    assert step == 2 and restored["step"] == 2


def test_a_raising_save_reaches_the_caller_and_the_drain(tmp_path):
    """A failed device-to-host copy is raised into the step loop by
    ``maybe_checkpoint``; the drain's bounded emergency save journals
    the same error and the worker still exits 21."""
    trainer = _tiny_trainer()
    elastic = ElasticTrainer(trainer, max_nodes=1, cur_nodes=1)
    ckpt = FlashCheckpointer(str(tmp_path / "persist"),
                             ram_dir=str(tmp_path / "ram"),
                             persist_interval=0)
    elastic.attach_checkpointer(ckpt, save_interval=1)
    exits = []
    elastic.drain._exit_fn = exits.append
    error = "copy to the host failed: planted"
    try:
        elastic.report_step(1)
        ckpt._stage_error = RuntimeError(error)
        with pytest.raises(RuntimeError, match="device-to-host copy failed"):
            elastic.maybe_checkpoint(lambda: {**trainer.train_state(),
                                              "step": 1})
        ckpt._stage_error = RuntimeError(error)
        os.kill(os.getpid(), signal.SIGTERM)
        _wait_for(lambda: exits)
    finally:
        elastic.drain.disarm()
        ckpt.close()
    assert exits == [DRAIN_EXIT_CODE]
    (eck,) = telemetry.default_journal().events("preempt.emergency_ckpt")
    assert not eck["data"]["ok"] and eck["data"]["step"] == 1
    assert "device-to-host copy failed" in eck["data"]["error"]
    assert error in eck["data"]["error"]


def test_signal_chain_rule_holds_in_the_port():
    """Every ``signal.signal`` of the port captures or restores the
    prior disposition (the JAX package's dlint rule, on the port)."""
    from pathlib import Path

    from tools.dlint.core import lint_files
    from tools.dlint.rules import SignalChainRule

    files = sorted(Path(REPO, "dlrover_tpu_torch").rglob("*.py"))
    res = lint_files(files, rules=[SignalChainRule], respect_targets=False)
    assert not res.findings, "\n".join(
        f"{f.location()}: {f.message}" for f in res.findings)
    assert any("drain.py" in str(f) for f in files)


# --------------------------------------------------------- the agent

class _Master(LocalMasterClient):
    def __init__(self):
        super().__init__()
        self.statuses = []
        self.failures = []

    def update_node_status(self, status, exit_reason="", restart_count=0):
        self.statuses.append((status, exit_reason))

    def report_failure(self, error_data, level, restart_count=0):
        self.failures.append(error_data)

    def num_nodes_waiting(self):
        return 0


def _agent(master, code):
    agent = ElasticTrainingAgent(
        ElasticLaunchConfig(monitor_interval=0.05, max_restarts=2),
        master)
    starts = []

    def initialize():
        starts.append(time.time())
        agent._procs = [subprocess.Popen(
            [sys.executable, "-c", code], start_new_session=True)]

    agent._initialize_workers = initialize
    return agent, starts


def test_agent_reports_a_drained_worker_preempted_without_a_restart():
    master = _Master()
    agent, starts = _agent(master, f"import sys; sys.exit({DRAIN_EXIT_CODE})")
    result = agent._invoke_run()
    assert result.state == WorkerState.FAILED
    assert result.return_code == DRAIN_EXIT_CODE
    assert len(starts) == 1 and agent._remaining_restarts == 2
    assert master.statuses == [(NodeStatus.FAILED, NodeExitReason.PREEMPTED)]
    assert master.failures == []
    assert telemetry.default_journal().events("preempt.worker_exit")
    assert not telemetry.default_journal().events("scale.restart")


def test_agent_drain_action_sends_the_worker_group_sigterm():
    agent, _ = _agent(_Master(), "import time; time.sleep(30)")
    agent._initialize_workers()
    try:
        agent._handle_master_action(NodeAction.DRAIN)
        assert agent._procs[0].wait(timeout=10) == -signal.SIGTERM
    finally:
        if agent._procs[0].poll() is None:
            agent._procs[0].kill()
    assert telemetry.default_journal().events("preempt.drain_action")


# ------------------------------------------------------ process drill

def test_preempt_drill_exits_21_and_the_relaunch_resumes(tmp_path):
    """llama_tiny under the launcher with ``preempt@6:notice=10``: the
    worker drains at the end of step 6 -- the master told, a durable
    emergency save on the persist tier, its shards handed back -- and
    exits 21; the agent reports it PREEMPTED without a restart and the
    launcher exits 21. With the RAM tier gone, as a reclaimed host's
    tmpfs, the replacement (the example run in this process) restores
    step 6 from the persist tier and trains to step 12."""
    journal = str(tmp_path / "journal.jsonl")
    proc, text, _ = launch(str(tmp_path), steps=12, save_interval=4, env={
        "DLROVER_FAULT_INJECT": "preempt@6:notice=10",
        "DLROVER_TPU_PREEMPT_NOTICE_BUDGET": "8",
        "DLROVER_TPU_JOURNAL": journal})
    assert proc.returncode == DRAIN_EXIT_CODE, text[-3000:]
    assert "INJECTED PREEMPTION at step 6" in proc.stdout
    assert "INJECTED RECLAIM" not in proc.stdout
    assert "Worker drained gracefully (rc=21)" in text
    (first,) = step_losses(proc.stdout)
    assert sorted(first) == list(range(1, 7))
    events = read_journal(journal)
    kinds = [e["kind"] for e in events]
    order = ["fault.injected", "preempt.notice", "preempt.reported",
             "preempt.emergency_ckpt", "preempt.relinquished",
             "preempt.drained", "preempt.worker_exit"]
    assert all(k in kinds for k in order), kinds
    assert [kinds.index(k) for k in order] == sorted(
        kinds.index(k) for k in order)
    assert "scale.restart" not in kinds
    eck = events[kinds.index("preempt.emergency_ckpt")]["data"]
    assert eck["ok"] and eck["durable"] and not eck["timed_out"]
    assert eck["step"] == 6
    notice = events[kinds.index("preempt.notice")]["data"]
    assert notice["deferred"] and notice["notice_budget_s"] == 8.0

    shutil.rmtree(tmp_path / "ckpt" / "ram")
    telemetry.set_default_journal(EventJournal(None))
    result = llama_train.run(12, str(tmp_path / "ckpt"), batch_size=4,
                             seq_len=32, device="cpu", save_interval=4)
    assert result["start_step"] == 6 and result["step"] == 12
    (restore,) = telemetry.default_journal().events("checkpoint.restore")
    assert restore["data"]["tier"] == "persistent"
    assert [s for s, _ in result["shards"]] == [4 * k for k in range(6, 12)]
