"""The port's elastic launcher on the CPU: the drills of the verify
recipe (a plain run, a crash and its resume) through ``python -m
dlrover_tpu_torch.trainer.elastic_run --standalone`` with the Llama
example at ``llama_tiny`` on ``--device cpu``, and the launcher's parts
-- the fault-injection grammar, the hang detector, the report lane's
delta tracker -- against the JAX package's. The hang drill and two
agents over one master are in ``test_torch_launcher_drills.py``."""

import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from dlrover_tpu.agent.status_reporter import DeltaTracker as JaxDeltaTracker
from dlrover_tpu.common import comm as jax_comm
from dlrover_tpu.fault_tolerance import hanging_detector as jax_hang
from dlrover_tpu.fault_tolerance import injection as jax_injection
from dlrover_tpu.telemetry import flight_recorder as jax_flight_recorder
from dlrover_tpu_torch.agent.elastic.training import (
    ElasticLaunchConfig,
    ElasticTrainingAgent,
)
from dlrover_tpu_torch.agent.master_client import LocalMasterClient
from dlrover_tpu_torch.agent.status_reporter import DeltaTracker
from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.fault_tolerance import hanging_detector, injection
from dlrover_tpu_torch.telemetry import read_journal
from dlrover_tpu_torch.trainer import elastic_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join("dlrover_tpu_torch", "examples", "llama_train.py")


def launch(tmp, steps=12, save_interval=5, env=None, flags=(),
           timeout=120, example=()):
    """The launcher with a standalone master around the Llama example
    (``example``: more of its flags); returns (process, its stdout +
    stderr, the out file's fields)."""
    out = os.path.join(tmp, "out.txt")
    cmd = [
        sys.executable, "-m", "dlrover_tpu_torch.trainer.elastic_run",
        "--standalone", "--nnodes", "1:1", "--monitor_interval", "0.3",
        "--max_restarts", "2", *flags, EXAMPLE, "--",
        "--steps", str(steps), "--save-interval", str(save_interval),
        "--batch-size", "4", "--seq-len", "32", "--device", "cpu",
        "--ckpt-dir", os.path.join(tmp, "ckpt"), "--out", out, *example,
    ]
    full_env = {k: v for k, v in os.environ.items()
                if not k.startswith(("DLROVER_TPU_", "DLROVER_FAULT"))}
    full_env.update(env or {})
    proc = subprocess.run(cmd, cwd=REPO, env=full_env, timeout=timeout,
                          capture_output=True, text=True)
    text = proc.stdout + proc.stderr
    fields = (open(out).read().split(",") if os.path.exists(out)
              else None)
    return proc, text, fields


def step_losses(stdout: str):
    """The ``step k loss x`` lines, one dict per incarnation (a new
    incarnation starts where a step number does not grow)."""
    runs, last = [], None
    for k, x in re.findall(r"^step (\d+) loss (\S+)$", stdout, re.M):
        k = int(k)
        if last is None or k <= last:
            runs.append({})
        runs[-1][k] = float(x)
        last = k
    return runs


#: the module's launches: a plain run, and ``crash@8`` at one worker and
#: at two (``--nproc_per_node 2``, ``--strategy fsdp``)
_LAUNCHES = {
    "plain": {},
    1: {"env": {"DLROVER_FAULT_INJECT": "crash@8"}},
    2: {"env": {"DLROVER_FAULT_INJECT": "crash@8"},
        "flags": ("--nproc_per_node", "2"),
        "example": ("--strategy", "fsdp")},
}


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Each of _LAUNCHES, all run together (each launcher with a master
    of its own, on a directory of its own, its journal on):
    {key: (launch()'s result, the journal's path)}."""
    def run(key):
        tmp = tmp_path_factory.mktemp(f"launch_{key}")
        journal = str(tmp / "journal.jsonl")
        kwargs = dict(_LAUNCHES[key])
        env = {**kwargs.pop("env", {}), "DLROVER_TPU_JOURNAL": journal}
        return launch(str(tmp), env=env, **kwargs), journal

    with ThreadPoolExecutor(len(_LAUNCHES)) as pool:
        return dict(zip(_LAUNCHES, pool.map(run, _LAUNCHES)))


def test_plain_run_ends_with_final(launches):
    (proc, text, fields), _ = launches["plain"]
    assert proc.returncode == 0, text[-3000:]
    assert "FINAL step=12" in proc.stdout
    assert "DEVICE cpu" in proc.stdout
    step, loss, start = fields
    assert int(step) == 12 and int(start) == 0
    assert 0 < float(loss) < 10
    (losses,) = step_losses(proc.stdout)
    assert sorted(losses) == list(range(1, 13))


def _per_rank_steps(events):
    """{rank: [{step: loss} of each incarnation]} from the journal's
    ``train.step`` events, a process's rank from its
    ``distributed.init``."""
    rank = {e["pid"]: e["data"]["rank"] for e in events
            if e["kind"] == "distributed.init"}
    runs = {}
    for e in events:
        if e["kind"] == "train.step":
            by_pid = runs.setdefault(rank[e["pid"]], {})
            by_pid.setdefault(e["pid"], {})[e["data"]["step"]] = \
                e["data"]["loss"]
    return {r: list(pids.values()) for r, pids in runs.items()}


@pytest.mark.parametrize("nproc", [1, 2])
def test_crash_drill_restores_and_replays_bitwise(launches, nproc):
    """``crash@8``: the worker dies after step 8's update, the agent
    restarts it, it restores the step-5 checkpoint, trains steps 6-12
    and the launcher exits 0. Steps 6 and 7 ran in both incarnations,
    with the same losses to the last bit. At ``--nproc_per_node 2`` the
    two workers train ``--strategy fsdp`` over a gloo group of two, save
    their own shards, both crash and come back, and each restores its
    shards of step 5."""
    (proc, text, fields), journal = launches[nproc]
    assert proc.returncode == 0, text[-3000:]
    assert "INJECTED CRASH rc=17 at step 8" in proc.stdout
    assert proc.stdout.count("RESTORED from step 5") == nproc
    assert proc.stdout.count("FINAL step=12") == nproc
    assert int(fields[0]) == 12 and int(fields[2]) == 5
    events = read_journal(journal)
    if nproc == 2:
        runs = _per_rank_steps(events)
        assert sorted(runs) == [0, 1]
        for first, second in runs.values():
            assert sorted(first) == list(range(1, 8))
            assert sorted(second) == list(range(6, 13))
            assert {k: second[k] for k in (6, 7)} == {
                k: first[k] for k in (6, 7)}
        assert runs[0] == runs[1]  # the loss is the global batch's
        saves = [e for e in events if e["kind"] == "checkpoint.save"]
        assert {e["data"]["tier"] for e in saves} == {"ram"}
        return
    first, second = step_losses(proc.stdout)
    assert sorted(first) == list(range(1, 8))
    assert sorted(second) == list(range(6, 13))
    assert {k: second[k] for k in (6, 7)} == {k: first[k] for k in (6, 7)}
    # one journal of master, agent and both workers, in causal order,
    # with the marks a recovery's timeline is read from
    kinds = [e["kind"] for e in events]
    order = ["checkpoint.save", "fault.injected", "scale.restart",
             "checkpoint.restore"]
    assert all(k in kinds for k in order), kinds
    assert [kinds.index(k) for k in order] == sorted(
        kinds.index(k) for k in order)
    assert kinds.count("rendezvous.joined") == 2
    assert kinds.count("train.model_ready") == 2
    crash = events[kinds.index("fault.injected")]
    restart = events[kinds.index("scale.restart")]
    joined = [e for e in events if e["kind"] == "rendezvous.joined"][1]
    ready = [e for e in events if e["kind"] == "train.model_ready"][1]
    restore = events[kinds.index("checkpoint.restore")]
    after = next(e for e in events if e["kind"] == "train.step"
                 and e["ts"] > restore["ts"])
    assert after["data"]["step"] == restore["data"]["step"] + 1 == 6
    times = [crash["ts"], restart["ts"], joined["ts"], ready["ts"],
             restore["ts"], after["ts"]]
    assert times == sorted(times)
    assert restart["data"]["reason"] == "process_failure"
    assert ready["data"]["device"] == "cpu"
    assert len({e["pid"] for e in events}) >= 4  # master, agent, workers


def test_launcher_refuses_what_is_not_ported():
    args = elastic_run.parse_args(["--relay_fanout", "4", EXAMPLE])
    with pytest.raises(NotImplementedError, match="relay tier"):
        elastic_run.run(args)
    # several workers per node and the network check are ported
    # (test_torch_launcher_nproc.py, test_torch_network_check.py); a
    # node without a worker is refused
    config = ElasticLaunchConfig(nproc_per_node=0, entrypoint=EXAMPLE)
    with pytest.raises(ValueError, match="at least one worker"):
        ElasticTrainingAgent(config, LocalMasterClient())


# ------------------------------------------------ fault injection grammar

SPECS = [
    "crash@15", "crash@15:3", "hang@8", "hang@8:120!", "oom@5",
    "error@5:boom", "crash@3,hang@9:2", "sdc@5:flip=2,host=1",
    "hang@now:30", "preempt@12:notice=10", "nan@4", "master_crash@5:2",
]


def _faults(module, spec):
    return [(f.kind, f.step, f.arg, f.every_incarnation)
            for f in module.parse_spec(spec)]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_spec_parses_as_in_jax(spec):
    assert _faults(injection, spec) == _faults(jax_injection, spec)


@pytest.mark.parametrize("spec", ["bogus@3", "crash", "=x"])
def test_bad_fault_spec_is_refused_as_in_jax(spec):
    with pytest.raises(ValueError):
        jax_injection.parse_spec(spec)
    with pytest.raises(ValueError):
        injection.parse_spec(spec)


@pytest.mark.parametrize("kind", sorted(injection.WAITS_FOR))
def test_kinds_not_ported_raise_when_due(kind):
    inj = injection.FaultInjector(f"{kind}@2")
    inj.maybe_inject(1)
    with pytest.raises(NotImplementedError,
                       match=re.escape(injection.WAITS_FOR[kind])):
        inj.maybe_inject(2)


def test_faults_fire_once_on_the_first_incarnation_only():
    inj = injection.FaultInjector("error@2:boom,oom@3!", restart_count=0)
    with pytest.raises(RuntimeError, match="boom"):
        inj.maybe_inject(2)
    inj.maybe_inject(2)  # fired already
    with pytest.raises(MemoryError):
        inj.maybe_inject(3)
    relaunched = injection.FaultInjector("error@2:boom,oom@3!",
                                         restart_count=1)
    relaunched.maybe_inject(2)  # the first-incarnation fault is gone
    with pytest.raises(MemoryError):
        relaunched.maybe_inject(3)


def test_fault_injected_over_the_kv_store():
    client = LocalMasterClient()
    inj = injection.FaultInjector(master_client=client, node_rank=0,
                                  poll_every=2)
    client.kv_store_set("fault_inject/0", b"error@now:remote")
    inj.maybe_inject(1)  # not a poll step
    with pytest.raises(RuntimeError, match="remote"):
        inj.maybe_inject(2)
    assert client.kv_store_get("fault_inject/0") == b""  # consumed


def test_from_env_reads_the_agent_contract(monkeypatch):
    monkeypatch.delenv(injection.ENV_SPEC, raising=False)
    assert injection.FaultInjector.from_env() is None
    monkeypatch.setenv(injection.ENV_SPEC, "error@4")
    monkeypatch.setenv(NodeEnv.RESTART_COUNT, "1")
    inj = injection.FaultInjector.from_env()
    inj.maybe_inject(4)  # a relaunch: the drill's fault stays quiet
    monkeypatch.setenv(NodeEnv.RESTART_COUNT, "0")
    with pytest.raises(RuntimeError):
        injection.FaultInjector.from_env().maybe_inject(4)


# ---------------------------------------------------------- hang detector


def _hang_trace(module, monkeypatch, gaps):
    """(timeout, stalled?) after each step of a loop whose steps take
    ``gaps`` seconds, on a fake clock; then whether a 30 s stall trips."""
    # the JAX detector's flight record stays off: the port has none
    monkeypatch.setenv(jax_flight_recorder.ENV_FLIGHT_RECORDER, "0")
    now = [100.0]
    monkeypatch.setattr(module.time, "monotonic", lambda: now[0])
    reports = []
    det = module.HangingDetector(report_fn=reports.append, min_timeout=3.0,
                                 multiplier=10.0)
    out = [(det.timeout(), det.is_hanged())]
    for step, gap in enumerate(gaps):
        now[0] += gap
        det.record_step(step)
        out.append((det.timeout(), det.is_hanged()))
    now[0] += 30.0
    det._check_once()
    det._check_once()  # one report per stall
    out.append((det.stalled_for(), det.is_hanged(), reports))
    return out


def test_hang_threshold_adapts_as_in_jax(monkeypatch):
    gaps = [5.0, 0.1, 0.1, 0.2, 0.5, 40.0, 0.4, 0.4, 0.3]
    want = _hang_trace(jax_hang, monkeypatch, gaps)
    got = _hang_trace(hanging_detector, monkeypatch, gaps)
    assert got == want
    assert got[-1][1] and got[-1][2] == [30.0]


# ----------------------------------------------------------- report lane


def _reports(cls, comm):
    tracker = cls(incarnation=2, job_id="job-a")
    out = []
    for i, (step, res, commit) in enumerate([
            (1, (10.0, 1000), True), (1, (12.0, 1010), True),
            (5, (30.0, 1010), False), (6, (30.0, 2000), True),
            (None, None, True)]):
        report = tracker.compose(1000.0 + i, step=step, pid=9,
                                 resource=res, host="h")
        out.append(json.loads(comm.serialize(report)))
        if commit:
            tracker.commit(report)
    tracker.request_full()
    out.append(json.loads(comm.serialize(tracker.compose(
        2000.0, step=6, pid=9, host="h"))))
    return out


def test_delta_reports_match_jax():
    got = _reports(DeltaTracker, comm)
    assert got == _reports(JaxDeltaTracker, jax_comm)
    assert [r["f"].get("has_resource", False) for r in got] == [
        True, False, True, True, False, False]


# ------------------------------------------------ the ElasticTrainer's hooks


def test_trainer_hooks_report_a_hang_and_end_with_the_trainer(monkeypatch):
    """Armed by a master client: a planted fault fires in
    ``report_step``, a stall is reported to the master as a HANG, and
    the detector's thread neither outlives the trainer nor keeps it
    alive."""
    import gc
    import threading
    import weakref

    from dlrover_tpu_torch.common.constants import TrainingExceptionLevel
    from dlrover_tpu_torch.trainer.elastic import ElasticTrainer

    class Client(LocalMasterClient):
        def __init__(self):
            super().__init__()
            self.failures = []
            self.reported = threading.Event()

        def report_failure(self, error_data, level, restart_count=0):
            self.failures.append((error_data, level))
            self.reported.set()

    class Trainer:
        accum_steps = 1

        def set_accum_steps(self, n):
            self.accum_steps = n

    monkeypatch.setenv("DLROVER_HANG_MIN_TIMEOUT", "0.2")
    monkeypatch.setenv(injection.ENV_SPEC, "error@3:planted")
    monkeypatch.delenv(NodeEnv.RESTART_COUNT, raising=False)
    client = Client()
    elastic = ElasticTrainer(Trainer(), 1, 1, master_client=client)
    detector = elastic._hang_detector
    elastic.report_step(1)
    elastic.report_step(2)
    with pytest.raises(RuntimeError, match="planted"):
        elastic.report_step(3)
    assert client.reported.wait(10)
    (message, level), = client.failures
    assert level == TrainingExceptionLevel.HANG
    assert "last step 3" in message
    trainer = weakref.ref(elastic)
    del elastic
    gc.collect()
    assert trainer() is None
    detector._thread.join(timeout=5)
    assert not detector._thread.is_alive()
