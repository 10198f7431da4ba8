"""The port's goodput ledger (``dlrover_tpu_torch/telemetry/goodput.py``)
against the JAX package's: the same inputs through both must give equal
results -- exactly, since both compute in Python floats.

Cases of the JAX package's ``tests/test_goodput.py`` run once per
package (the port's with its imports re-pointed); then seeded sequences
of ledger transitions, credits and steps with explicit timestamps, of
aggregator reports, faults and recoveries with a ``to_state`` /
``restore_state`` round trip, and ``reconstruct`` / ``render_report`` on
the committed fixture journal and on a seeded random stream drawn from
``EVENT_RULES``' events go through both packages, and the agent's
status reports carry the same goodput sections."""

import copy
import json
import time
from pathlib import Path

import numpy as np
import pytest

from dlrover_tpu import telemetry as jax_telemetry
from dlrover_tpu.agent.status_reporter import DeltaTracker as JaxDeltaTracker
from dlrover_tpu.common import comm as jax_comm
from dlrover_tpu.telemetry import goodput as jax_goodput
from dlrover_tpu.telemetry.journal import EventJournal as JaxEventJournal
from dlrover_tpu_torch import telemetry
from dlrover_tpu_torch.agent.status_reporter import DeltaTracker
from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.telemetry import goodput
from dlrover_tpu_torch.telemetry.journal import EventJournal

from tests.test_torch_control_plane import PACKAGES, run_repointed

FIXTURE = (Path(__file__).resolve().parent / "fixtures"
           / "goodput_journal.jsonl")
T0 = 1_700_000_000.0
#: (goodput module, telemetry package, journal class) per package
MODS = {
    "dlrover_tpu": (jax_goodput, jax_telemetry, JaxEventJournal),
    "dlrover_tpu_torch": (goodput, telemetry, EventJournal),
}


#: cases of tests/test_goodput.py that touch only what the port has (the
#: state-journal round trip waits for master/state_journal.py; the
#: resource monitor's case is test_torch_stats_profiler.py's, since the
#: port's device probe has another name)
REPOINTED = [
    "test_ledger_phases_sum_to_elapsed",
    "test_ledger_rejects_unknown_phase",
    "test_credit_clamps_to_open_interval",
    "test_resume_returns_to_interrupted_phase",
    "test_close_freezes_ledger",
    "test_on_step_enters_training",
    "test_hang_rule_relabels_stall_window",
    "test_rendezvous_join_credits_wait",
    "test_install_taps_existing_journal_events",
    "test_report_fields_empty_without_ledger",
    "test_report_fields_carries_snapshot",
    "test_aggregator_incarnation_gap_is_restart_badput",
    "test_aggregator_final_report_closes_incarnation",
    "test_aggregator_persist_rate_limited",
    "test_aggregator_never_raises_on_garbage",
    "test_reconstruct_exact_replays_breadcrumbs",
    "test_reconstruct_heuristic_pre_ledger_journal",
    "test_reconstruct_fault_windows_and_master_exclusion",
    "test_reconstruct_empty_and_irrelevant_events",
    "test_goodput_wire_messages_roundtrip",
    "test_servicer_feeds_goodput_aggregator",
    "test_http_goodput_endpoint",
    "test_http_journal_tail_is_bounded",
    "test_dump_goodput_cli_renders_fixture",
    "test_export_metrics_publishes_job_gauges",
]


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("name", REPOINTED)
def test_jax_goodput_case_in_both_packages(name, pkg, request):
    run_repointed("test_goodput.py", pkg, name, request)


@pytest.fixture()
def fresh(monkeypatch):
    """Both packages without a process ledger, each with an in-memory
    journal, and a clock the test sets (``clock[0]``)."""
    clock = [T0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    journals = {}
    for pkg, (gp, tel, journal_cls) in MODS.items():
        gp.reset_default_ledger()
        gp.set_job_provider(None)
        journals[pkg] = tel.set_default_journal(journal_cls(None))
    yield clock, journals
    for gp, tel, journal_cls in MODS.values():
        gp.reset_default_ledger()
        gp.set_job_provider(None)
        tel.set_default_journal(journal_cls(None))


def test_vocabularies_are_equal():
    assert goodput.PHASES == jax_goodput.PHASES
    assert goodput.BADPUT_CAUSES == jax_goodput.BADPUT_CAUSES
    assert list(goodput.EVENT_RULES) == list(jax_goodput.EVENT_RULES)
    assert goodput._HEURISTIC_KINDS == jax_goodput._HEURISTIC_KINDS
    assert {k: v for k, v in vars(goodput.Phase).items()
            if not k.startswith("_")} == {
        k: v for k, v in vars(jax_goodput.Phase).items()
        if not k.startswith("_")}


def _ledger_ops(seed: int, n: int = 60):
    """A seeded sequence of (op, args, dt) on a ledger."""
    rng = np.random.default_rng(seed)
    phases = list(goodput.PHASES)
    ops = []
    for _ in range(n):
        kind = rng.choice(["transition", "credit", "on_step", "resume",
                           "rule"], p=[0.35, 0.2, 0.25, 0.1, 0.1])
        dt = float(np.round(rng.uniform(0.0, 3.0), 3))
        if kind == "transition":
            ops.append(("transition", phases[rng.integers(len(phases))],
                        dt))
        elif kind == "credit":
            ops.append(("credit", (phases[rng.integers(len(phases))],
                                   float(np.round(rng.uniform(0, 4), 3))),
                        dt))
        elif kind == "rule":
            ops.append(("rule", (list(goodput.EVENT_RULES)[
                rng.integers(len(goodput.EVENT_RULES))],
                float(np.round(rng.uniform(0, 2), 3))), dt))
        else:
            ops.append((kind, None, dt))
    return ops


def _drive_ledger(pkg, clock, ops):
    gp = MODS[pkg][0]
    led = gp.PhaseLedger(start_ts=T0)
    clock[0] = T0
    out = []
    for op, arg, dt in ops:
        clock[0] += dt
        if op == "transition":
            led.transition(arg)
        elif op == "credit":
            out.append(led.credit(*arg))
        elif op == "on_step":
            led.on_step()
        elif op == "resume":
            led.resume()
        else:
            kind, stalled = arg
            gp.EVENT_RULES[kind](led, clock[0], {"stalled_for": stalled})
        out.append(led.snapshot())
    clock[0] += 1.0
    out.append(led.close())
    clock[0] += 5.0
    out.append(led.snapshot())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ledger_sequences_are_equal(seed, fresh):
    """Transitions, credits, steps, resumes and the event rules, each at
    an explicit time: equal snapshots after every call, equal credited
    seconds, an equal close, and equal ``goodput.*`` breadcrumbs."""
    clock, journals = fresh
    ops = _ledger_ops(seed)
    want = _drive_ledger("dlrover_tpu", clock, ops)
    got = _drive_ledger("dlrover_tpu_torch", clock, ops)
    assert got == want

    def crumbs(journal):
        return [(e["kind"], e["data"]) for e in journal.events("goodput")]

    assert crumbs(journals["dlrover_tpu_torch"]) == crumbs(
        journals["dlrover_tpu"])
    assert crumbs(journals["dlrover_tpu_torch"])
    final = got[-1]
    assert sum(final["phases"].values()) == pytest.approx(
        final["elapsed_s"], rel=1e-6)


def _aggregator_ops(seed: int, n: int = 80):
    rng = np.random.default_rng(seed)
    causes = ["preempt", "rollback", "hang", "worker_restart"]
    pids = {node: [100 * node + 1] for node in range(3)}
    ops = []
    ts = T0
    for _ in range(n):
        ts += float(np.round(rng.uniform(0.1, 5.0), 3))
        kind = rng.choice(["report", "relaunch", "fault", "recover"],
                          p=[0.6, 0.1, 0.15, 0.15])
        node = int(rng.integers(3))
        if kind == "relaunch":
            pids[node].append(pids[node][-1] + 1)
            kind = "report"
        if kind == "report":
            pid = pids[node][-1]
            start = T0 + 10.0 * (pid % 100)
            elapsed = max(0.0, ts - start)
            split = rng.dirichlet(np.ones(4))
            phases = {p: float(np.round(elapsed * w, 6)) for p, w in zip(
                ("training", "init", "ckpt_stall", "rendezvous"), split)}
            ops.append(("report", dict(
                node_id=node, pid=pid, start_ts=start,
                elapsed_s=float(np.round(elapsed, 6)), phases=phases,
                phase="training", final=bool(rng.random() < 0.1),
                ts=ts, job="default" if rng.random() < 0.8 else "job-b")))
        elif kind == "fault":
            ops.append(("fault", dict(
                cause=causes[rng.integers(len(causes))], node_id=node,
                ts=ts)))
        else:
            ops.append(("recover", dict(
                cause=causes[rng.integers(len(causes))], ts=ts)))
    return ops


def _drive_aggregator(pkg, clock, ops):
    gp = MODS[pkg][0]
    agg = gp.GoodputAggregator()
    for op, kwargs in ops:
        clock[0] = kwargs["ts"]
        if op == "report":
            agg.observe_report(**kwargs)
        elif op == "fault":
            agg.note_fault(**kwargs)
        else:
            agg.mark_recovered(**kwargs)
    clock[0] += 2.0
    state = agg.to_state()
    restored = gp.GoodputAggregator()
    restored.restore_state(json.loads(json.dumps(state)),
                           now=clock[0] + 7.5)
    return (agg.summary(), agg.summary(job="job-b"), agg.jobs(), state,
            restored.summary())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aggregator_sequences_are_equal(seed, fresh):
    """Reports of several incarnations of three nodes in two jobs,
    faults and recoveries: equal summaries (whole and per job), equal
    ``to_state``, and equal summaries after a ``restore_state`` that
    books the master's downtime."""
    clock, _ = fresh
    ops = _aggregator_ops(seed)
    want = _drive_aggregator("dlrover_tpu", clock, ops)
    got = _drive_aggregator("dlrover_tpu_torch", clock, ops)
    assert got == want
    summary, _, _, _, restored = got
    assert summary["job"]["procs"] > 3 and summary["job"]["faults"] > 0
    assert restored["job"]["faults"] == summary["job"]["faults"] + 1


def _fixture_events():
    return [json.loads(line) for line in FIXTURE.read_text().splitlines()
            if line.strip()]


def test_reconstruct_and_render_the_fixture_alike():
    events = _fixture_events()
    want = jax_goodput.reconstruct(copy.deepcopy(events))
    got = goodput.reconstruct(copy.deepcopy(events))
    assert got == want
    assert goodput.render_report(got) == jax_goodput.render_report(want)
    assert goodput.dump_goodput(events, as_json=True) == (
        jax_goodput.dump_goodput(events, as_json=True))
    assert got["job"]["procs"] == 2


#: generic kinds the seeded stream draws besides EVENT_RULES' own
_EXTRA_KINDS = ("fault.injected", "fault.reported", "distributed.init",
                "checkpoint.save", "checkpoint.restore",
                "rollback.restored", "reshard.ordered", "reshard.completed",
                "master.restored", "train.step")


def _random_stream(seed: int, n: int = 300):
    rng = np.random.default_rng(seed)
    kinds = list(goodput.EVENT_RULES) + list(_EXTRA_KINDS)
    procs = [("host-a", 11, 0), ("host-a", 12, 0), ("host-b", 21, 1),
             ("host-b", 22, None), ("master", 31, None)]
    ledgered = {11, 21}
    phases = list(goodput.PHASES)
    events, ts = [], T0
    for seq in range(n):
        ts += float(np.round(rng.exponential(0.7), 4))
        host, pid, proc = procs[rng.integers(len(procs))]
        if pid in ledgered and rng.random() < 0.4:
            kind = rng.choice(["goodput.phase", "goodput.credit"])
            data = ({"phase": phases[rng.integers(len(phases))],
                     "prev": "", "at": ts} if kind == "goodput.phase"
                    else {"phase": phases[rng.integers(len(phases))],
                          "credit_s": float(np.round(rng.uniform(0, 2), 3)),
                          "at": ts})
        else:
            kind = kinds[rng.integers(len(kinds))]
            data = {
                "stalled_for": float(np.round(rng.uniform(0, 3), 2)),
                "fault": ["crash", "preempt", "master_crash", "nan"][
                    rng.integers(4)],
                "step": int(rng.integers(100)),
                "stall_ms": float(np.round(rng.uniform(0, 900), 1)),
                "lost": [int(rng.integers(2))] if rng.random() < 0.5
                else [],
            }
        events.append({"seq": seq, "ts": ts, "host": host, "pid": pid,
                       "proc": proc, "kind": str(kind), "data": data})
    # one ledgered process says goodbye with its own totals
    events.append({"seq": n, "ts": ts + 1.0, "host": "host-b", "pid": 21,
                   "proc": 1, "kind": "goodput.snapshot", "data": {
                       "phase": "training", "start_ts": T0,
                       "elapsed_s": ts + 1.0 - T0,
                       "phases": {"training": (ts + 1.0 - T0) / 2,
                                  "init": (ts + 1.0 - T0) / 2}}})
    return events


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_reconstruct_a_seeded_stream_alike(seed):
    """A random journal over five processes (two with breadcrumbs, two
    without, one master) and every kind ``EVENT_RULES`` and the fault
    windows read: equal reports, renderings and per-job splits."""
    events = _random_stream(seed)
    want = jax_goodput.reconstruct(copy.deepcopy(events))
    got = goodput.reconstruct(copy.deepcopy(events))
    assert got == want
    assert goodput.render_report(got) == jax_goodput.render_report(want)
    assert goodput.reconstruct(copy.deepcopy(events), job="default") == (
        jax_goodput.reconstruct(copy.deepcopy(events), job="default"))
    assert got["faults"] and got["job"]["procs"] >= 3
    assert {p["exact"] for p in got["procs"].values()} == {True, False}


def test_report_fields_and_http_payload_alike(fresh):
    """One install, a step and a stall at explicit times: the same wire
    fields, the same local snapshot and the same ``/goodput`` payload
    under the same job provider."""
    clock, _ = fresh
    out = {}
    for pkg, (gp, _, _) in MODS.items():
        clock[0] = T0
        led = gp.install()
        clock[0] = T0 + 3.0
        led.on_step()
        clock[0] = T0 + 9.0
        led.credit(gp.Phase.CKPT_STALL, 1.5)
        clock[0] = T0 + 10.0
        agg = gp.GoodputAggregator()
        agg.observe_report(node_id=0, pid=7, **{
            k.replace("goodput_", ""): v
            for k, v in gp.report_fields().items()
            if k != "goodput_phase"}, ts=clock[0])
        gp.set_job_provider(agg.summary)
        out[pkg] = (gp.report_fields(), gp.local_snapshot(),
                    gp.http_payload(), gp.http_payload(job="default"))
        gp.reset_default_ledger()
        gp.set_job_provider(None)
    assert out["dlrover_tpu_torch"] == out["dlrover_tpu"]
    fields = out["dlrover_tpu_torch"][0]
    assert fields["goodput_phases"]["ckpt_stall"] == 1.5
    assert out["dlrover_tpu_torch"][2]["job"]["training_s"] == 5.5


def _status_reports(tracker_cls, comm_mod, seed: int):
    """A seeded run of the agent's delta tracker with a goodput section:
    phase totals that creep or jump, a phase change, unacked reports, a
    forced full report and a final one."""
    rng = np.random.default_rng(seed)
    tracker = tracker_cls(incarnation=1, job_id="job-a")
    totals = {p: 0.0 for p in goodput.PHASES}
    phase, out = "init", []
    for i in range(16):
        totals[phase] += float(np.round(rng.choice([0.2, 0.5, 3.0]), 3))
        if rng.random() < 0.15:
            phase = "training"
        if i == 9:
            tracker.request_full()
        fields = {"goodput_phases": dict(totals),
                  "goodput_elapsed_s": sum(totals.values()),
                  "goodput_start_ts": T0, "goodput_phase": phase}
        report = tracker.compose(T0 + i, pid=9, goodput_fields=fields,
                                 host="h", final=i == 15)
        out.append(json.loads(comm_mod.serialize(report)))
        if rng.random() < 0.8:
            tracker.commit(report)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_status_reports_carry_the_goodput_section_as_in_jax(seed):
    """The agent's goodput section rides a report when the phase changed,
    a phase total moved by a second or more, the report is full or
    final, or eight reports skipped it: the same reports as the JAX
    package's tracker."""
    got = _status_reports(DeltaTracker, comm, seed)
    assert got == _status_reports(JaxDeltaTracker, jax_comm, seed)
    carried = [r["f"].get("has_goodput", False) for r in got]
    assert any(carried) and not all(carried)
