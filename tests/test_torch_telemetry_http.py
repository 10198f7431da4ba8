"""The port's telemetry surface -- the HTTP endpoint, the dump CLI, the
flight recorder and the lock watch -- against the JAX package's.

Cases of ``tests/test_lockwatch.py`` run once per package (the port's
re-pointed); ``/metrics``, ``/healthz``, ``/fleet`` and ``/debug/stacks``
are read from a live server of each package; ``dump`` prints the same
report as the JAX CLI on the fixture journal; a stalled hang detector
and a SIGTERM each leave a flight record, the SIGTERM one without
breaking the drain's hold on the step or re-delivering the signal; and
the port's lock watch wraps only locks created in the port's own
modules and journals an inversion between two of them."""

import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from dlrover_tpu import telemetry as jax_telemetry
from dlrover_tpu.telemetry import dump as jax_dump
from dlrover_tpu.telemetry import http as jax_http
from dlrover_tpu.telemetry.journal import EventJournal as JaxEventJournal
from dlrover_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from dlrover_tpu_torch import telemetry
from dlrover_tpu_torch.fault_tolerance.drain import (
    DRAIN_EXIT_CODE,
    DrainCoordinator,
)
from dlrover_tpu_torch.fault_tolerance.hanging_detector import (
    HangingDetector,
)
from dlrover_tpu_torch.telemetry import dump, flight_recorder, lockwatch
from dlrover_tpu_torch.telemetry import http as port_http
from dlrover_tpu_torch.telemetry.journal import EventJournal
from dlrover_tpu_torch.telemetry.registry import MetricsRegistry

from tests.test_torch_control_plane import PACKAGES, run_repointed

FIXTURE = (Path(__file__).resolve().parent / "fixtures"
           / "goodput_journal.jsonl")
HTTP = {"dlrover_tpu": (jax_http, jax_telemetry, JaxEventJournal,
                        JaxRegistry),
        "dlrover_tpu_torch": (port_http, telemetry, EventJournal,
                              MetricsRegistry)}

LOCKWATCH_CASES = [
    "test_inversion_journals_cycle",
    "test_consistent_order_is_silent",
    "test_cross_thread_inversion",
    "test_long_hold_journals_once",
    "test_fast_hold_is_silent",
    "test_condition_wait_keeps_stack_honest",
    "test_rlock_reentry_adds_no_edges",
    "test_install_wraps_project_locks_only",
    "test_enabled_reads_env",
    "test_long_hold_threshold_from_env",
    "test_reentrancy_guard_skips_watchdog_work",
]


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("name", LOCKWATCH_CASES)
def test_jax_lockwatch_case_in_both_packages(name, pkg, request):
    run_repointed("test_lockwatch.py", pkg, name, request)


def _get(url):
    """(status, body) of a GET, error statuses included."""
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _serve(pkg, fn):
    """``fn(base_url, registry)`` against a fresh server of ``pkg``."""
    http, _, journal_cls, registry_cls = HTTP[pkg]
    reg = registry_cls()
    srv = http.MetricsServer(registry=reg, journal=journal_cls(None),
                             host="127.0.0.1").start()
    try:
        return fn(f"http://127.0.0.1:{srv.port}", reg)
    finally:
        srv.stop()


def test_metrics_and_fleet_answer_as_in_jax():
    def read(base, reg):
        reg.counter("drill_ticks_total", "ticks", ["kind"]).labels(
            kind="a").inc(3)
        reg.gauge("drill_depth", "depth").set(2.5)
        status, text = _get(base + "/metrics")
        _, js = _get(base + "/metrics.json")
        return (status, text, json.loads(js), _get(base + "/fleet"),
                _get(base + "/fleet.json"), _get(base + "/nope"))

    want = read_jax = _serve("dlrover_tpu", read)
    got = _serve("dlrover_tpu_torch", read)
    assert got == want
    assert got[0] == 200
    assert 'drill_ticks_total{kind="a"} 3' in got[1]
    assert got[3][0] == 404 and read_jax[4][0] == 404


def test_healthz_reports_an_attached_stalled_detector():
    detector = HangingDetector(min_timeout=0.2, multiplier=2.0,
                               check_interval=60.0)
    try:
        def read(base, _):
            port_http.attach_hang_detector(detector)
            healthy = _get(base + "/healthz")
            detector.record_step(1)
            detector.record_step(2)
            time.sleep(0.35)
            return healthy, _get(base + "/healthz")

        healthy, stalled = _serve("dlrover_tpu_torch", read)
    finally:
        port_http.set_health_check(None)
    assert healthy == (200, "ok\n")
    assert stalled[0] == 503
    body = json.loads(stalled[1])
    assert body["status"] == "degraded" and body["last_step"] == 2
    assert body["stalled_for"] >= 0.3 and body["threshold"] == 0.2


def test_debug_stacks_names_this_thread():
    status, text = _serve("dlrover_tpu_torch",
                          lambda base, _: _get(base + "/debug/stacks"))
    assert status == 200 and '--- Thread "MainThread"' in text


@pytest.mark.parametrize("args", [["--goodput"], ["--goodput", "--json"],
                                  [], ["--kind", "goodput"]])
def test_dump_prints_what_the_jax_cli_prints(args, capsys):
    assert jax_dump.main([str(FIXTURE)] + args) == 0
    want = capsys.readouterr()
    assert dump.main([str(FIXTURE)] + args) == 0
    got = capsys.readouterr()
    assert got.out == want.out and got.err == want.err
    if args[:1] == ["--goodput"]:
        assert "goodput" in got.out


@pytest.fixture()
def journal(tmp_path, monkeypatch):
    """A fresh port journal and registry, flight records under tmp."""
    monkeypatch.setenv(flight_recorder.ENV_CRASH_DIR, str(tmp_path))
    monkeypatch.delenv(flight_recorder.ENV_FLIGHT_RECORDER, raising=False)
    telemetry.set_default_registry(None)
    jr = telemetry.set_default_journal(EventJournal(None))
    yield jr
    telemetry.set_default_journal(EventJournal(None))
    telemetry.set_default_registry(None)


def _records(tmp_path):
    return sorted(p for p in tmp_path.iterdir()
                  if p.name.startswith("flight-"))


def test_a_stall_writes_a_flight_record_before_it_reports(journal,
                                                          tmp_path):
    reports = []

    def report(elapsed):
        # the record is on disk by the time the master hears of it
        reports.append((elapsed, _records(tmp_path)))

    detector = HangingDetector(report_fn=report, min_timeout=0.2,
                               multiplier=2.0, check_interval=0.05)
    detector.record_step(1)
    detector.record_step(2)
    detector.start()
    try:
        deadline = time.time() + 10
        while not reports and time.time() < deadline:
            time.sleep(0.05)
    finally:
        detector.stop()
    assert reports and len(reports[0][1]) == 1
    path = reports[0][1][0]
    assert "hang-step2" in path.name
    record = json.loads((path / "record.json").read_text())
    assert record["step"] == -1 or record["reason"].startswith("hang")
    assert {"threads", "spans", "journal", "metrics",
            "goodput"} <= set(record)
    assert (path / "stacks.txt").read_text().startswith("--- Thread")
    hang = journal.events("hang.detected")[-1]["data"]
    assert hang["flight_record"] == str(path)


def test_sigterm_dumps_then_the_drain_holds_the_step(journal, tmp_path):
    """The trainer's order: drain armed first, the recorder's hook
    second. A SIGTERM inside a step dumps at once, and the drain's
    handler, called from the recorder's, holds the notice to the step's
    end; nothing re-delivers the signal (this process lives on)."""
    exits = []
    d = DrainCoordinator(exit_fn=exits.append, notice_budget_s=5.0)
    assert d.arm()
    try:
        assert flight_recorder.install_signal_hook()
        d.hold()
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)  # the handler runs between two bytecodes
        assert d.pending and not exits
        assert len(_records(tmp_path)) == 1
        d.release()
    finally:
        flight_recorder.uninstall_signal_hook()
        d.disarm()
    assert exits == [DRAIN_EXIT_CODE]
    records = _records(tmp_path)
    assert len(records) == 1 and "signal-SIGTERM" in records[0].name
    kinds = [e["kind"] for e in journal.events()
             if e["kind"].split(".")[0] in ("flight", "preempt")]
    assert kinds[:2] == ["flight.dumped", "preempt.notice"]
    assert kinds[-1] == "preempt.drained"
    drained = journal.events("preempt.drained")[-1]["data"]
    assert drained["goodput"] is True  # no client: the step is a no-op


def test_a_drain_armed_after_the_recorder_dumps_in_its_place(journal,
                                                            tmp_path):
    """A second trainer in one process arms its drain over the
    recorder's hook: the drain's chain dumps a record itself instead of
    calling the recorder, which would hand the signal to the first
    drain."""
    exits = []
    first = DrainCoordinator(exit_fn=exits.append, notice_budget_s=5.0)
    second = DrainCoordinator(exit_fn=exits.append, notice_budget_s=5.0)
    assert first.arm()
    try:
        assert flight_recorder.install_signal_hook()
        assert second.arm()
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
    finally:
        second.disarm()
        flight_recorder.uninstall_signal_hook()
        first.disarm()
    assert exits == [DRAIN_EXIT_CODE]
    records = _records(tmp_path)
    assert len(records) == 1 and records[0].name.endswith("-preempt-drain")
    assert len(journal.events("preempt.drained")) == 1


def test_lockwatch_wraps_port_locks_only_and_journals_an_inversion(
        journal, monkeypatch):
    monkeypatch.setenv(lockwatch.ENV_LOCKWATCH, "1")
    seen = []
    telemetry.journal.add_tap(seen.append)
    watch = lockwatch.install()
    try:
        assert watch is lockwatch.current()
        port_registry = MetricsRegistry()  # a lock made in the port
        port_journal = EventJournal(None)  # another site of the port
        foreign = JaxRegistry()  # the JAX package's: not ours
        here = threading.Lock()
        assert isinstance(port_registry._lock, lockwatch._WatchedLock)
        assert isinstance(port_journal._lock, lockwatch._WatchedLock)
        assert not isinstance(foreign._lock, lockwatch._WatchedLock)
        assert not isinstance(here, lockwatch._WatchedLock)
        a, b = port_registry._lock, port_journal._lock
        with a:
            with b:
                pass
        with b:
            with a:
                pass
    finally:
        lockwatch.uninstall()
        telemetry.journal.remove_tap(seen.append)
    cycles = [e for e in seen if e["kind"] == "lockwatch.cycle"]
    assert len(cycles) == 1
    names = set(cycles[0]["data"]["cycle"])
    assert {n.split(":")[0] for n in names} == {"registry.py", "journal.py"}
    assert threading.Lock is lockwatch._ORIG_LOCK
