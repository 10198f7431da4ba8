"""The job's accounting across real process deaths, on the CPU: the
port's launcher runs the Llama example against a local master whose
``/goodput`` is polled while the job runs, with the journal on.

A crash (``crash@8``): the offline replay of the journal
(``telemetry.goodput.reconstruct``) attributes at least 95% of every
process's time, each process's phases sum to its elapsed time within
1%, the crash's fault window is recovered, and the gap between the two
incarnations of the worker is ``restart`` badput. The master's live
account -- polled at ``/goodput`` and journaled when it stops
(``goodput.job_summary``) -- sees the agent's ledger and both of the
worker's under node 0, and a fault window at each new incarnation. It
is not held to the restart badput: the agent's own ledger, which its
status reports carry under the same node id, may cover the crash gap
(the JAX package's aggregator does the same; ROADMAP.md, section C).

A preemption (``preempt@6``): the drain's final ``report_goodput`` is
accepted (its step is ok in ``preempt.drained``, and the master's final
account carries the ``preempt`` seconds that only that report holds),
the replay books ``preempt`` badput, and the SIGTERM leaves exactly one
flight record. The two drills run together."""

import json
import os
import socket
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest

from dlrover_tpu_torch.telemetry import goodput, read_journal
from dlrover_tpu_torch.trainer.elastic_run import launch_local_master

from tests.test_torch_launcher import launch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _drill(tmp, monkeypatch, fault, **kw):
    """One launch with ``fault`` injected and the journal on, against a
    master of its own whose metrics are on a pinned port: its
    ``/goodput`` is polled until the launch ends, and the master stops
    by itself once the worker has exited, journaling its final account.
    Flight records go under ``tmp/crash``. The master starts here (it
    takes the journal and the port from this process's environment);
    the launch runs when the returned function is called, which returns
    the launcher's process, its output, the journal's events and the
    last ``/goodput`` answer."""
    port = _free_port()
    journal = os.path.join(tmp, "journal.jsonl")
    monkeypatch.setenv("DLROVER_TPU_JOURNAL", journal)
    monkeypatch.setenv("DLROVER_TPU_METRICS_PORT", str(port))
    master, addr = launch_local_master(node_num=1)
    env = {"DLROVER_FAULT_INJECT": fault, "DLROVER_TPU_JOURNAL": journal,
           "DLROVER_TPU_CRASH_DIR": os.path.join(tmp, "crash"), **kw}

    def run():
        last, done = {}, threading.Event()

        def poll():
            while not done.is_set():
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/goodput",
                            timeout=2) as resp:
                        answer = json.loads(resp.read())
                    if answer.get("job"):
                        last["answer"] = answer
                except OSError:
                    pass
                done.wait(0.1)

        poller = threading.Thread(target=poll, daemon=True)
        poller.start()
        try:
            proc, text, _ = launch(tmp, save_interval=4, env=env,
                                   flags=("--master_addr", addr))
            master.wait(timeout=30)
        finally:
            done.set()
            poller.join(timeout=10)
            if master.poll() is None:
                master.kill()
                master.wait(timeout=30)
        events = read_journal(journal) if os.path.exists(journal) else []
        return proc, text, events, last.get("answer")

    return run


#: the module's two drills: (fault, extra environment)
_DRILLS = {"crash": ("crash@8", {}),
           "preempt": ("preempt@6:notice=10",
                       {"DLROVER_TPU_PREEMPT_NOTICE_BUDGET": "8"})}


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    """Both drills, run together, each against its own master (started
    one after the other: each takes this process's environment):
    {name: (its directory, _drill's result)}."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, (fault, kw) in _DRILLS.items():
            tmp = tmp_path_factory.mktemp(f"goodput_{name}")
            runs[name] = (tmp, _drill(str(tmp), mp, fault, **kw))
    with ThreadPoolExecutor(len(runs)) as pool:
        futures = {name: pool.submit(run) for name, (_, run) in runs.items()}
        return {name: (runs[name][0], f.result())
                for name, f in futures.items()}


def _final_account(events):
    """The master's account as it stopped (``goodput.job_summary``)."""
    summaries = [e["data"] for e in events
                 if e["kind"] == "goodput.job_summary"]
    assert len(summaries) == 1, summaries
    return summaries[0]


def _check_replay(report):
    for key, p in report["procs"].items():
        elapsed = p["elapsed_s"]
        total = sum(p["phases"].values())
        assert abs(total - elapsed) <= 0.01 * elapsed, key
        idle = p["phases"]["idle"]
        assert idle <= 0.05 * elapsed, (key, p["phases"])


def test_crash_drill_books_the_gap_as_restart(drills):
    _, (proc, text, events, live) = drills["crash"]
    assert proc.returncode == 0, text[-3000:]
    assert "RESTORED from step 4" in proc.stdout
    report = goodput.reconstruct(events)
    _check_replay(report)
    workers = [p for p in report["procs"].values() if p["node_id"] == 0]
    assert len(workers) == 2 and all(p["exact"] for p in workers)
    crash = [f for f in report["faults"] if f["cause"] == "crash"]
    assert len(crash) == 1 and crash[0]["recovered_ts"] is not None
    assert report["nodes"]["0"]["restart_gap_s"] > 0
    assert report["job"]["badput_s"]["restart"] >= (
        report["nodes"]["0"]["restart_gap_s"])
    assert report["job"]["mttr_s"] is not None
    # the master's live account: the agent's ledger and the workers'
    # under node 0 (the agent reports first), and in its final account
    # a worker_restart window at each new incarnation
    assert live is not None, text[-3000:]
    assert live["nodes"]["0"]["procs"] >= 2
    assert live["local"] is None  # the master arms no ledger itself
    final = _final_account(events)
    assert final["nodes"] == 1 and final["procs"] == 3
    assert final["faults"] == 2 and final["mttr_s"] > 0


def test_preempt_drill_closes_the_incarnation(drills):
    tmp_path, (proc, text, events, live) = drills["preempt"]
    assert proc.returncode == 21, text[-3000:]
    drained = [e for e in events if e["kind"] == "preempt.drained"]
    assert len(drained) == 1 and drained[0]["data"]["goodput"] is True
    report = goodput.reconstruct(events)
    _check_replay(report)
    assert report["job"]["badput_s"]["preempt"] > 0
    # only the drain's final snapshot carries the preempt seconds
    assert live is not None, text[-3000:]
    final = _final_account(events)
    assert final["badput_s"]["preempt"] > 0
    dumps = [e["data"] for e in events if e["kind"] == "flight.dumped"]
    assert [d["reason"] for d in dumps] == ["signal-SIGTERM"]
    records = os.listdir(tmp_path / "crash")
    assert len(records) == 1 and records[0].endswith("signal-SIGTERM")
    assert os.path.exists(os.path.join(dumps[0]["path"], "record.json"))
