"""The port's durable job state: ``util/state_store.py``,
``util/event_queue.py`` and ``master/state_journal.py`` against the JAX
package's, and the goodput aggregator's persistence through the journal
(``master/local_master.py``). The same operations go to both packages'
stores and journals; the files one writes are read by the other; the
aggregator's round trip mirrors
``tests/test_goodput.py::test_aggregator_state_roundtrip_counts_master_downtime``."""

import importlib
import json
import os
import threading

import pytest

from dlrover_tpu.master import state_journal as jax_journal
from dlrover_tpu.telemetry.goodput import GoodputAggregator as JaxAggregator
from dlrover_tpu.util import event_queue as jax_event_queue
from dlrover_tpu.util import state_store as jax_state_store
from dlrover_tpu_torch.master import state_journal
from dlrover_tpu_torch.telemetry.goodput import PHASES, GoodputAggregator
from dlrover_tpu_torch.util import event_queue, state_store

T0 = 1_700_000_000.0
PKGS = {"jax": (jax_state_store, jax_event_queue, jax_journal),
        "port": (state_store, event_queue, state_journal)}


def _phases(**kw):
    out = {p: 0.0 for p in PHASES}
    out.update(kw)
    return out


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path) as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _store_ops(store):
    store.set("a/x", {"v": 1, "l": [1, 2]})
    store.set("a/y", "text")
    store.set_many({"b/1": 1, "b/2": [True, None]})
    store.mutate("c", lambda v: (v or 0) + 5, default=0)
    store.mutate("c", lambda v: v * 3, default=0)
    store.delete("a/y")
    return {k: store.get(k) for k in store.keys()} | {
        "keys_a": store.keys("a/"), "missing": store.get("zz", "dflt")}


@pytest.mark.parametrize("backend", ["memory", "file"])
def test_store_ops_agree(backend, tmp_path):
    got = {}
    for name, (ss, _, _) in PKGS.items():
        path = str(tmp_path / name)
        store = (ss.MemoryStore() if backend == "memory"
                 else ss.FileStore(path))
        got[name] = _store_ops(store)
    assert got["port"] == got["jax"]
    assert got["port"]["c"] == 15 and got["port"]["keys_a"] == ["a/x"]
    if backend == "file":
        # the files on disk are the same bytes, key for key
        assert _files(tmp_path / "port") == _files(tmp_path / "jax")
        # and each package reads the other's
        back = state_store.FileStore(str(tmp_path / "jax"))
        assert {k: back.get(k) for k in back.keys()} == {
            k: v for k, v in got["jax"].items()
            if k not in ("keys_a", "missing")}


def test_file_store_replays_an_interrupted_group_commit(tmp_path):
    for ss in (jax_state_store, state_store):
        root = tmp_path / ss.__name__.split(".")[0]
        store = ss.FileStore(str(root))
        store.set("k", 1)
        store.set_many({"k": 2, "j": 3})
        again = ss.FileStore(str(root))
        assert (again.get("k"), again.get("j")) == (2, 3)


def test_build_state_store_is_a_singleton_per_path(tmp_path, monkeypatch):
    monkeypatch.delenv(state_store.ENV_BACKEND, raising=False)
    assert isinstance(state_store.build_state_store(),
                      state_store.MemoryStore)
    a = state_store.build_state_store("file", str(tmp_path))
    assert a is state_store.build_state_store("file", str(tmp_path))
    with pytest.raises(ValueError):
        state_store.build_state_store("redis", str(tmp_path))


def test_event_queue_drops_the_oldest_as_jax():
    got = {}
    for name, (_, eq, _) in PKGS.items():
        q = eq.EventQueue(max_size=3)
        for i in range(5):
            q.put(i)
        out = [q.get(timeout=0.01) for _ in range(4)]
        got[name] = (out, q.dropped, len(q))
    assert got["port"] == got["jax"] == ([2, 3, 4, None], 2, 0)
    q = event_queue.EventQueue(max_size=2)
    threading.Timer(0.05, q.put, args=("late",)).start()
    assert q.get(timeout=5) == "late"


def _journal_ops(j):
    j.save_dataset_params("ds", {"batch_size": 4, "dataset_size": 64})
    j.save_dataset_checkpoint("ds", json.dumps({"todo": [[0, 4]]}))
    j.save_kv({"k": b"\x00\xffv"})
    j.save_rdzv_round("elastic-training", 3)
    j.save_rdzv_params("elastic-training", {"min_nodes": 1,
                                            "max_nodes": 2})
    j.save_global_step(42, batch_feed=True)
    j.save_goodput({"saved_at": T0, "procs": {}, "faults": []})
    j.mark_started()
    j.flush()
    return {
        "datasets": j.saved_datasets(), "ds": j.load_dataset("ds"),
        "kv": j.load_kv(), "rounds": j.load_rdzv_rounds(),
        "params": j.load_rdzv_params(), "step": j.load_global_step(),
        "goodput": j.load_goodput(), "has": j.has_state(),
    }


@pytest.mark.parametrize("window", [0.0, 0.05])
def test_journal_round_trips_as_jax(window, tmp_path):
    got = {}
    for name, (_, _, sj) in PKGS.items():
        j = sj.build_master_state_journal(
            "job-a", state_dir=str(tmp_path / name), commit_window=window)
        got[name] = _journal_ops(j)
        j.close()
    assert got["port"] == got["jax"]
    assert got["port"]["kv"] == {"k": b"\x00\xffv"}
    assert got["port"]["step"] == (42, True)
    # cross-read: the port's journal over the JAX package's files
    back = state_journal.build_master_state_journal(
        "job-a", state_dir=str(tmp_path / "jax"))
    assert back.load_kv() == {"k": b"\x00\xffv"}
    assert back.load_global_step() == (42, True)
    back.close()
    fresh = state_journal.build_master_state_journal(
        "job-a", state_dir=str(tmp_path / "jax"), fresh=True)
    assert not fresh.has_state()
    fresh.close()


def test_journal_is_off_without_a_state_dir(monkeypatch):
    monkeypatch.delenv(state_journal.ENV_STATE_DIR, raising=False)
    assert state_journal.build_master_state_journal("job") is None


def test_aggregator_state_roundtrip_counts_master_downtime(tmp_path):
    """Mirrors the JAX test of the same name; the JAX aggregator's own
    round trip of the same reports gives the same summary."""
    summaries = []
    for agg_cls, sj in ((GoodputAggregator, state_journal),
                        (JaxAggregator, jax_journal)):
        agg = agg_cls()
        agg.observe_report(
            node_id=0, pid=1, start_ts=T0, elapsed_s=5.0,
            phases=_phases(training=5.0), ts=T0 + 5)
        name = sj.__name__.split(".")[0]
        journal = sj.build_master_state_journal(
            "gp-test", state_dir=str(tmp_path / name))
        journal.save_goodput(agg.to_state())
        journal.close()
        reader = sj.build_master_state_journal(
            "gp-test", state_dir=str(tmp_path / name))
        loaded = reader.load_goodput()
        reader.close()
        assert set(loaded["procs"]) == {"0:1"}
        agg2 = agg_cls()
        agg2.restore_state(loaded, now=loaded["saved_at"] + 4.0)
        s = agg2.summary()
        master = [f for f in s["faults"] if f["cause"] == "master_restart"]
        assert len(master) == 1
        assert (master[0]["recovered_ts"] - master[0]["ts"]
                == pytest.approx(4.0))
        assert s["job"]["procs"] == 1
        assert s["job"]["training_s"] == pytest.approx(5.0)
        summaries.append({k: v for k, v in s["job"].items()
                          if not k.endswith("_ts")})
    assert summaries[0] == summaries[1]


def test_local_master_persists_goodput_through_the_journal(
        tmp_path, monkeypatch):
    """The local master with a state dir checkpoints its aggregator
    through the journal, and its successor resumes the account with
    the gap as the master's own downtime."""
    monkeypatch.setenv(state_journal.ENV_STATE_DIR, str(tmp_path))
    monkeypatch.setenv("DLROVER_TPU_METRICS_PORT", "off")
    local_master = importlib.import_module(
        "dlrover_tpu_torch.master.local_master")
    first = local_master.LocalJobMaster(port=0)
    assert first.state_journal is not None
    first.goodput_aggregator.observe_report(
        node_id=0, pid=7, start_ts=T0, elapsed_s=3.0,
        phases=_phases(training=3.0), ts=T0 + 3)
    first.prepare()
    first.stop()
    second = local_master.LocalJobMaster(port=0)
    s = second.goodput_aggregator.summary()
    assert s["job"]["procs"] == 1
    assert [f["cause"] for f in s["faults"]] == ["master_restart"]
    second.state_journal.close()
