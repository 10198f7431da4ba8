"""The port's FlashCheckpointer at several processes, on the CPU: the
owned-only persist subsets with their crc32-elected owners, rank 0's
commit only after every index piece, the consensus restore of two gloo
ranks (and its fresh start when the consensus fails), the /ckpt/shard
endpoint and the peer tier, digest refetch from the next tier, resizes
from 2 ranks to 1 and from 1 to 2, and format-v2 steps read across
packages both ways. Cases of the JAX package's test_ckpt_topology.py
and test_ckpt_peer.py, run through the port; virtual processes (given
``process_index``/``n_processes``) share one real process where no
collective runs, as the JAX tests carve their 8 CPU devices."""

import inspect
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap
import urllib.error
import urllib.request
import zipfile

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dlrover_tpu.checkpoint import manifest as jax_mf
from dlrover_tpu.trainer import ckpt_store as jax_store
from dlrover_tpu.trainer.checkpoint import (
    FlashCheckpointer as JaxFlashCheckpointer,
)
from dlrover_tpu_torch import telemetry as T
from dlrover_tpu_torch.agent.master_client import LocalMasterClient
from dlrover_tpu_torch.checkpoint import manifest as mf
from dlrover_tpu_torch.checkpoint import peer
from dlrover_tpu_torch.telemetry.http import MetricsServer
from dlrover_tpu_torch.trainer import ckpt_store
from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def fresh_telemetry():
    T.set_default_registry(None)
    T.set_default_journal(T.EventJournal(None))
    yield
    T.set_default_registry(None)
    T.set_default_journal(T.EventJournal(None))


def events(kind):
    return T.default_journal().events(kind)


def _state(seed=0):
    """A small replicated training state: bf16 and fp32 tensors and the
    py leaves the elastic loop saves."""
    g = torch.Generator().manual_seed(seed)
    return {
        "model": {"w": torch.randn(8, 8, generator=g).to(torch.bfloat16),
                  "b": torch.randn(8, generator=g)},
        "optimizer": {"mu": {"w": torch.randn(8, 8, generator=g)},
                      "count": 3},
        "step": 7, "data": '{"todo": [[16, 24]]}',
    }


def _zeros():
    return {
        "model": {"w": torch.zeros(8, 8, dtype=torch.bfloat16),
                  "b": torch.zeros(8)},
        "optimizer": {"mu": {"w": torch.zeros(8, 8)}, "count": -1},
        "step": 0, "data": "",
    }


def _assert_same(got, want):
    flat_g = ckpt_store.flatten_with_path(got)
    flat_w = ckpt_store.flatten_with_path(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), path
        else:
            assert g == w, path


def _ckpt(tmp_path, p, n, persist_interval=1):
    return FlashCheckpointer(
        str(tmp_path / "store"), ram_dir=str(tmp_path / f"ram{p}"),
        persist_interval=persist_interval, process_index=p, n_processes=n,
        commit_timeout=30)


def _save_all(ckpts, step, state):
    for c in ckpts:
        c.save(step, state, force_persist=True)
    for c in ckpts:
        c.wait()


def _close(*objs):
    for o in objs:
        (o.stop if isinstance(o, MetricsServer) else o.close)()


class _BrokenStore:
    """The object store is off the network: every call raises."""

    def __getattr__(self, name):
        def boom(*a, **k):
            raise OSError("store unreachable")

        return boom


def _peer_fleet(tmp_path, n, kv):
    """``n`` virtual processes, each serving its RAM tier over
    /ckpt/shard and advertising it in ``kv``."""
    ckpts, servers = [], []
    for p in range(n):
        c = _ckpt(tmp_path, p, n, persist_interval=0)
        srv = MetricsServer(port=0, shard_provider=c.shard_provider()).start()
        c._peer_registry = peer.PeerRegistry(
            kv, p, f"http://127.0.0.1:{srv.port}")
        ckpts.append(c)
        servers.append(srv)
    return ckpts, servers


# ------------------------------------------------- dedup + owner election


def test_replicated_save_dedups_to_owned_shards(tmp_path):
    """Each replicated tensor goes to the store once, from its elected
    owner; the owned bytes of the ranks add up to the state's."""
    ckpts = [_ckpt(tmp_path, p, 2) for p in range(2)]
    _save_all(ckpts, 60, _state())
    _close(*ckpts)
    store = ckpt_store.get_store(str(tmp_path / "store"))
    man = ckpt_store.step_manifest(store, 60)
    tensors = [leaf for leaf in man["leaves"] if leaf["kind"] == "shards"]
    assert len(tensors) == 3
    writers = {}
    for leaf in tensors:
        (d,) = leaf["domains"]
        assert d["replicas"] == [0, 1]
        key = mf.shard_key(mf.path_key(leaf["path"]), d["idx"])
        assert d["owner"] == mf.elect_owner(key, [0, 1])
        # the location table names the one owner's file
        assert man["locations"][key]["proc"] == d["owner"]
        writers[key] = d["owner"]
    dedup = {e["data"]["process_index"]: e["data"]
             for e in events("ckpt.dedup")}
    assert sorted(dedup) == [0, 1]
    assert sum(d["members_owned"] for d in dedup.values()) == 3
    assert all(d["members_full"] == 3 for d in dedup.values())
    state_bytes = sum(d["bytes_full"] for d in dedup.values()) // 2
    assert sum(d["bytes_owned"] for d in dedup.values()) == state_bytes
    for p in range(2):  # each subset holds exactly its owned members
        with zipfile.ZipFile(store.open_read(
                ckpt_store.step_key(60, p, "0"))) as zf:
            npy = [n for n in zf.namelist() if n.endswith(".npy")]
        assert len(npy) == sum(1 for o in writers.values() if o == p)


@pytest.mark.parametrize("replicas", [[0, 1], [0, 1, 2, 3], [3, 1, 0, 2]])
def test_owner_election_deterministic_and_spread(replicas):
    """The same owners as the JAX package's election, spread over the
    replicas, whatever the replica list's order."""
    keys = [f"leaf-{i}|[[0,8]]" for i in range(200)]
    owners = [mf.elect_owner(k, replicas) for k in keys]
    assert owners == [jax_mf.elect_owner(k, replicas) for k in keys]
    assert owners == [mf.elect_owner(k, sorted(replicas)) for k in keys]
    assert set(owners) == set(replicas)  # no pile-up on rank 0


def test_commit_waits_for_every_index_piece(tmp_path):
    """Rank 0 writes COMMIT only once both ranks' shard and index piece
    are in the store; with one missing the commit times out unwritten."""
    store = ckpt_store.get_store(str(tmp_path / "store"))
    pieces = {}
    for p in range(2):
        buf = io.BytesIO()
        ckpt_store.snapshot_to_file(
            _state(), 5, buf, topology={"n_processes": 2,
                                        "process_index": p})
        pieces[p] = buf.getvalue()
    from dlrover_tpu_torch.checkpoint import saver

    subsets = {p: saver.subset_archive(io.BytesIO(pieces[p]), p)
               for p in range(2)}
    for p in range(2):
        ckpt_store.put_shard(store, 5, p, subsets[p][0])
    store.put(ckpt_store.index_key(5, 0),
              json.dumps(subsets[0][1]).encode())
    assert not ckpt_store.commit_step_sharded(store, 5, 2, timeout=0.2)
    assert not store.exists(ckpt_store.commit_key(5))
    assert ckpt_store.available_steps(store, 0) == []
    store.put(ckpt_store.index_key(5, 1),
              json.dumps(subsets[1][1]).encode())
    assert ckpt_store.commit_step_sharded(store, 5, 2, timeout=5)
    assert ckpt_store.available_steps(store, 1) == [5]
    # the JAX store's commit of the same pieces writes the same bytes
    jstore = jax_store.get_store(str(tmp_path / "jax-store"))
    for p in range(2):
        jax_store.put_shard(jstore, 5, p, subsets[p][0])
        jstore.put(jax_store.index_key(5, p),
                   json.dumps(subsets[p][1]).encode())
    assert jax_store.commit_step_sharded(jstore, 5, 2, timeout=5)
    for key in (ckpt_store.manifest_key(5), ckpt_store.commit_key(5)):
        assert store.get(key) == jstore.get(key), key
    assert jax_store.step_manifest(store, 5) == ckpt_store.step_manifest(
        store, 5)
    assert ckpt_store.index_key(5, 1, "3") == jax_store.index_key(5, 1, "3")
    assert ckpt_store.manifest_key(5, "3") == jax_store.manifest_key(5, "3")


def test_write_step_commits_after_every_shard(tmp_path):
    """``write_step``'s barrier: rank 1's shard alone commits nothing;
    rank 0's write commits once both same-attempt shards are listed; the
    COMMIT document and the shards read back as the JAX store's."""
    store = ckpt_store.get_store(str(tmp_path / "store"))
    jstore = jax_store.get_store(str(tmp_path / "jax-store"))
    for s, mod in ((store, ckpt_store), (jstore, jax_store)):
        mod.write_step(s, 3, 1, b"one", n_processes=2, attempt="7")
        assert mod.committed_steps(s) == []
        mod.write_step(s, 3, 0, b"zero", n_processes=2, commit_timeout=5,
                       attempt="7")
        assert mod.committed_steps(s) == [3]
    assert store.get(ckpt_store.commit_key(3)) == jstore.get(
        jax_store.commit_key(3))
    for p, data in ((0, b"zero"), (1, b"one")):
        assert ckpt_store.read_step(store, 3, p) == data
        assert jax_store.read_step(store, 3, p) == data


# ------------------------------------------------- digest verification


def _corrupt_one_member(path):
    with zipfile.ZipFile(path) as z:
        members = {n: z.read(n) for n in z.namelist()}
    victim = sorted(n for n in members if n.endswith(".npy"))[0]
    raw = bytearray(members[victim])
    raw[-1] ^= 0xFF
    members[victim] = bytes(raw)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        for n, data in members.items():
            z.writestr(n, data)
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    return victim


def test_digest_mismatch_refetches_from_next_tier(tmp_path):
    state = _state()
    ckpts = [_ckpt(tmp_path, p, 2) for p in range(2)]
    _save_all(ckpts, 100, state)
    _close(*ckpts)
    assert _corrupt_one_member(str(tmp_path / "ram0" / "step-100-proc-0"))
    r = _ckpt(tmp_path, 0, 2)
    got, step = r.restore(target=_zeros(), step=100)
    r.close()
    assert step == 100
    _assert_same(got, state)
    fb = [e for e in events("checkpoint.restore_fallback")
          if e["data"].get("reason") == "digest_mismatch"]
    assert fb
    assert events("ckpt.shard_refetch")[-1]["data"]["failed_tier"] == "local"
    assert r.last_restore_stats["store"] >= 1


# ----------------------------------------------------------- endpoint


def test_shard_endpoint_serves_manifest_and_members(tmp_path):
    c = _ckpt(tmp_path, 0, 2, persist_interval=0)
    c.save(5, _state())
    c.wait()
    srv = MetricsServer(port=0, shard_provider=c.shard_provider()).start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        man = peer.fetch_manifest(base, 5)
        assert man["version"] == 2
        assert man["topology"] == {"n_processes": 2, "process_index": 0}
        locs = mf._piece_locations(man)
        assert len(locs) == 3  # the RAM tier holds every member
        pkey, ikey = next(iter(locs)).rsplit("|", 1)
        body = peer.fetch_shard(base, 5, pkey, ikey)
        assert body and body[:6] == b"\x93NUMPY"
        assert peer.fetch_manifest(base, 999) is None  # not held: 404
        assert peer.fetch_shard(base, 5, pkey, "[[0,999]]") is None
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/ckpt/shard")  # no step
        assert e.value.code == 400
    finally:
        _close(srv, c)
    bare = MetricsServer(port=0).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(
                f"http://127.0.0.1:{bare.port}/ckpt/shard?step=1")
        assert e.value.code == 404
    finally:
        bare.stop()


# ------------------------------------------------------ kill-host drill


def test_killed_rank_restores_over_peer_tier(tmp_path):
    """Rank 0 loses its tmpfs and the store, relaunches, and assembles
    the step over /ckpt/shard from rank 1, bitwise, journaled, metered."""
    state = _state()
    kv = LocalMasterClient()
    ckpts, servers = _peer_fleet(tmp_path, 2, kv)
    for c in ckpts:
        c.save(11, state)
        c.wait()
    assert kv.kv_store_keys("ckpt/peer/11/")
    shutil.rmtree(tmp_path / "ram0")
    r = _ckpt(tmp_path, 0, 2)
    r._store = _BrokenStore()
    r._peer_registry = peer.PeerRegistry(kv, 0, "http://127.0.0.1:1")
    got, step = r.restore(target=_zeros(), step=11)
    _close(r, *ckpts, *servers)
    assert step == 11
    _assert_same(got, state)
    assert events("ckpt.peer_fetch") and events("ckpt.peer_served")
    tr = events("ckpt.topology_restore")[-1]["data"]
    assert tr["peer"] == 3 and tr["store"] == 0
    assert r.last_restore_stats["tier"] == "peer"
    assert r.last_restore_stats["peer_bytes"] > 0
    reg = T.default_registry()
    assert reg.get("dlrover_ckpt_shard_bytes_total").labels(
        tier="peer").value > 0
    assert reg.get("dlrover_ckpt_peer_fetches_total").labels(
        result="ok").value == 3


def test_auto_restore_discovers_step_from_peers(tmp_path):
    """Without an explicit step the peers' advertisements are
    candidates: a process with nothing local and no store restores the
    step a peer holds."""
    state = _state()
    kv = LocalMasterClient()
    c = _ckpt(tmp_path, 1, 2, persist_interval=0)
    srv = MetricsServer(port=0, shard_provider=c.shard_provider()).start()
    c._peer_registry = peer.PeerRegistry(
        kv, 1, f"http://127.0.0.1:{srv.port}")
    c.save(13, state)
    c.wait()
    r = _ckpt(tmp_path, 0, 2)
    r._store = _BrokenStore()
    r._peer_registry = peer.PeerRegistry(kv, 0, "http://127.0.0.1:1")
    assert 13 in r._local_candidate_steps()
    got, step = r.restore(target=_zeros())
    _close(r, c, srv)
    assert step == 13
    _assert_same(got, state)


# ------------------------------------------------------------- resizes


def test_resize_two_ranks_to_one(tmp_path):
    """A step two ranks saved restores bitwise in a world of one, from
    the store's step manifest and both ranks' subsets."""
    state = _state(3)
    ckpts = [_ckpt(tmp_path, p, 2) for p in range(2)]
    _save_all(ckpts, 20, state)
    _close(*ckpts)
    solo = FlashCheckpointer(str(tmp_path / "store"),
                             ram_dir=str(tmp_path / "ram-solo"))
    got, step = solo.restore(target=_zeros())
    solo.close()
    assert step == 20
    _assert_same(got, state)
    assert solo.last_restore_stats["store"] == 3


def test_resize_one_rank_to_two(tmp_path):
    """A one-process save restores bitwise in a world of two: the
    survivor from its RAM tier, the new rank over the peer tier."""
    state = _state(4)
    kv = LocalMasterClient()
    solo = FlashCheckpointer(str(tmp_path / "store"),
                             ram_dir=str(tmp_path / "ram0"))
    srv = MetricsServer(port=0, shard_provider=solo.shard_provider()).start()
    solo._peer_registry = peer.PeerRegistry(
        kv, 0, f"http://127.0.0.1:{srv.port}")
    solo.save(30, state)
    solo.close()
    results = []
    for p in range(2):
        r = _ckpt(tmp_path, p, 2)
        r._peer_registry = peer.PeerRegistry(
            kv, p, f"http://127.0.0.1:{srv.port}" if p == 0
            else "http://127.0.0.1:1")
        results.append((r.restore(target=_zeros()), r.last_restore_stats))
        r.close()
    srv.stop()
    for (got, step), _ in results:
        assert step == 30
        _assert_same(got, state)
    assert results[0][1]["tier"] == "ram"
    assert results[1][1]["tier"] == "peer"


# -------------------------------------------------- consensus (2 ranks)


#: each rank's script: _state and _zeros copied in, so that a rank
#: imports neither this module nor JAX
_COPIED = inspect.getsource(_state) + inspect.getsource(_zeros)
_RANK = _COPIED + textwrap.dedent("""
    import json, sys, torch
    from dlrover_tpu_torch.trainer import ckpt_store
    from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer
    from dlrover_tpu_torch.trainer.distributed import init_from_env
    work = sys.argv[1]
    env = init_from_env(timeout_s=60, device="cpu")

    def ckpt():
        return FlashCheckpointer(f"{work}/store",
                                 ram_dir=f"{work}/ram{env.rank}",
                                 persist_interval=4, max_ram_keep=3,
                                 commit_timeout=30)

    c = ckpt()
    for step in (2, 4):
        c.save(step, {**_state(), "step": step})
    if env.rank == 0:  # a newer step only rank 0 holds
        c.save(6, {**_state(), "step": 6})
    c.close()
    out = {}
    c = ckpt()
    got, step = c.restore(target=_zeros())
    out["consensus"] = step
    out["restored"] = got is not None and all(
        torch.equal(a, b) if isinstance(b, torch.Tensor) else True
        for (_, a), (_, b) in zip(ckpt_store.flatten_with_path(got),
                                  ckpt_store.flatten_with_path(_state())))
    out["tier"] = c.last_restore_stats["tier"]
    if env.rank == 1:  # the consensus fails here, after its gather
        gather = c._gather_ints

        def failing(values, k):
            rows = gather(values, k)
            if k == 16:
                raise RuntimeError("consensus decode failed")
            return rows

        c._gather_ints = failing
    out["after_failure"] = c.restore(target=_zeros())[1]
    c.close()
    print("RESULT " + json.dumps(out), flush=True)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Two gloo ranks save steps 2 and 4 (4 persisted), rank 0 also 6;
    then restore by consensus, then again with rank 1's consensus
    failing."""
    work = tmp_path_factory.mktemp("world")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import torch\n" + _RANK, str(work)],
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
             "DLROVER_TPU_COORDINATOR_ADDR": f"localhost:{port}",
             "DLROVER_TPU_PROCESS_ID": str(rank),
             "DLROVER_TPU_NUM_PROCESSES": "2", "JAX_PLATFORMS": "cpu"},
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-800:] for o in outs]
    results = [json.loads(next(
        line[len("RESULT "):] for line in o[0].splitlines()
        if line.startswith("RESULT "))) for o in outs]
    return work, results


def test_consensus_over_differing_local_histories(two_ranks):
    _, results = two_ranks
    for r in results:  # the newest step both hold, not rank 0's 6
        assert r["consensus"] == 4 and r["restored"] and r["tier"] == "ram"


def test_a_failing_consensus_votes_fresh(two_ranks):
    _, results = two_ranks
    # rank 1 voted fresh; the agreement takes rank 0 along
    assert [r["after_failure"] for r in results] == [None, None]


def test_two_ranks_commit_owned_subsets(two_ranks):
    work, _ = two_ranks
    store = ckpt_store.get_store(str(work / "store"))
    assert ckpt_store.committed_steps(store) == [4]
    keys = set(store.list("step-4/"))
    assert {ckpt_store.index_key(4, p) for p in range(2)} <= keys
    man = ckpt_store.step_manifest(store, 4)
    procs = sorted(loc["proc"] for loc in man["locations"].values())
    assert procs == sorted(
        d["owner"] for leaf in man["leaves"] if leaf["kind"] == "shards"
        for d in leaf["domains"])


# ------------------------------------------------ cross-reads with JAX


def test_port_step_of_two_ranks_read_by_jax(two_ranks, tmp_path):
    """The JAX loader restores the step the two gloo ranks committed."""
    work, _ = two_ranks
    r = JaxFlashCheckpointer(str(work / "store"),
                             ram_dir=str(tmp_path / "jax-ram"),
                             persist_interval=0, use_orbax=False,
                             process_index=0, n_processes=1)
    got, step = r.restore()
    r.close()
    assert step == 4
    want = _state()
    assert got["step"] == 4 and got["data"] == want["data"]
    assert got["optimizer"]["count"] == 3
    w = np.asarray(got["model"]["w"])
    assert str(w.dtype) == "bfloat16"
    assert w.tobytes() == want["model"]["w"].view(torch.int16).numpy(
    ).tobytes()
    assert np.array_equal(np.asarray(got["model"]["b"]),
                          want["model"]["b"].numpy())


def test_jax_step_of_two_virtual_processes_read_by_port(tmp_path):
    """A format-v2 step two virtual JAX processes saved (a dp x tp
    layout over the 8 CPU devices, tp-sharded and replicated leaves)
    restores bitwise through the port's catalog."""
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = Mesh(np.array(devs).reshape(2, 4), ("dp", "tp"))
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    b = np.linspace(-1, 1, 8, dtype=np.float32)
    state = {
        "w": jax.device_put(w, NamedSharding(mesh, P(None, "tp"))),
        "b": jax.device_put(b, NamedSharding(mesh, P(None))),
        "epoch": 2,
    }
    savers = [JaxFlashCheckpointer(
        str(tmp_path / "store"), ram_dir=str(tmp_path / f"jram{p}"),
        persist_interval=1, use_orbax=False, process_index=p,
        n_processes=2, proc_of_device=lambda d: d.id // 4,
        commit_timeout=30) for p in range(2)]
    for c in savers:
        c.save(40, state, force_persist=True)
    for c in savers:
        c.close()
    r = FlashCheckpointer(str(tmp_path / "store"),
                          ram_dir=str(tmp_path / "port-ram"))
    got, step = r.restore(target={"w": torch.zeros(8, 8),
                                  "b": torch.zeros(8), "epoch": -1})
    r.close()
    assert step == 40 and got["epoch"] == 2
    assert torch.equal(got["w"], torch.from_numpy(w))
    assert torch.equal(got["b"], torch.from_numpy(b))
    assert r.last_restore_stats["store"] == 4 + 1  # 4 tp shards + b
