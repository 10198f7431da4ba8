"""Hot spares in the port (``reshard/spare.py``), the mirror of
``tests/test_spare.py``: two virtual processes flash-save a sharded
state to RAM and advertise it over the KV store; an idle spare
registers, pre-warms the step over ``/ckpt/shard``, and -- after a
process dies -- restores its shard set out of the warm cache without
the object store. Here the state is the port's (``ShardedLeaf`` boxes,
as a sharded trainer saves them), and the promotion runs through the
port's ``TransitionCoordinator`` and ``MeshTransition``: a loss with a
registered spare cuts a promote order that the spare adopts."""

import shutil

import pytest
import torch

from dlrover_tpu_torch import telemetry as T
from dlrover_tpu_torch.agent.master_client import LocalMasterClient
from dlrover_tpu_torch.checkpoint import peer
from dlrover_tpu_torch.master.elastic_training.kv_store_service import (
    KVStoreService,
)
from dlrover_tpu_torch.reshard import (
    KIND_PROMOTE,
    SPARE_KEY_PREFIX,
    HotSpare,
    MeshTransition,
    PrewarmedSource,
    TransitionCoordinator,
)
from dlrover_tpu_torch.telemetry.http import MetricsServer
from dlrover_tpu_torch.telemetry.journal import EventJournal
from dlrover_tpu_torch.trainer.checkpoint import FlashCheckpointer
from dlrover_tpu_torch.trainer.ckpt_store import ShardedLeaf

W = torch.arange(64, dtype=torch.float32).reshape(8, 8)


@pytest.fixture(autouse=True)
def fresh_defaults():
    T.set_default_registry(None)
    T.set_default_journal(EventJournal(None))
    yield
    T.set_default_registry(None)
    T.set_default_journal(EventJournal(None))


def events(kind):
    return T.default_journal().events(kind)


class _BrokenStore:
    def __getattr__(self, name):
        def boom(*a, **k):
            raise OSError("store unreachable")

        return boom


class KVClient:
    """The master KV as a worker sees it, over one KVStoreService (the
    one a coordinator writes its orders to)."""

    def __init__(self, kv):
        self.kv = kv

    def kv_store_get(self, key):
        return self.kv.get(key)

    def kv_store_set(self, key, value):
        self.kv.set(key, value)

    def kv_store_keys(self, prefix=""):
        return self.kv.keys(prefix)

    def kv_store_delete(self, key):
        self.kv.delete(key)

    def kv_store_add(self, key, amount=1):
        return self.kv.add(key, amount)

    def report_reshard(self, order_id, phase, detail=""):
        return None


def _checkpointer(tmp_path, p, n=2):
    return FlashCheckpointer(
        str(tmp_path / "store"), ram_dir=str(tmp_path / f"ram{p}"),
        persist_interval=0, process_index=p, n_processes=n)


def _boxes(p, n=2):
    return [[0, 8], [8 // n * p, 8 // n * (p + 1)]]


def _state(p, n=2, w=W):
    """Process ``p``'s state: its column box of ``w`` (tp over n)."""
    box = _boxes(p, n)
    return {"w": ShardedLeaf(
        (8, 8), torch.float32,
        [(box, w[:, box[1][0]:box[1][1]].clone())],
        [{"idx": _boxes(q, n), "replicas": [q]} for q in range(n)]),
        "epoch": 4}


def _target(p, n=2):
    box = _boxes(p, n)
    return {"w": ShardedLeaf(
        (8, 8), torch.float32,
        [(box, torch.zeros(8, 8 // n))],
        [{"idx": _boxes(q, n), "replicas": [q]} for q in range(n)]),
        "epoch": -1}


def _serving_world(tmp_path, kv, step, w=W):
    """Two processes save ``step`` to RAM only and advertise it."""
    ckpts, servers = [], []
    for p in range(2):
        c = _checkpointer(tmp_path, p)
        srv = MetricsServer(port=0, shard_provider=c.shard_provider()
                            ).start()
        c._peer_registry = peer.PeerRegistry(
            kv, p, f"http://127.0.0.1:{srv.port}")
        ckpts.append(c)
        servers.append(srv)
    for p, c in enumerate(ckpts):
        c.save(step, _state(p, w=w))
        c.wait()
    return ckpts, servers


def _close(ckpts, servers):
    for c in ckpts:
        c.close()
    for s in servers:
        s.stop()


def test_registration_precedes_running():
    kv = LocalMasterClient()
    spare = HotSpare(kv, node_rank=5)
    spare.register()
    assert kv.kv_store_get(f"{SPARE_KEY_PREFIX}5")
    assert not spare.is_claimed()
    assert len(events("spare.registered")) == 1
    # the coordinator consumes the registration at promotion
    kv.kv_store_delete(f"{SPARE_KEY_PREFIX}5")
    assert spare.is_claimed()


def test_prewarmed_source_is_step_pinned_and_deduped():
    src = PrewarmedSource(9)
    src.put("pk", "ik", b"abc")
    src.put("pk", "ik", b"xyz")  # first copy wins
    assert src.fetch("pk", "ik", None) == b"abc"
    assert src.fetch("pk", "other", None) is None
    assert len(src) == 1 and src.bytes == 3
    assert src.step == 9 and src.tier == "local"


def test_prewarm_pulls_newest_advertised_step(tmp_path):
    kv = LocalMasterClient()
    ckpts, servers = _serving_world(tmp_path, kv, 11)
    try:
        for p, c in enumerate(ckpts):
            c.save(12, _state(p))
            c.wait()
        spare = HotSpare(kv, node_rank=2)
        reg = peer.PeerRegistry(kv, 2, "")
        assert spare.prewarm(reg) == 12
        src = spare.source()
        # both boxes of w, from the two processes' archives
        assert src is not None and len(src) == 2 and src.step == 12
        (evt,) = events("spare.warmed")
        assert evt["data"]["step"] == 12
        assert evt["data"]["members"] == len(src)
        # re-warming the held step is a no-op (the idle-cadence loop)
        assert spare.prewarm(reg) == 12
        assert len(events("spare.warmed")) == 1
    finally:
        _close(ckpts, servers)


def test_promotion_restores_from_the_warm_cache(tmp_path):
    """The promotion path: process 0 dies AFTER the spare warmed; the
    coordinator cuts a promote order for the registered spare, the
    spare adopts it and reassembles its place's boxes from RAM -- the
    store broken, every member digest-checked at warm time."""
    kv = KVStoreService()
    client = KVClient(kv)
    ckpts, servers = _serving_world(tmp_path, client, 21)
    coord = TransitionCoordinator(kv, max_transitions=8)
    for r in (0, 1):
        coord.note_node_running(r)
    coord.seal_world()
    spare = HotSpare(client, node_rank=2)
    spare.register()
    assert coord.note_node_running(2) is None  # never grown in
    assert spare.prewarm(peer.PeerRegistry(client, 2, "")) == 21

    # process 0 dies: its tmpfs is gone; the spare is promoted
    shutil.rmtree(tmp_path / "ram0")
    servers[0].stop()
    order = coord.note_node_lost(0, reason="heartbeat")
    assert order.kind == KIND_PROMOTE and order.joined == [2]
    assert order.world_size == order.old_world_size == 2
    assert spare.is_claimed()
    mt = MeshTransition(client, node_rank=2)
    adopted = mt.poll_order()
    assert adopted is not None and adopted.id == order.id
    index = adopted.new_index(2)
    r = _checkpointer(tmp_path, index)
    r._store = _BrokenStore()
    r._peer_registry = peer.PeerRegistry(client, index,
                                         "http://127.0.0.1:1")
    try:
        got, step = r.restore(target=_target(index), step=21,
                              extra_sources=[spare.source()])
    finally:
        r.close()
        _close(ckpts, servers)
    assert step == 21
    (box, t), = got["w"].pieces
    assert torch.equal(t, W[:, box[1][0]:box[1][1]])
    assert got["epoch"] == 4
    tr = events("ckpt.topology_restore")[-1]["data"]
    # the warm cache served everything: no peer refetch, no store
    assert tr["local"] >= 1 and tr["store"] == 0
    assert tr["digest_mismatch"] == 0


def test_stale_warm_cache_steps_aside(tmp_path):
    """A spare warmed at step N must not serve a restore of step M: the
    pinned source is skipped and the peers cover the restore."""
    kv = LocalMasterClient()
    ckpts, servers = _serving_world(tmp_path, kv, 30)
    spare = HotSpare(kv, node_rank=2)
    assert spare.prewarm(peer.PeerRegistry(kv, 2, "")) == 30
    newer = W + 100
    try:
        for p, c in enumerate(ckpts):
            c.save(31, _state(p, w=newer))
            c.wait()
        r = _checkpointer(tmp_path, 0)
        r._store = _BrokenStore()
        r._peer_registry = peer.PeerRegistry(kv, 0, "http://127.0.0.1:1")
        got, step = r.restore(target=_target(0), step=31,
                              extra_sources=[spare.source()])
        r.close()
    finally:
        _close(ckpts, servers)
    assert step == 31
    (box, t), = got["w"].pieces
    assert torch.equal(t, newer[:, box[1][0]:box[1][1]])
