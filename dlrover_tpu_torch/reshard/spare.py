"""Hot spares: idle workers pre-warmed to stand in for a casualty.

A spare is a worker that registers under
``reshard/spare/<rank>`` in the master KV store *before* reporting
RUNNING — the ordering matters: the
:class:`~dlrover_tpu_torch.reshard.coordinator.TransitionCoordinator` sees
the registration first and neither widens the world nor cuts a grow
order for it. The spare then idles warm:

* it pre-builds its model (the caller's job — build the trainer and
  its kernels ahead so promotion pays no start-up),
* it pre-warms the last flash save from surviving peers' RAM tier
  (:meth:`HotSpare.prewarm` — every member digest-verified against
  the peer manifests before it is cached),
* and it keeps polling for transition orders like any worker.

When a member dies, the coordinator claims the spare
(``kind=promote`` order: constant world size, the spare takes the
dead rank's position). The spare adopts the order at its poll
cadence, re-forms the world with the survivors, and restores its
shard set with the pre-warmed cache ranked ahead of the checkpoint
tiers (:meth:`HotSpare.source` plugs into
``FlashCheckpointer.restore(extra_sources=...)``) — promotion lands
inside one step boundary because nothing waits on the store.

Counterpart of ``dlrover_tpu/reshard/spare.py``, under the same names.
"""

import json
import time
from typing import Any, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.reshard.order import SPARE_KEY_PREFIX
from dlrover_tpu_torch.telemetry import record

__all__ = ["HotSpare", "PrewarmedSource"]


class PrewarmedSource:
    """A spare's in-RAM member cache as a shard source for the v2
    loader.

    Holds raw ``.npy`` member bytes fetched from peers at warm time.
    Serves under ``tier="local"``: by restore time the bytes live in
    this process's RAM, and the fetcher digest-verifies every member
    against the restore catalog before trusting it, exactly like a
    local archive read. ``step`` pins the source so a walk-down to an
    older candidate skips it instead of mixing steps.
    """

    tier = "local"

    def __init__(self, step: int):
        self.step = int(step)
        self._members: Dict[Tuple[str, str], bytes] = {}
        self.bytes = 0

    def put(self, pkey: str, ikey: str, raw: bytes) -> None:
        key = (pkey, ikey)
        if key not in self._members:
            self._members[key] = raw
            self.bytes += len(raw)

    def fetch(self, pkey: str, ikey: str, procs) -> Optional[bytes]:
        return self._members.get((pkey, ikey))

    def __len__(self) -> int:
        return len(self._members)


class HotSpare:
    """One idle worker's spare lifecycle: register, warm, serve."""

    def __init__(self, master_client, node_rank: int,
                 timeout: float = 10.0):
        self._client = master_client
        self._rank = int(node_rank)
        self._timeout = float(timeout)
        self._source: Optional[PrewarmedSource] = None

    # ---------------------------------------------------------- registration

    def register(self) -> None:
        """Write the spare registration. MUST happen before the first
        RUNNING report, or the coordinator grows the spare into the
        world like any joiner."""
        payload = json.dumps(
            {"rank": self._rank, "ts": time.time()}
        ).encode()
        self._client.kv_store_set(
            f"{SPARE_KEY_PREFIX}{self._rank}", payload
        )
        record("spare.registered", node_rank=self._rank)

    def is_claimed(self) -> bool:
        """True once the coordinator consumed the registration (a
        promote order for this rank is out, or is coming)."""
        try:
            raw = self._client.kv_store_get(
                f"{SPARE_KEY_PREFIX}{self._rank}"
            )
        except Exception:
            return False
        return not raw

    # --------------------------------------------------------------- warming

    @property
    def warm_step(self) -> Optional[int]:
        return self._source.step if self._source else None

    def source(self) -> Optional[PrewarmedSource]:
        """The cache as an ``extra_sources`` entry for restore (None
        until a prewarm landed)."""
        return self._source

    def prewarm(self, registry, steps=None) -> Optional[int]:
        """Pull the newest candidate step's members into RAM.

        ``registry`` is the worker's
        :class:`~dlrover_tpu_torch.checkpoint.peer.PeerRegistry`. ``steps``
        optionally narrows the candidates — e.g. to the store-COMMITted
        frontier, the set a promotion would actually restore from;
        default is every peer-advertised step. Walks the candidates
        newest-first; for the first step with reachable manifests,
        fetches every member over ``/ckpt/shard``, digest-verifies it
        against the merged manifests, and caches the clean copies.
        Re-warming the step already held only fills members that were
        unreachable last time (peers advertise as they save, so the
        first warm of a step can be partial), so callers loop this on
        the idle cadence and track the save frontier for free.
        Returns the warmed step, or None when nothing is
        advertised/reachable."""
        if steps is None:
            steps = registry.advertised_steps()
        for step in sorted(steps, reverse=True):
            if self._source is not None and self._source.step == step:
                before = len(self._source)
                self._fill(registry, step, self._source)
                if len(self._source) > before:
                    record(
                        "spare.warmed", node_rank=self._rank,
                        step=step, members=len(self._source),
                        bytes=self._source.bytes,
                    )
                return step
            src = PrewarmedSource(step)
            self._fill(registry, step, src)
            if len(src):
                self._source = src
                record(
                    "spare.warmed", node_rank=self._rank, step=step,
                    members=len(src), bytes=src.bytes,
                )
                return step
        return None

    def _fill(self, registry, step: int, src: PrewarmedSource) -> None:
        from dlrover_tpu_torch.checkpoint import loader, peer as peer_mod
        from dlrover_tpu_torch.checkpoint import manifest as mf

        peers = {
            p: url for p, url in registry.peers(step).items()
            if p != self._rank
        }
        if not peers:
            return
        catalog = None
        for p in sorted(peers):
            try:
                man = peer_mod.fetch_manifest(
                    peers[p], step, timeout=self._timeout
                )
            except Exception as e:
                logger.warning(
                    "spare manifest fetch from proc %s failed: %s", p, e
                )
                continue
            if man is None:
                continue
            if catalog is None:
                catalog = loader.StepCatalog.from_archive_manifest(man)
            else:
                catalog.absorb(man)
        if catalog is None:
            return
        fetcher = loader.PeerSource(
            peers, step, process_index=self._rank,
            timeout=self._timeout,
        )
        import hashlib

        for leaf in catalog.leaves:
            kind = leaf.get("kind")
            if kind == "py":
                continue
            pkey = mf.path_key(leaf["path"])
            if kind == "array":
                wanted: List[Tuple[str, Any]] = [
                    ("full", leaf.get("replicas"))
                ]
            else:
                wanted = [
                    (mf.index_key(d["idx"]), d.get("replicas"))
                    for d in (leaf.get("domains") or [])
                ]
            for ikey, replicas in wanted:
                if src.fetch(pkey, ikey, None) is not None:
                    continue  # already held from an earlier warm
                try:
                    raw = fetcher.fetch(pkey, ikey, replicas)
                except Exception as e:
                    logger.warning("spare prewarm fetch failed: %s", e)
                    raw = None
                if raw is None:
                    continue
                want = catalog.digests.get(mf.joined_key(pkey, ikey))
                if want is not None and (
                    hashlib.sha256(raw).hexdigest() != want
                ):
                    # never cache a dirty copy: the restore-time
                    # verify would just evict it to the next tier
                    logger.warning(
                        "spare prewarm digest mismatch on %s",
                        pkey[:120],
                    )
                    continue
                src.put(pkey, ikey, raw)
