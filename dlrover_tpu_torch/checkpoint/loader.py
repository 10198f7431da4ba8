"""Layout-free restore: assemble a step saved by any number of
processes onto this process's state.

Counterpart of ``dlrover_tpu/checkpoint/loader.py``. A
:class:`StepCatalog` (the global domain maps and where each shard's
member lives, from a step manifest or from any process archive's
manifest) says what a step holds; each leaf of the target is filled
from whichever saved domains cover it, fetched through a chain of
sources:

    local archive  ->  peer /ckpt/shard (survivors' RAM tier)  ->  store

Every fetched member is held to the catalog's sha256 before it is
trusted; a mismatch journals ``checkpoint.restore_fallback{reason=
digest_mismatch}`` and ``ckpt.shard_refetch`` and tries the next source
for that one shard, and the step fails (the caller walks down) only when
no source has a clean copy (:class:`ShardUnavailableError`). Members
decode to CPU tensors (bfloat16 from its raw bytes and recorded
encoding, as ``ckpt_store`` reads it) and land on each target tensor's
device after its shape and dtype were checked. A replicated tensor's
needed domain is the whole tensor; a sharded strategy's target leaf
(``ckpt_store.ShardedLeaf``) names the boxes this process holds, and each
is assembled from the saved domains that overlap it -- those of the
same mesh, or of another (the JAX package's, or a resize to one rank).

A source may also hand back a tensor instead of member bytes: the live
tier of a mesh transition (``reshard/migrate.py``'s
``LiveShardSource``), whose bytes never left the process. The fetcher
takes it as it is, without decode or digest, counts it under ``live``,
and a domain assembled from it is built on the target's device.
"""

import hashlib
import io
import json
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.checkpoint import manifest as mf
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import counter, record
from dlrover_tpu_torch.trainer import ckpt_store

__all__ = [
    "StepCatalog",
    "ShardUnavailableError",
    "LocalArchiveSource",
    "PeerSource",
    "StoreSource",
    "restore_from_catalog",
]


class ShardUnavailableError(ckpt_store.ArchiveError):
    """No tier could produce a clean copy of a needed shard: the
    candidate step is not restorable and the caller walks down."""


def _decode_member(raw: bytes, enc: Optional[Dict[str, Any]]
                   ) -> torch.Tensor:
    """Member bytes -> CPU tensor; a member with an encoding (bfloat16)
    is raw bytes viewed as its recorded dtype and shape."""
    try:
        arr = np.lib.format.read_array(io.BytesIO(raw), allow_pickle=False)
    except Exception as e:
        raise ckpt_store.ArchiveError(f"undecodable shard member: {e}")
    if not enc:
        return torch.from_numpy(np.ascontiguousarray(arr))
    try:
        flat = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1))
        return flat.view(torch.uint8).view(
            ckpt_store.torch_dtype(enc["dtype"])).reshape(enc["shape"])
    except (KeyError, RuntimeError, TypeError, ValueError) as e:
        raise ckpt_store.ArchiveError(
            f"shard member inconsistent with its encoding: {e}")


# ------------------------------------------------------------------ catalog


class StepCatalog:
    """Everything restore planning needs about one saved step: the
    logical leaves with their GLOBAL domain maps, plus per-shard
    digests/encodings and (when known) which process file + member
    holds each shard."""

    def __init__(self, step: int, leaves: List[Dict[str, Any]],
                 topology: Optional[Dict[str, Any]] = None,
                 last_good: Optional[bool] = None,
                 version: int = 2):
        self.step = int(step)
        self.leaves = leaves
        self.topology = topology
        self.last_good = last_good
        self.version = version
        self.digests: Dict[str, str] = {}
        self.encodings: Dict[str, Dict[str, Any]] = {}
        self.locations: Dict[str, Tuple[int, str]] = {}

    @classmethod
    def from_archive_manifest(cls, man: Dict[str, Any]) -> "StepCatalog":
        """Catalog from ONE process archive's manifest (a RAM-tier file
        or a peer's served manifest). Its global domain maps are
        complete; its member locations cover only what that file holds
        -- :meth:`absorb` more manifests to widen them."""
        leaves = [mf._leaf_meta(e) for e in man.get("leaves", [])]
        cat = cls(
            man.get("step", 0), leaves,
            topology=man.get("topology"),
            last_good=man.get("last_good"),
            version=int(man.get("version", 2)),
        )
        cat.absorb(man)
        return cat

    def absorb(self, man: Dict[str, Any]) -> None:
        """Fold another process's archive manifest into the location,
        digest and encoding tables (first writer wins; replicas are
        bit-identical, so any recorded sha verifies any copy)."""
        for key, loc in mf._piece_locations(man).items():
            self.locations.setdefault(key, (loc["proc"], loc["m"]))
            if loc.get("sha256"):
                self.digests.setdefault(key, loc["sha256"])
            if loc.get("enc"):
                self.encodings.setdefault(key, loc["enc"])

    @classmethod
    def from_step_manifest(cls, doc: Dict[str, Any]) -> "StepCatalog":
        """Catalog from the merged step manifest rank 0 published next
        to the COMMIT marker (``ckpt_store.step_manifest``)."""
        cat = cls(
            doc.get("step", 0), list(doc.get("leaves", [])),
            topology=doc.get("topology"),
            last_good=doc.get("last_good"),
        )
        for key, loc in (doc.get("locations") or {}).items():
            cat.locations[key] = (int(loc["proc"]), loc["m"])
            if loc.get("sha256"):
                cat.digests[key] = loc["sha256"]
            if loc.get("enc"):
                cat.encodings[key] = loc["enc"]
        return cat


# ------------------------------------------------------------------ sources


class LocalArchiveSource:
    """This process's own archive (the RAM-tier file): serves every
    member it physically contains, addressed by shard key."""

    tier = "local"

    def __init__(self, fileobj):
        self._zf = None
        self._members: Dict[str, Tuple[str, Optional[dict]]] = {}
        try:
            self._zf = zipfile.ZipFile(fileobj)
            man = json.loads(self._zf.read("manifest.json").decode("utf-8"))
            self.manifest = man
            for key, loc in mf._piece_locations(man).items():
                self._members[key] = (loc["m"], loc.get("enc"))
        except Exception as e:
            raise ckpt_store.ArchiveError(f"unreadable local archive: {e}")

    def fetch(self, pkey: str, ikey: str, procs) -> Optional[bytes]:
        ref = self._members.get(mf.joined_key(pkey, ikey))
        if ref is None:
            return None
        try:
            return self._zf.read(ref[0])
        except Exception:
            return None

    def enc_for(self, key: str) -> Optional[dict]:
        ref = self._members.get(key)
        return ref[1] if ref else None

    def close(self) -> None:
        if self._zf is not None:
            self._zf.close()


class StoreArchiveSource(LocalArchiveSource):
    """A one-process world's whole archive in the store, read as any
    process of a later world needs it (``manifest``: its own)."""

    tier = "store"


class PeerSource:
    """Survivors' RAM tier over HTTP: tries each replica process that
    advertised this step (master KV) until one serves the shard."""

    tier = "peer"

    def __init__(self, peers: Dict[int, str], step: int,
                 process_index: Optional[int] = None,
                 timeout: float = 10.0):
        self._peers = dict(peers)
        self._step = int(step)
        self._me = process_index
        self._timeout = timeout

    def fetch(self, pkey: str, ikey: str, procs) -> Optional[bytes]:
        from dlrover_tpu_torch.checkpoint import peer as peer_mod

        candidates = [
            p for p in (procs or sorted(self._peers))
            if p in self._peers and p != self._me
        ]
        # replicas first, then any advertised survivor: a resized
        # world's process numbering must not hide a peer that holds it
        for p in sorted(self._peers):
            if p not in candidates and p != self._me:
                candidates.append(p)
        for p in candidates:
            try:
                raw = peer_mod.fetch_shard(
                    self._peers[p], self._step, pkey, ikey,
                    timeout=self._timeout,
                )
            except Exception as e:
                _count_peer_fetch("error")
                logger.warning(
                    "peer shard fetch from proc %s failed: %s", p, e)
                continue
            if raw is None:
                _count_peer_fetch("miss")
                continue
            return raw
        return None


class StoreSource:
    """The object store's process files for a committed step, read
    member-at-a-time through the location table (never a whole-archive
    download per shard)."""

    tier = "store"

    def __init__(self, store, step: int, attempt: str,
                 locations: Dict[str, Tuple[int, str]]):
        self._store = store
        self._step = int(step)
        self._attempt = attempt
        self._locations = locations
        self._files: Dict[int, Any] = {}

    def _zip_for(self, proc: int):
        if proc not in self._files:
            f = self._store.open_read(
                ckpt_store.step_key(self._step, proc, self._attempt))
            self._files[proc] = zipfile.ZipFile(f)
        return self._files[proc]

    def fetch(self, pkey: str, ikey: str, procs) -> Optional[bytes]:
        loc = self._locations.get(mf.joined_key(pkey, ikey))
        if loc is None:
            return None
        proc, member = loc
        try:
            return self._zip_for(proc).read(member)
        except KeyError:
            return None

    def close(self) -> None:
        for zf in self._files.values():
            try:
                zf.close()
            except Exception:
                pass


def _count_peer_fetch(result: str) -> None:
    counter(
        "dlrover_ckpt_peer_fetches_total",
        "Peer-tier shard fetches by outcome", ["result"],
    ).labels(result=result).inc()


# ------------------------------------------------------------------ restore


class _Fetcher:
    """One restore's shard access: tiered fetch, digest check and a
    per-shard memo (overlapping needed domains reuse a fetched member
    instead of pulling it again)."""

    def __init__(self, catalog: StepCatalog, sources: List[Any]):
        self.catalog = catalog
        self.sources = [s for s in sources if s is not None]
        self.cache: Dict[str, torch.Tensor] = {}
        self.stats = {
            "local": 0, "peer": 0, "store": 0, "live": 0,
            "digest_mismatch": 0, "bytes": 0, "local_bytes": 0,
            "peer_bytes": 0, "store_bytes": 0, "live_bytes": 0,
        }

    def get(self, pkey: str, ikey: str, procs) -> torch.Tensor:
        key = mf.joined_key(pkey, ikey)
        if key in self.cache:
            return self.cache[key]
        want = self.catalog.digests.get(key)
        enc = self.catalog.encodings.get(key)
        tried: List[str] = []
        for i, src in enumerate(self.sources):
            try:
                raw = src.fetch(pkey, ikey, procs)
            except Exception as e:
                logger.warning("%s-tier shard fetch failed: %s", src.tier, e)
                raw = None
            if raw is None:
                tried.append(src.tier)
                continue
            if isinstance(raw, torch.Tensor):
                # an in-process source (the live tier) handed back the
                # tensor itself: the bytes never left this process nor
                # went through npy, so there is nothing to decode or
                # digest-check, and the assembly copies it device to
                # device
                n = raw.numel() * raw.element_size()
                self.stats[src.tier] = self.stats.get(src.tier, 0) + 1
                self.stats["bytes"] += n
                self.stats[f"{src.tier}_bytes"] = self.stats.get(
                    f"{src.tier}_bytes", 0) + n
                self.cache[key] = raw
                return raw
            if want is not None and hashlib.sha256(raw).hexdigest() != want:
                # journal the mismatch, then fetch this one shard from
                # the next tier before giving up on the step
                self.stats["digest_mismatch"] += 1
                if src.tier == "peer":
                    _count_peer_fetch("digest_mismatch")
                record(
                    "checkpoint.restore_fallback", step=self.catalog.step,
                    requested_step=self.catalog.step,
                    reason="digest_mismatch", tier=src.tier,
                    shard=key[:160],
                )
                record(
                    "ckpt.shard_refetch", step=self.catalog.step,
                    shard=key[:160], failed_tier=src.tier,
                    next_tiers=[s.tier for s in self.sources[i + 1:]],
                )
                tried.append(src.tier)
                continue
            if enc is None and hasattr(src, "enc_for"):
                enc = src.enc_for(key)
            arr = _decode_member(raw, enc)
            self.stats[src.tier] += 1
            self.stats["bytes"] += len(raw)
            self.stats[f"{src.tier}_bytes"] += len(raw)
            if src.tier == "peer":
                _count_peer_fetch("ok")
                record(
                    "ckpt.peer_fetch", step=self.catalog.step,
                    shard=key[:160], result="ok", bytes=len(raw),
                )
            self.cache[key] = arr
            return arr
        raise ShardUnavailableError(
            f"step {self.catalog.step}: shard {key[:160]!r} "
            f"unavailable from every tier (tried {tried})"
        )


def _gather_domain(fetcher: _Fetcher, leaf: Dict[str, Any],
                   pkey: str, nidx: List[List[int]],
                   device=None) -> torch.Tensor:
    """One needed domain of one logical tensor, from whatever saved
    domains cover it (an exact hit is one member fetch; otherwise it is
    assembled from every overlapping saved shard, on ``device``: the
    target's, so that live shards move device to device)."""
    ikey = mf.index_key(nidx)
    domains = leaf.get("domains") or []
    by_key = {mf.index_key(d["idx"]): d for d in domains}
    if ikey in by_key:
        arr = fetcher.get(pkey, ikey, by_key[ikey].get("replicas"))
        return arr.reshape(mf.domain_shape(nidx))
    out = torch.empty(mf.domain_shape(nidx),
                      dtype=ckpt_store.torch_dtype(leaf["dtype"]),
                      device=device)
    covered = 0
    for d in domains:
        ov = mf.overlap(d["idx"], nidx)
        if ov is None:
            continue
        src = fetcher.get(
            pkey, mf.index_key(d["idx"]), d.get("replicas")
        ).reshape(mf.domain_shape(d["idx"]))
        dst_sl = tuple(
            slice(s - n[0], e - n[0]) for (s, e), n in zip(ov, nidx))
        src_sl = tuple(
            slice(s - o[0], e - o[0]) for (s, e), o in zip(ov, d["idx"]))
        out[dst_sl] = src[src_sl]
        covered += mf.domain_volume(ov)
    if covered != mf.domain_volume(nidx):
        raise ShardUnavailableError(
            f"step {fetcher.catalog.step}: domain {nidx} of "
            f"{pkey[:120]} only {covered}/{mf.domain_volume(nidx)} "
            "covered by the saved domains"
        )
    return out


def _leaf_value(fetcher: _Fetcher, leaf: Dict[str, Any], target=None,
                where: str = ""):
    """One logical leaf: a py leaf from the manifest, an 'array' leaf
    from its owner's member, a 'shards' leaf assembled whole; a tensor
    lands on the target tensor's device (shape and dtype checked)."""
    pkey = mf.path_key(leaf["path"])
    kind = leaf.get("kind")
    if kind == "py":
        return leaf.get("v")
    if isinstance(target, ckpt_store.ShardedLeaf):
        # only the boxes this process holds, each from whatever saved
        # domains cover it
        if kind != "shards" or leaf.get("dtype") != ckpt_store.dtype_name(
                target.dtype) or [int(n) for n in leaf["shape"]] != list(
                target.shape):
            raise ckpt_store.ArchiveError(
                f"{where}: archive leaf {leaf.get('dtype')}"
                f"{leaf.get('shape')} does not match the target")
        return target.with_tensors([
            ckpt_store._onto(_gather_domain(
                fetcher, leaf, pkey, mf.normalize_index(idx, leaf["shape"]),
                device=t.device), t, where)
            for idx, t in target.pieces])
    if kind == "array":
        value = fetcher.get(pkey, "full", leaf.get("replicas"))
    elif kind == "shards":
        shape = [int(n) for n in leaf["shape"]]
        value = _gather_domain(
            fetcher, leaf, pkey, [[0, n] for n in shape],
            device=target.device if isinstance(target, torch.Tensor)
            else None)
    else:
        raise ckpt_store.ArchiveError(f"unknown leaf kind {kind!r}")
    return ckpt_store._onto(value, target, where)


def restore_from_catalog(catalog: StepCatalog, target: Any,
                         sources: List[Any]):
    """Assemble the step onto ``target`` (a tree of the state's
    structure; each tensor comes back on its target tensor's device),
    or, without a target, into nested dicts of CPU tensors. Returns
    ``(state, step, stats)``; raises :class:`ShardUnavailableError` or
    ``ckpt_store.ArchiveError`` when the step cannot be fully and
    verifiably assembled."""
    fetcher = _Fetcher(catalog, sources)
    by_path = {mf.path_key(e["path"]): e for e in catalog.leaves}
    if target is not None:
        flat = ckpt_store.flatten_with_path(target)
        tpaths = [mf.path_key(comps) for comps, _ in flat]
        if set(tpaths) != set(by_path):
            missing = sorted(set(tpaths) - set(by_path))[:3]
            extra = sorted(set(by_path) - set(tpaths))[:3]
            raise ckpt_store.ArchiveError(
                f"checkpoint/target structure mismatch "
                f"(missing={missing}, extra={extra})"
            )
        leaves = [_leaf_value(fetcher, by_path[p], tgt, p)
                  for p, (_, tgt) in zip(tpaths, flat)]
        state = ckpt_store.unflatten_like(target, leaves)
    else:
        root: Dict[Any, Any] = {}
        for e in catalog.leaves:
            node = root
            comps = e["path"]
            for i, c in enumerate(comps):
                key = c.get("k", c.get("i"))
                if i == len(comps) - 1:
                    node[key] = _leaf_value(fetcher, e)
                else:
                    node = node.setdefault(key, {})
        state = root if catalog.leaves else None
    return state, catalog.step, fetcher.stats
