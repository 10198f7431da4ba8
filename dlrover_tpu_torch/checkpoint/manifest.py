"""Format-v2 manifest schema: logical-array shards + owner election.

The sharded checkpoint plane (docs/CHECKPOINT.md, format v2) describes
a save as a set of *logical arrays* — name (the jax key path), global
shape/dtype, and a partition of the global index space into *domains*
(`[[start, stop], ...]` per dimension) — decoupled from the physical
layout that produced it. Every host can compute the SAME global domain
map locally from `sharding.devices_indices_map` (a global view every
process holds), so the metadata needs no collective to agree:

  * ``normalize_index`` makes domains canonical (replicated dims arrive
    as ``slice(None)``, partitioned dims as concrete slices — keys must
    compare equal across hosts and across save/restore);
  * ``elect_owner`` deterministically picks ONE replica process per
    domain (crc32 spread over the domain key — NEVER Python ``hash()``,
    which is salted per process and would elect different owners on
    different hosts), so aggregate persisted bytes stop scaling with
    the data-parallel world size;
  * ``shard_key`` names a domain globally (leaf path + domain), the
    identity used by the step manifest, the peer protocol and the
    restore planner;
  * ``merge_index_pieces`` folds every host's per-archive manifest into
    the one step manifest rank 0 publishes next to the COMMIT marker.

Pure stdlib + json: this module is imported by the low-level archive
codec (trainer/ckpt_store.py) and must not import jax or the rest of
the checkpoint package.
"""

import json
import zlib
from typing import Any, Dict, Iterable, List, Optional, Sequence

__all__ = [
    "normalize_index",
    "index_key",
    "path_key",
    "shard_key",
    "elect_owner",
    "domain_shape",
    "overlap",
    "merge_index_pieces",
    "ManifestError",
]


class ManifestError(ValueError):
    """A step manifest failed validation (incomplete piece set, shard
    with no recorded member, conflicting metadata across hosts)."""


def normalize_index(index, shape: Sequence[int]) -> List[List[int]]:
    """Canonical concrete domain for a shard index.

    Accepts a tuple of slices (``shard.index`` /
    ``devices_indices_map`` values) or an already-JSON ``[[s, e], ...]``
    doc; replicated dims (``slice(None)`` / null bounds) become the
    full ``[0, dim]`` extent so the same domain always produces the
    same key regardless of which sharding expressed it."""
    out: List[List[int]] = []
    for d, sl in enumerate(index):
        if isinstance(sl, slice):
            start, stop = sl.start, sl.stop
            if sl.step not in (None, 1):
                raise ManifestError(f"strided shard index {index!r}")
        else:
            start, stop = sl[0], sl[1]
        out.append([
            0 if start is None else int(start),
            int(shape[d]) if stop is None else int(stop),
        ])
    if len(out) != len(shape):
        raise ManifestError(
            f"index rank {len(out)} != array rank {len(shape)}"
        )
    return out


def index_key(idx_doc: List[List[int]]) -> str:
    return json.dumps(idx_doc, separators=(",", ":"))


def path_key(path_components: List[Dict[str, Any]]) -> str:
    # sort_keys: path components round-trip through JSON (archive
    # manifests, index pieces, the peer protocol) where dict key order
    # is not preserved by every writer — the key must be canonical
    return json.dumps(
        path_components, separators=(",", ":"), sort_keys=True
    )


def shard_key(pkey: str, idx_doc) -> str:
    """Global identity of one logical shard: leaf path + domain. The
    ``"full"`` marker names non-sharded ("array" kind) leaves."""
    if idx_doc == "full":
        return pkey + "|full"
    return pkey + "|" + index_key(idx_doc)


def joined_key(pkey: str, ikey: str) -> str:
    """shard key from an ALREADY-ENCODED index key (``index_key``
    output or ``"full"``) — never re-encode an encoded key."""
    return pkey + "|" + ikey


def elect_owner(key: str, replicas: Sequence[int]) -> int:
    """The one process that persists this shard. Deterministic on every
    host (crc32, not the salted builtin hash) and spread across the
    replica set so dedup does not pile every byte onto rank 0."""
    reps = sorted(int(p) for p in replicas)
    if not reps:
        raise ManifestError(f"shard {key!r} has no replicas")
    return reps[zlib.crc32(key.encode("utf-8")) % len(reps)]


def domain_shape(idx_doc: List[List[int]]) -> tuple:
    return tuple(int(e) - int(s) for s, e in idx_doc)


def domain_volume(idx_doc: List[List[int]]) -> int:
    vol = 1
    for s, e in idx_doc:
        vol *= max(0, int(e) - int(s))
    return vol


def overlap(a: List[List[int]], b: List[List[int]]
            ) -> Optional[List[List[int]]]:
    """Intersection of two domains of the same array (None if empty) —
    the restore planner fills a needed domain from every saved domain
    it overlaps, whatever topology saved them."""
    out = []
    for (s1, e1), (s2, e2) in zip(a, b):
        s, e = max(s1, s2), min(e1, e2)
        if s >= e:
            return None
        out.append([s, e])
    return out


# --------------------------------------------------------- step manifest


def _leaf_meta(entry: Dict[str, Any]) -> Dict[str, Any]:
    """An archive-manifest leaf stripped to topology-free metadata (no
    member refs — those live in the merged location table)."""
    meta = {"path": entry["path"], "kind": entry["kind"]}
    if entry["kind"] == "shards":
        meta["shape"] = entry["shape"]
        meta["dtype"] = entry["dtype"]
        meta["domains"] = entry.get("domains") or [
            {
                "idx": s["idx"],
                "replicas": s.get("replicas", [0]),
                "owner": s.get("owner", 0),
            }
            for s in entry["shards"]
        ]
    elif entry["kind"] == "array":
        meta["replicas"] = entry.get("replicas", [0])
        meta["owner"] = entry.get("owner", 0)
    else:  # py
        meta["v"] = entry.get("v")
    return meta


def _piece_locations(piece: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """shard_key -> {proc, m, sha256, enc?} for every member ONE host's
    archive actually contains (its index piece = its archive manifest)."""
    proc = int(
        (piece.get("topology") or {}).get("process_index", 0)
    )
    digests = piece.get("digests") or {}
    encodings = piece.get("encodings") or {}
    out: Dict[str, Dict[str, Any]] = {}
    for entry in piece.get("leaves", []):
        pkey = path_key(entry["path"])
        if entry["kind"] == "shards":
            for s in entry["shards"]:
                if "a" not in s:
                    continue  # metadata-only record (not held here)
                member = s["a"] + ".npy"
                loc = {
                    "proc": proc,
                    "m": member,
                    "sha256": digests.get(member),
                }
                enc = encodings.get(s["a"])
                if enc:
                    loc["enc"] = enc
                out[shard_key(pkey, s["idx"])] = loc
        elif entry["kind"] == "array" and "a" in entry:
            member = entry["a"] + ".npy"
            loc = {
                "proc": proc,
                "m": member,
                "sha256": digests.get(member),
            }
            enc = encodings.get(entry["a"])
            if enc:
                loc["enc"] = enc
            out[shard_key(pkey, "full")] = loc
    return out


def expected_keys(piece: Dict[str, Any]) -> List[str]:
    """Every shard key the GLOBAL domain map of one host's manifest
    names — what a complete step manifest must locate."""
    keys: List[str] = []
    for entry in piece.get("leaves", []):
        pkey = path_key(entry["path"])
        if entry["kind"] == "shards":
            for d in _leaf_meta(entry)["domains"]:
                keys.append(shard_key(pkey, d["idx"]))
        elif entry["kind"] == "array":
            keys.append(shard_key(pkey, "full"))
    return keys


def merge_index_pieces(pieces: Iterable[Dict[str, Any]],
                       step: int, attempt: str = "0",
                       last_good: Optional[bool] = None
                       ) -> Dict[str, Any]:
    """Fold per-host index pieces (each host's archive manifest) into
    the one step manifest: topology-free leaf metadata from any piece
    (every host computes the identical global domain map) plus a
    location table mapping every shard key to the process file + member
    + sha256 that persisted it. Raises :class:`ManifestError` when any
    globally-named shard ended up with no recorded member — an
    incomplete save must fail the commit, not surface at restore."""
    pieces = list(pieces)
    if not pieces:
        raise ManifestError("no index pieces to merge")
    base = pieces[0]
    locations: Dict[str, Dict[str, Any]] = {}
    for piece in pieces:
        if int(piece.get("step", step)) != int(step):
            raise ManifestError(
                f"index piece step {piece.get('step')} != {step}"
            )
        for key, loc in _piece_locations(piece).items():
            locations.setdefault(key, loc)
    missing = [k for k in expected_keys(base) if k not in locations]
    if missing:
        raise ManifestError(
            f"step {step}: {len(missing)} shard(s) have no persisted "
            f"member (first: {missing[0]!r})"
        )
    doc: Dict[str, Any] = {
        "format": 2,
        "step": int(step),
        "attempt": attempt,
        "topology": {
            "n_processes": int(
                (base.get("topology") or {}).get("n_processes", 1)
            ),
        },
        "leaves": [_leaf_meta(e) for e in base.get("leaves", [])],
        "locations": locations,
    }
    if last_good is not None:
        doc["last_good"] = bool(last_good)
    return doc
