"""Replica-deduplicated persist: owned-only subset archives.

A copy of ``dlrover_tpu/checkpoint/saver.py`` (stdlib only), so that
both packages write the same subset bytes.

The RAM tier keeps every addressable shard (fast local restart, and
the peer tier serves from it), but the object store only needs ONE
copy of each logical shard. This module turns a host's full RAM-tier
archive into its *owned subset*: the same archive format, containing
only the members whose deterministically-elected owner
(``manifest.elect_owner``) is this process. Non-owned shard records stay
in the manifest as metadata (domain + replicas + owner, no member
ref), so the subset manifest doubles as the host's *index piece* —
exactly what ``ckpt_store.merge_index_pieces`` folds into the step
manifest at commit.

Members are copied byte-for-byte from the RAM archive (no
re-serialization, no re-hashing: npy encoding is deterministic, so
the digests recorded at staging time remain valid), which keeps the
persist path's CPU cost proportional to OWNED bytes — with dp
replication, aggregate store traffic stops scaling with world size.
"""

import copy
import io
import json
import zipfile
from typing import Any, Dict, Tuple

__all__ = ["subset_archive"]


def subset_archive(
    fileobj, process_index: int
) -> Tuple[bytes, Dict[str, Any], Dict[str, int]]:
    """Build ``process_index``'s owned subset of a full v2 archive.

    Returns ``(subset_bytes, subset_manifest, stats)`` where stats
    report the dedup effect: ``bytes_full`` (every member this host
    staged) vs ``bytes_owned`` (what actually goes to the store).
    """
    me = int(process_index)
    with zipfile.ZipFile(fileobj) as zf:
        man = json.loads(zf.read("manifest.json").decode("utf-8"))
        sizes = {i.filename: i.file_size for i in zf.infolist()}
        sub = copy.deepcopy(man)
        sub["subset"] = True
        keep = set()
        stats = {
            "members_full": 0, "members_owned": 0,
            "bytes_full": 0, "bytes_owned": 0,
        }

        def _visit(rec: Dict[str, Any]) -> None:
            if "a" not in rec:
                return
            member = rec["a"] + ".npy"
            stats["members_full"] += 1
            stats["bytes_full"] += sizes.get(member, 0)
            if int(rec.get("owner", me)) == me:
                keep.add(member)
                stats["members_owned"] += 1
                stats["bytes_owned"] += sizes.get(member, 0)
            else:
                del rec["a"]

        for entry in sub.get("leaves", []):
            if entry.get("kind") == "shards":
                for rec in entry.get("shards", []):
                    _visit(rec)
            elif entry.get("kind") == "array":
                _visit(entry)

        kept_ids = {m[: -len(".npy")] for m in keep}
        if "digests" in sub:
            sub["digests"] = {
                m: d for m, d in sub["digests"].items() if m in keep
            }
        if "encodings" in sub:
            sub["encodings"] = {
                a: e for a, e in sub["encodings"].items()
                if a in kept_ids
            }

        buf = io.BytesIO()
        with zipfile.ZipFile(
            buf, "w", compression=zipfile.ZIP_STORED
        ) as out:
            for member in sorted(keep):
                out.writestr(member, zf.read(member))
            out.writestr(
                "manifest.json",
                json.dumps(sub, sort_keys=True).encode("utf-8"),
            )
    return buf.getvalue(), sub, stats
