"""State migration for mesh transitions.

Three movers, one stats vocabulary:

* :func:`reshard_arrays` — the pure in-process path for boxes this rank
  already holds: each leaf's new boxes cut on the device out of the
  boxes it holds now (a box that did not change is kept as it is, no
  copy). Counts as ``device`` moves.
* :func:`migrate_live` — the archive-free hot path: every box of the
  NEW layout whose bytes still exist on a survivor is served straight
  out of the trainer's live tensors (:class:`LiveShardSource`, ``live``
  moves — no host npz, no sha256 re-hash of data that never left the
  process) and lands on the device by a device-to-device copy; only the
  domains nobody holds any more (the dead rank's rows) fall through to
  the checkpoint tiers below.
* :func:`migrate_from_checkpoint` — for boxes this rank does NOT hold
  (the dead rank's rows, or rows the remap hands to a different
  survivor, or everything on a joiner): assemble the last flash save
  through the tiered loader — this host's RAM archive (``local``),
  surviving peers' RAM tier over ``/ckpt/shard`` (``peer``), the
  persistent store (``store``) — every shard digest-verified before it
  is trusted.

All return a stats dict with the shared keys
``{"live","local","peer","store","device","digest_mismatch","bytes"}``,
and each source's bytes where it moved any (``<source>_bytes``);
:meth:`MeshTransition.note_migrated` journals it and feeds the
``dlrover_reshard_shard_moves_total{source}`` counters.

Counterpart of ``dlrover_tpu/reshard/migrate.py``, under the same
names. Where the JAX package moves ``jax.Array`` shards between
``NamedSharding``s with ``jax.device_put``, the port moves the boxes of
the trainer's state (``ckpt_store.ShardedLeaf``: the pieces a rank
holds, in the JAX tree's coordinates, as ``trainer/sharded.py``'s
``_Layout`` lays them out). A JAX device names the rank that holds a
shard; here ``held_fn`` takes that rank (a replica of the box's domain)
instead.
"""

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from dlrover_tpu_torch.checkpoint import manifest as mf
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.trainer import ckpt_store

#: the canonical per-source move-count keys
MOVE_SOURCES = ("live", "local", "peer", "store", "device")


def empty_stats() -> Dict[str, int]:
    stats = {s: 0 for s in MOVE_SOURCES}
    stats["digest_mismatch"] = 0
    stats["bytes"] = 0
    return stats


def merge_stats(*parts: Optional[Dict[str, int]]) -> Dict[str, int]:
    """The counts of ``parts`` summed by key. The port's
    ``last_restore_stats`` also names the restore's tier, step and
    seconds: those are not counts and are left out."""
    out = empty_stats()
    for p in parts:
        for k, v in (p or {}).items():
            if k in ("tier", "step", "seconds"):
                continue
            out[k] = out.get(k, 0) + int(v)
    return out


def _cut(pieces, idx) -> Optional[torch.Tensor]:
    """Box ``idx`` assembled on the device from held ``pieces`` (each
    ``(box, tensor)``), or None when they do not cover it."""
    for have, t in pieces:
        if [list(map(int, b)) for b in have] == idx:
            return t
    out, covered = None, 0
    for have, t in pieces:
        ov = mf.overlap(have, idx)
        if ov is None:
            continue
        if out is None:
            out = t.new_empty(mf.domain_shape(idx))
        out[tuple(slice(s - n[0], e - n[0]) for (s, e), n in zip(ov, idx))
            ] = t[tuple(slice(s - o[0], e - o[0])
                        for (s, e), o in zip(ov, have))]
        covered += mf.domain_volume(ov)
    return out if covered == mf.domain_volume(idx) else None


def reshard_arrays(state: Any, layouts: Any) -> Tuple[Any, Dict]:
    """Lay the boxes this rank holds into their new layout in-process.

    ``layouts`` is a tree congruent with ``state`` whose leaves are the
    new layout's ``ShardedLeaf``s (the target's boxes; their tensors
    are not read), or None to leave a leaf alone. Returns ``(state,
    stats)``: each new box taken from the held box that equals it (no
    copy) or cut on the device out of the held boxes that cover it,
    ``stats["device"]`` counting the leaves that moved. Raises
    ``ValueError`` for a box the held ones do not cover: those bytes
    are on another rank, and :func:`migrate_live` fetches them.
    """
    stats = empty_stats()
    flat = ckpt_store.flatten_with_path(state)
    targets = [t for _, t in ckpt_store.flatten_with_path(layouts)]
    if len(flat) != len(targets):
        raise ValueError("state and layouts differ in structure")
    leaves = []
    for (path, leaf), tgt in zip(flat, targets):
        if tgt is None or not isinstance(tgt, ckpt_store.ShardedLeaf):
            leaves.append(leaf)
            continue
        held = (leaf.pieces if isinstance(leaf, ckpt_store.ShardedLeaf)
                else [([[0, n] for n in leaf.shape], leaf)])
        boxes = [mf.normalize_index(idx, tgt.shape) for idx, _ in
                 tgt.pieces]
        got = [_cut(held, idx) for idx in boxes]
        missing = [idx for idx, t in zip(boxes, got) if t is None]
        if missing:
            raise ValueError(
                f"{mf.path_key(path)[:120]}: boxes {missing} are not "
                "held on this rank")
        if any(t is not h for t, (_, h) in zip(got, held)) or len(
                got) != len(held):
            n = sum(t.numel() * t.element_size() for t in got)
            stats["device"] += 1
            stats["bytes"] += n
            stats["device_bytes"] = stats.get("device_bytes", 0) + n
        leaves.append(ckpt_store.ShardedLeaf(tgt.shape, tgt.dtype, [
            (idx, t) for (idx, _), t in zip(tgt.pieces, got)], tgt.domains))
    return ckpt_store.unflatten_like(state, leaves), stats


class LiveShardSource:
    """The live state as a shard source for the tiered loader.

    Flattens a survivor's CURRENT state (a trainer's ``train_state()``
    tree) into ``(path, index) -> tensor`` under the keys the sharded
    checkpoint writes, and serves those members to
    :class:`~dlrover_tpu_torch.checkpoint.loader._Fetcher` ahead of
    every checkpoint tier. Served members stay tensors on their device
    end to end: the fetcher skips the npy decode and sha256 (the bytes
    never left this process), and the assembly copies them device to
    device into the new layout.

    ``held_fn(rank)`` narrows what this source claims to hold: a box is
    served when ``held_fn`` passes one of the ranks its domain lists as
    replicas. A process that stands in for several ranks (a test's
    virtual world) passes a predicate that excludes the dead rank, to
    model which bytes really survived.

    ``step`` pins the source to the step the live state holds; the
    checkpointer's walk-down then skips it for any other candidate
    instead of serving wrong-step bytes un-verified.
    """

    tier = "live"

    def __init__(self, state: Any, step: Optional[int] = None,
                 held_fn: Optional[Callable[[int], bool]] = None):
        self.step = step
        self._members: Dict[Tuple[str, str], torch.Tensor] = {}
        for path, leaf in ckpt_store.flatten_with_path(state):
            pkey = mf.path_key(path)
            if isinstance(leaf, ckpt_store.ShardedLeaf):
                replicas = {mf.index_key(mf.normalize_index(
                    d["idx"], leaf.shape)): d.get("replicas") or []
                    for d in leaf.domains}
                for idx, t in leaf.pieces:
                    nidx = mf.normalize_index(idx, leaf.shape)
                    ikey = mf.index_key(nidx)
                    if held_fn is not None and not any(
                            held_fn(int(r)) for r in replicas.get(ikey, [])):
                        continue
                    self._members[(pkey, ikey)] = t
                    if list(t.shape) == [int(n) for n in leaf.shape]:
                        # a whole box is also addressable by the
                        # whole-array key ("array"-kind fetches)
                        self._members[(pkey, "full")] = t
            elif isinstance(leaf, torch.Tensor):
                self._members[(pkey, "full")] = leaf
                self._members[(pkey, mf.index_key(
                    [[0, int(n)] for n in leaf.shape]))] = leaf

    def __len__(self) -> int:
        return len(self._members)

    def fetch(self, pkey: str, ikey: str, procs):
        return self._members.get((pkey, ikey))


def migrate_live(
    checkpointer,
    live_state: Any,
    target: Any = None,
    step: Optional[int] = None,
    live_step: Optional[int] = None,
    held_fn: Optional[Callable[[int], bool]] = None,
    extra_sources: Optional[List[Any]] = None,
) -> Tuple[Any, Optional[int], Dict]:
    """Archive-free migration: live redistribution first, checkpoint
    tiers only for what no survivor holds.

    ``live_state`` is this rank's current state (old layout);
    ``live_step`` is the step it corresponds to — pass it, or the
    source serves any candidate the restore walks down to.
    ``extra_sources`` rank between the live tier and the checkpoint
    tiers (a hot spare's pre-warmed cache). Returns
    ``(state, restored_step, stats)`` like
    :func:`migrate_from_checkpoint`; ``stats["live"]`` counts the
    fast-path moves.
    """
    sources: List[Any] = []
    if live_state is not None:
        src = LiveShardSource(
            live_state, step=live_step, held_fn=held_fn
        )
        if len(src):
            sources.append(src)
    sources.extend(extra_sources or [])
    state, got = checkpointer.restore(
        target=target, step=step, extra_sources=sources
    )
    stats = merge_stats(
        getattr(checkpointer, "last_restore_stats", None)
    )
    if state is None:
        logger.warning(
            "live migration found no restorable step (requested %s)",
            step,
        )
    return state, got, stats


def migrate_from_checkpoint(
    checkpointer,
    target: Any = None,
    step: Optional[int] = None,
    extra_sources: Optional[List[Any]] = None,
) -> Tuple[Any, Optional[int], Dict]:
    """Assemble this rank's NEW shard set from the last flash save.

    ``checkpointer`` must already be re-targeted at the post-
    transition topology (``process_index``/``n_processes`` of the new
    world); the tiered loader then fetches exactly the domains the new
    layout assigns here, preferring the cheapest tier that still has
    them. Returns ``(state, restored_step, stats)``; ``state`` is None
    when nothing was restorable (callers abort the transition).
    """
    state, got = checkpointer.restore(
        target=target, step=step, extra_sources=extra_sources
    )
    stats = merge_stats(
        getattr(checkpointer, "last_restore_stats", None)
    )
    if state is None:
        logger.warning(
            "reshard migration found no restorable step "
            "(requested %s)", step,
        )
    return state, got, stats
