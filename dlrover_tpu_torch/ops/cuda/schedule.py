"""Longest-first work lists for the persistent flash kernels.

The forward, dQ and dK/dV kernels run one CTA per SM, and each CTA walks
its own share of a list of work items. Under causal masking the items
differ in length by up to 16x (a q tile at the end of the sequence sees
every k tile, the first sees one), so the list is dealt out longest
first, each item to the CTA with the least work so far (LPT scheduling):
every CTA ends within about one short item of the others.

A schedule is one int32 array: ``n_ctas + 1`` offsets, then the items in
CTA order; CTA ``c`` runs ``items[offsets[c]:offsets[c + 1]]`` in that
order (heaviest first). The item numbering is the kernels' own:

- forward and dQ, ``(b * heads + h) * (seq // 128) + q_tile``;
- dK/dV, ``((b * kv_heads + kvh) * parts + part) * (seq // 128) +
  k_tile``, where ``part`` is one of ``parts`` equal slices of the GQA
  group's query heads.

Cost is counted in tile steps of the item's inner loop, plus a constant
for its prologue and epilogue: for the forward and dQ, the 128-key k
tiles the item's 128-row q tile reads (the dQ kernel walks them as 64-key
tiles at head_dim 128, which doubles every item's steps alike).
"""

import heapq
from typing import List, Sequence

#: q and k/v tile rows of the forward; q tile rows of dQ; k/v tile rows
#: of dK/dV
FWD_TILE = 128
DQ_TILE = 128
DKV_K_TILE = 128
#: q tile rows of the dK/dV kernel's inner loop
DKV_Q_TILE = 64
#: an item's fixed cost, in inner-loop steps (loads of the resident
#: tiles, the epilogue's stores)
ITEM_OVERHEAD = 1


def lpt(costs: Sequence[int], n_workers: int) -> List[int]:
    """Deal ``costs``' items to at most ``n_workers`` workers, longest
    first, each to the least-loaded worker (ties: lowest index); the
    schedule array described in the module docstring."""
    n_workers = max(1, min(n_workers, len(costs)))
    order = sorted(range(len(costs)), key=lambda i: (-costs[i], i))
    heap = [(0, w) for w in range(n_workers)]
    lists: List[List[int]] = [[] for _ in range(n_workers)]
    for item in order:
        load, w = heapq.heappop(heap)
        lists[w].append(item)
        heapq.heappush(heap, (load + costs[item], w))
    offsets, flat = [0], []
    for items in lists:
        flat += items
        offsets.append(len(flat))
    return offsets + flat


def _q_tile_costs(b: int, s: int, h: int, causal: bool,
                  tile: int) -> List[int]:
    """Cost of each (b, h, q tile) item: the k tiles of ``tile`` keys its
    q tile of ``tile`` rows reads."""
    nq = s // tile
    return [(qt + 1 if causal else nq) + ITEM_OVERHEAD
            for _ in range(b * h) for qt in range(nq)]


def fwd_costs(b: int, s: int, h: int, causal: bool) -> List[int]:
    """Cost of each forward item: the k tiles its q tile reads."""
    return _q_tile_costs(b, s, h, causal, FWD_TILE)


def dq_costs(b: int, s: int, h: int, causal: bool) -> List[int]:
    """Cost of each dQ item: the 128-key k tiles its q tile reads."""
    return _q_tile_costs(b, s, h, causal, DQ_TILE)


def dkv_parts(h: int, kvh: int) -> int:
    """Slices of the GQA group: two where the group splits evenly, which
    doubles the items (192 -> 384 at the Llama-1.1B step, for 132 SMs) at
    the price of an fp32 partial and one summing pass."""
    return 2 if (h // kvh) % 2 == 0 else 1


def dkv_costs(b: int, s: int, h: int, kvh: int, causal: bool,
              parts: int) -> List[int]:
    """Cost of each dK/dV item: its query heads times the 64-row q tiles
    its k tile reads."""
    nk, nq = s // DKV_K_TILE, s // DKV_Q_TILE
    heads = h // kvh // parts
    per_tile = [heads * (nq - (2 * kt if causal else 0)) + ITEM_OVERHEAD
                for kt in range(nk)]
    return per_tile * (b * kvh * parts)
