"""The work lists of the persistent flash kernels (ops/cuda/schedule.py):
every item exactly once, each CTA's items heaviest first, the load spread
evenly, and the item numbering and costs the kernels decode. CPU only:
the lists are built in Python and copied to the card as they are."""

import pytest

from dlrover_tpu_torch.ops.cuda import schedule

# (b, s, h, kvh): the Llama-1.1B step, a single tile, an odd tile count,
# an odd GQA group
SHAPES = [(3, 2048, 32, 4), (1, 128, 4, 2), (2, 384, 8, 2), (2, 256, 6, 2)]


def _cases():
    for b, s, h, kvh in SHAPES:
        for causal in (True, False):
            parts = schedule.dkv_parts(h, kvh)
            yield (f"fwd-{b}x{s}x{h}-{'causal' if causal else 'full'}",
                   schedule.fwd_costs(b, s, h, causal))
            yield (f"dq-{b}x{s}x{h}-{'causal' if causal else 'full'}",
                   schedule.dq_costs(b, s, h, causal))
            yield (f"dkv-{b}x{s}x{h}x{kvh}-{'causal' if causal else 'full'}",
                   schedule.dkv_costs(b, s, h, kvh, causal, parts))


CASES = list(_cases())


def _lists(sched, n_ctas):
    """The schedule array back as one item list per CTA, as the kernels
    read it."""
    offsets, flat = sched[:n_ctas + 1], sched[n_ctas + 1:]
    return [list(flat[offsets[c]:offsets[c + 1]]) for c in range(n_ctas)]


@pytest.mark.parametrize("workers", [132, 7, 1])
@pytest.mark.parametrize("costs", [c for _, c in CASES],
                         ids=[name for name, _ in CASES])
def test_lpt_covers_every_item_once_heaviest_first(costs, workers):
    sched = schedule.lpt(costs, workers)
    n_ctas = min(workers, len(costs))
    assert len(sched) == n_ctas + 1 + len(costs)
    offsets = sched[:n_ctas + 1]
    assert offsets[0] == 0 and offsets[-1] == len(costs)
    assert all(a <= b for a, b in zip(offsets, offsets[1:]))
    lists = _lists(sched, n_ctas)
    flat = [item for items in lists for item in items]
    assert sorted(flat) == list(range(len(costs)))
    for items in lists:
        assert items, "a CTA with no work"
        assert all(costs[a] >= costs[b] for a, b in zip(items, items[1:]))
    # longest processing time first: no CTA ends more than one item's
    # cost after the least loaded one
    loads = [sum(costs[i] for i in items) for items in lists]
    assert max(loads) - min(loads) <= max(costs)


def test_lpt_deals_the_heaviest_items_first():
    costs = [3, 9, 1, 9, 5, 7]
    lists = _lists(schedule.lpt(costs, 2), 2)
    assert lists == [[1, 5, 2], [3, 4, 0]]


@pytest.mark.parametrize("causal", [True, False])
def test_fwd_costs_follow_the_kernel_numbering(causal):
    b, s, h = 2, 512, 3
    nq = s // schedule.FWD_TILE
    costs = schedule.fwd_costs(b, s, h, causal)
    assert len(costs) == b * h * nq
    for item, cost in enumerate(costs):
        qt = item % nq  # the kernel's decode: (b * h + h_i) * nq + qt
        tiles = qt + 1 if causal else nq
        assert cost == tiles + schedule.ITEM_OVERHEAD


@pytest.mark.parametrize("causal", [True, False])
def test_dq_costs_follow_the_kernel_numbering(causal):
    b, s, h = 2, 512, 3
    nq = s // schedule.DQ_TILE
    costs = schedule.dq_costs(b, s, h, causal)
    assert len(costs) == b * h * nq
    for item, cost in enumerate(costs):
        qt = item % nq  # the kernel's decode: (b * h + h_i) * nq + qt
        tiles = qt + 1 if causal else nq
        assert cost == tiles + schedule.ITEM_OVERHEAD


def test_dq_schedule_at_the_step_shape():
    """1,536 items and 13,056 128-key steps at the Llama-1.1B step: about
    99 steps for each of an H100's 132 SMs."""
    costs = schedule.dq_costs(3, 2048, 32, True)
    steps = sum(c - schedule.ITEM_OVERHEAD for c in costs)
    assert (len(costs), steps) == (1536, 13056)


@pytest.mark.parametrize("causal", [True, False])
def test_dkv_costs_follow_the_kernel_numbering(causal):
    b, s, h, kvh = 2, 512, 8, 2
    parts = schedule.dkv_parts(h, kvh)
    nk = s // schedule.DKV_K_TILE
    nq = s // schedule.DKV_Q_TILE
    costs = schedule.dkv_costs(b, s, h, kvh, causal, parts)
    assert len(costs) == b * kvh * parts * nk
    heads = h // kvh // parts
    for item, cost in enumerate(costs):
        kt = item % nk  # ((b * kvh + kvh_i) * parts + part) * nk + kt
        q_tiles = nq - 2 * kt if causal else nq
        assert cost == heads * q_tiles + schedule.ITEM_OVERHEAD
    # every (query head, q tile, k tile) step once across the parts
    steps = sum(c - schedule.ITEM_OVERHEAD for c in costs)
    per_head = sum(nq - 2 * kt for kt in range(nk)) if causal else nq * nk
    assert steps == b * h * per_head


def test_dkv_parts_split_even_groups_only():
    assert schedule.dkv_parts(32, 4) == 2
    assert schedule.dkv_parts(6, 2) == 1
    assert schedule.dkv_parts(4, 4) == 1
