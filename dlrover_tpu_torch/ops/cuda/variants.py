"""Check and time the three flash kernels under other work schedules
than the one they ship with.

    python -m dlrover_tpu_torch.ops.cuda.variants [--rounds N]

Needs the card. In one process and in turns (the order reversed in every
other round), it runs the shipped schedule -- one CTA per SM walking a
longest-first list, the dK/dV kernel's GQA group cut in two parts -- and
its alternatives: the group in one part or in four, and one CTA per work
item in the list's order, which leaves the order to the hardware. For
each it holds forward, dQ and dK/dV against their plain versions at six
shapes (``chip_smoke.closeness``), checks that a second launch gives the
same bits, and times forward, dQ, dK/dV and SDPA's forward at the
Llama-1.1B step's shape (``chip_smoke.time_ms``); the parts of the group
touch dK/dV only, so dQ's turns under them measure the spread. Prints
one JSON line per turn, then the card's name and power limit; exits 1 if
any turn was wrong. PERF.md's schedule comparison comes from it.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]

#: (b, s, h, kvh, d, causal): one tile, an odd tile count, D=128, work
#: items across batches and heads, the step's shape last (timed)
SHAPES = [(1, 128, 2, 2, 64, True), (2, 256, 4, 4, 128, False),
          (1, 384, 8, 1, 64, True), (1, 384, 8, 1, 128, True),
          (3, 1024, 32, 4, 64, False), (3, 2048, 32, 4, 64, True)]
#: name: (parts of the dK/dV group, or None for the shipped rule; one
#: CTA per work item)
VARIANTS = {"shipped": (None, False), "parts1": (1, False),
            "parts4": (4, False), "one_item_per_cta": (None, True)}


@contextlib.contextmanager
def _variant(parts, one_item_per_cta: bool):
    """The wrappers' schedule rules swapped for the variant's, and their
    cached work lists dropped, for the duration."""
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa
    from dlrover_tpu_torch.ops.cuda import schedule

    lpt, dkv_parts = schedule.lpt, schedule.dkv_parts
    if one_item_per_cta:
        schedule.lpt = lambda costs, n_workers: lpt(costs, len(costs))
    if parts:
        schedule.dkv_parts = (
            lambda h, kvh: parts if (h // kvh) % parts == 0 else 1)
    fa._SCHEDULES.clear()
    try:
        yield
    finally:
        schedule.lpt, schedule.dkv_parts = lpt, dkv_parts
        fa._SCHEDULES.clear()


def run(name: str) -> dict:
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa

    results = []
    with _variant(*VARIANTS[name]):
        for b, s, h, kvh, d, causal in SHAPES:
            q, k, v, do = chip_smoke._inputs(b, s, h, kvh, d)
            scale = d ** -0.5
            o, lse = fa.fwd(q, k, v, causal, scale)
            o_ref, lse_ref = fa.fwd_plain(q, k, v, causal, scale)
            args = (q, k, v, do, lse_ref, fa.attention_delta(o_ref, do),
                    causal, scale)
            dq = fa.dq(*args)
            dk, dv = fa.dkv(*args)
            dk_ref, dv_ref = fa.dkv_plain(*args)
            readings = [chip_smoke.closeness(label, got, want)
                        for label, got, want in (
                            ("o", o, o_ref), ("lse", lse, lse_ref),
                            ("dq", dq, fa.dq_plain(*args)),
                            ("dk", dk, dk_ref), ("dv", dv, dv_ref))]
            o2, lse2 = fa.fwd(q, k, v, causal, scale)
            dq2 = fa.dq(*args)
            dk2, dv2 = fa.dkv(*args)
            r = {"shape": [b, s, h, kvh, d, causal],
                 "ok": all(x["ok"] for x in readings),
                 "worst_atol_needed": max(x.get("atol_needed", 0.0)
                                          for x in readings),
                 "bitwise": all(torch.equal(x, y) for x, y in (
                     (o, o2), (lse, lse2), (dq, dq2), (dk, dk2),
                     (dv, dv2)))}
            if (b, s) == (3, 2048):
                qt, kt, vt = (x.transpose(1, 2).contiguous()
                              for x in (q, k, v))
                r.update(
                    fwd_ms=chip_smoke.time_ms(
                        lambda: fa.fwd(q, k, v, causal, scale)),
                    dkv_ms=chip_smoke.time_ms(lambda: fa.dkv(*args)),
                    dq_ms=chip_smoke.time_ms(lambda: fa.dq(*args)),
                    sdpa_fwd_ms=chip_smoke.time_ms(
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=causal, enable_gqa=True)))
            results.append(r)
    return {"variant": name, "results": results}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    # the plain versions' fp32 products must not drop to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    ok = True
    for rnd in range(args.rounds):
        names = list(VARIANTS)
        for name in names if rnd % 2 == 0 else names[::-1]:
            out = run(name)
            ok &= all(r["ok"] and r["bitwise"] for r in out["results"])
            print(json.dumps({"round": rnd, **out}), flush=True)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
