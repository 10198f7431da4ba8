"""Acceleration strategies: the searchable configuration space.

Counterpart of ``dlrover_tpu/auto/strategy.py``, copied with its
semantics: a strategy is a small, JSON-serializable value object --
(mesh shape x sharding rule table x remat policy x precision x accum
steps x context parallelism). Applying one never rewrites a model; it
parameterizes the trainer (``auto/accelerate.py``'s ``build_trainer``
over ``models.make_trainer_for``). The one number that differs is the
single-card envelope, :data:`SINGLE_CHIP_MAX_SEQ`, which is the H100's.
"""

import dataclasses
import json
from typing import List, Optional, Tuple

REMAT_POLICIES = ("off", "dots", "dots_attn_out", "minimal")
PRECISIONS = ("bf16", "fp32")

#: longest power-of-two sequence at which one llama_1b train step
#: (batch 1, remat "dots", AdamW) fits on one card: measured on an
#: NVIDIA H100 80GB HBM3 at 700 W by ``python -m
#: dlrover_tpu_torch.auto.probe`` (PERF.md: 32,768 tokens peak at
#: 48.7 GB, 65,536 run out of memory). Past this, sequence-parallel
#: candidates enter the search: the auto layer's gate for choosing ring
#: or Ulysses attention. A module constant that tests may set.
SINGLE_CHIP_MAX_SEQ = 32768
#: the flagship's per-token activation-cost proxy (hidden x layers of
#: llama_1b, the model the envelope was MEASURED on) — smaller models
#: extrapolate to proportionally longer single-chip sequences
_ENVELOPE_ACT_PROXY = 2048 * 22


def envelope_max_seq(hidden_size: int, num_layers: int) -> float:
    """Measured-envelope cap on the UNSHARDED per-chip sequence.

    Analytic activation models are optimistic at long sequence (the
    attention residual terms they fold into one per-token constant
    grow with seq); the measured envelope is ground truth for the
    flagship and extrapolates inversely with the per-token activation
    cost. Candidates leaving the sequence unsharded past this cap are
    unfit regardless of the analytic estimate, which is what pulls
    sequence-parallel candidates to the top past it."""
    proxy = max(1, hidden_size * num_layers)
    return SINGLE_CHIP_MAX_SEQ * max(
        1.0, _ENVELOPE_ACT_PROXY / proxy
    )


@dataclasses.dataclass(frozen=True)
class Strategy:
    """One point in the acceleration search space."""

    mesh_spec: Tuple[Tuple[str, int], ...]  # e.g. (("data",2),("fsdp",4))
    sharding: str = "fsdp"  # rule table name (parallel/sharding.py)
    remat: str = "dots"
    precision: str = "bf16"
    accum_steps: int = 1
    context_parallel: Optional[str] = None  # None | "ring" | "ulysses"

    def __post_init__(self):
        if self.remat not in REMAT_POLICIES:
            raise ValueError(f"remat {self.remat!r}")
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision {self.precision!r}")
        if self.accum_steps < 1:
            raise ValueError("accum_steps >= 1")

    @property
    def num_devices(self) -> int:
        n = 1
        for _, s in self.mesh_spec:
            n *= s
        return n

    def axis(self, name: str) -> int:
        for a, s in self.mesh_spec:
            if a == name:
                return s
        return 1

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["mesh_spec"] = [list(x) for x in self.mesh_spec]
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "Strategy":
        d = json.loads(s)
        d["mesh_spec"] = tuple(tuple(x) for x in d["mesh_spec"])
        return cls(**d)


def save_strategy(strategy: Strategy, path: str) -> None:
    with open(path, "w") as f:
        f.write(strategy.to_json())


def load_strategy(path: str) -> Strategy:
    with open(path) as f:
        return Strategy.from_json(f.read())


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def enumerate_strategies(
    num_devices: int,
    global_batch: int,
    max_tensor: int = 8,
    context_lengths_long: bool = False,
    num_experts: int = 0,
) -> List[Strategy]:
    """Candidate generation (parity: combination strategy generation,
    auto/engine/sg_algo/combination_sg.py) — every legal
    (data, fsdp, tensor[, seq|expert]) factorization with matching rule
    tables and remat policies."""
    out: List[Strategy] = []
    for tensor in _divisors(num_devices):
        if tensor > max_tensor:
            continue
        rest = num_devices // tensor
        for fsdp in _divisors(rest):
            data = rest // fsdp
            if global_batch % (data * fsdp):
                continue
            specs = [("data", data), ("fsdp", fsdp), ("tensor", tensor)]
            if tensor > 1:
                names = ["tp_fsdp" if fsdp > 1 else "tp"]
            elif fsdp > 1:
                # same mesh, three layouts: full FSDP vs opt-state-only
                # sharding (ZeRO-1) vs opt+grad sharding (ZeRO-2)
                names = ["fsdp", "zero1", "zero2"]
            else:
                names = ["ddp"]
            for name in names:
                for remat in ("dots", "dots_attn_out", "minimal"):
                    out.append(Strategy(
                        mesh_spec=tuple(specs), sharding=name,
                        remat=remat,
                    ))
    if context_lengths_long:
        # sequence_rules = tp_fsdp + seq: the fsdp factor shards
        # params/opt (a replicated flagship + Adam would not fit a
        # chip), the seq factor shards the context for ring attention
        for sp in _divisors(num_devices):
            if sp == 1:
                continue
            rest = num_devices // sp
            for fsdp in _divisors(rest):
                data = rest // fsdp
                if global_batch % max(data * fsdp, 1):
                    continue
                for kind in ("ring", "ulysses"):
                    # ulysses needs heads % sp == 0; the enumeration
                    # is model-blind, so auto_accelerate drops the
                    # indivisible ulysses candidates once it has cfg
                    out.append(Strategy(
                        mesh_spec=(
                            ("data", data), ("fsdp", fsdp),
                            ("seq", sp),
                        ),
                        sharding="sequence", remat="dots",
                        context_parallel=kind,
                    ))
    if num_experts > 1:
        for ep in _divisors(min(num_devices, num_experts)):
            if ep == 1:
                continue
            data = num_devices // ep
            if num_devices % ep or global_batch % max(data, 1):
                continue
            out.append(Strategy(
                mesh_spec=(("data", data), ("expert", ep)),
                sharding="tp_fsdp", remat="dots",
            ))
    return out
