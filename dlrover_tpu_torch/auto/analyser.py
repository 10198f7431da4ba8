"""Model analysis: parameter/FLOPs/memory estimates for strategy ranking.

Counterpart of ``dlrover_tpu/auto/analyser.py``: the closed-form memory
and step-time models the candidate ranking (``auto/accelerate.py``)
reads, over the port's model families (``models.model_module_for``).
The formulas and the dimensionless factors (``ACT_FACTOR``,
``REMAT_COMPUTE``) are the JAX package's, kept for parity; the rates are
the card's: the peak and the link rate default to the target card's
data-sheet numbers (``auto/device_context.py``), and ``auto_accelerate``
passes those of the card it runs on. Phase "auto" of ``chip_smoke.py``
prints how the estimates fare against the card's measured step.
"""

import dataclasses
from typing import Optional

from dlrover_tpu_torch.auto import device_context
from dlrover_tpu_torch.auto.strategy import Strategy

BYTES = {"bf16": 2, "fp32": 4}

#: the target card's peak dense bf16 FLOP/s and NVLink bytes/s per
#: direction (``device_context.TARGET_CARD``): the defaults of
#: :func:`estimate_step_time`
PEAK_FLOPS = device_context.peak_flops_per_chip(device_context.TARGET_CARD)
LINK_BANDWIDTH = device_context.link_bytes_per_second(
    device_context.TARGET_CARD)

# activation bytes per (token x hidden) per layer, by remat policy (the
# JAX package's factors): "dots" saves matmul outputs (~10x hidden per
# token-layer), "minimal" keeps only layer inputs, "dots_attn_out" is
# dots plus the attention residuals (q, k, v, o, lse) saved outside the
# checkpointed segments
ACT_FACTOR = {
    "off": 30.0, "dots": 12.0, "dots_attn_out": 16.0, "minimal": 2.5,
}
# step-FLOPs multiplier from rematerialization: fwd+bwd ~ 3x fwd; full
# recompute of the forward in the backward adds ~1 fwd (4/3); "dots"
# saves matmul outputs so only the cheap elementwise work is redone
REMAT_COMPUTE = {
    "off": 1.0, "dots": 1.08, "dots_attn_out": 1.02,
    "minimal": 4.0 / 3.0,
}


@dataclasses.dataclass
class ModelProfile:
    """Static facts about one model config."""

    param_count: int
    flops_per_token: float
    hidden_size: int
    num_layers: int
    vocab_size: int

    @classmethod
    def from_config(cls, cfg, seq_len: int) -> "ModelProfile":
        """Dispatch over the port's model families: any config whose
        module exposes param_count/flops_per_token."""
        from dlrover_tpu_torch.models import model_module_for

        mod = model_module_for(cfg)
        return cls(
            param_count=mod.param_count(cfg),
            flops_per_token=mod.flops_per_token(cfg, seq_len),
            hidden_size=cfg.hidden_size,
            num_layers=cfg.num_layers,
            vocab_size=cfg.vocab_size,
        )


@dataclasses.dataclass
class MemoryEstimate:
    params_bytes: float
    optimizer_bytes: float
    gradient_bytes: float
    activation_bytes: float
    logits_bytes: float

    @property
    def total(self) -> float:
        return (self.params_bytes + self.optimizer_bytes
                + self.gradient_bytes + self.activation_bytes
                + self.logits_bytes)


def estimate_memory(
    profile: ModelProfile,
    strategy: Strategy,
    global_batch: int,
    seq_len: int,
) -> MemoryEstimate:
    """Per-device HBM estimate for one train step under a strategy.

    Param/opt/grad bytes divide by the axes that shard params (fsdp +
    tensor under the fsdp/tp rule tables); activations divide by the
    data axes (batch sharding) and seq axis."""
    b = BYTES[strategy.precision]
    shard = 1
    if strategy.sharding in ("fsdp", "tp_fsdp", "sequence", "pipeline"):
        shard *= strategy.axis("fsdp")
    if strategy.sharding in ("tp", "tp_fsdp", "sequence", "pipeline"):
        shard *= strategy.axis("tensor")
    shard *= strategy.axis("expert") or 1
    params_bytes = profile.param_count * b / shard
    optimizer_bytes = 2 * params_bytes  # adam m+v in param dtype
    gradient_bytes = params_bytes
    if strategy.sharding in ("zero1", "zero2"):
        # params replicated; Adam m+v sharded over fsdp; zero2 also
        # shards the grad accumulation buffer
        zshard = max(strategy.axis("fsdp"), 1)
        optimizer_bytes /= zshard
        if strategy.sharding == "zero2":
            gradient_bytes /= zshard

    dp = strategy.axis("data") * strategy.axis("fsdp")
    micro_tokens = (global_batch // max(dp, 1)) * seq_len
    micro_tokens //= max(strategy.accum_steps, 1)
    micro_tokens //= max(strategy.axis("seq"), 1)
    activation_bytes = (
        ACT_FACTOR[strategy.remat] * micro_tokens
        * profile.hidden_size * profile.num_layers * b
    ) / max(profile.num_layers, 1)  # remat: one layer live at a time,
    # scaled by saved-residual factor across layers
    activation_bytes *= profile.num_layers ** 0.5  # sublinear growth
    logits_bytes = 4.0 * micro_tokens * profile.vocab_size  # fp32
    tensor = strategy.axis("tensor")
    if tensor > 1:
        logits_bytes /= tensor
    return MemoryEstimate(
        params_bytes, optimizer_bytes, gradient_bytes,
        activation_bytes, logits_bytes,
    )


def estimate_step_time(
    profile: ModelProfile,
    strategy: Strategy,
    global_batch: int,
    seq_len: int,
    peak_flops: Optional[float] = None,
    mfu: float = 0.4,
    link_bandwidth: Optional[float] = None,
    comm_overlap: float = 0.0,
) -> float:
    """Analytic seconds/step: compute + collective terms.

    Collectives: fsdp all-gathers params once per MICRObatch (the
    gathered copy is freed after use, so accumulation re-gathers) and
    reduce-scatters grads once per step; tp moves ~activation-sized
    all-reduces per layer; pure DP all-reduces the full gradient.
    ``comm_overlap`` discounts the fsdp param traffic for async
    collectives (gather of block i+1 hidden under block i's compute —
    the standard FSDP prefetch); 0 models fully exposed comm.
    ``peak_flops`` and ``link_bandwidth`` (bytes/s per direction)
    default to :data:`PEAK_FLOPS` and :data:`LINK_BANDWIDTH`."""
    peak_flops = PEAK_FLOPS if peak_flops is None else peak_flops
    link_bw = LINK_BANDWIDTH if link_bandwidth is None else link_bandwidth
    dp = strategy.axis("data") * strategy.axis("fsdp")
    tokens = global_batch * seq_len
    model_parallel = strategy.axis("tensor") * max(strategy.axis("seq"), 1)
    compute = (
        tokens * profile.flops_per_token
        / max(dp * model_parallel, 1)
        / (peak_flops * mfu)
    ) * REMAT_COMPUTE[strategy.remat]

    b = BYTES[strategy.precision]
    comm = 0.0
    if strategy.axis("fsdp") > 1:
        # fsdp: all-gather(use) PER MICROBATCH + reduce-scatter(grad)
        # once; zero1/2: reduce-scatter(grad)+all-gather(update). Only
        # the fsdp per-micro GATHERS are prefetch-hidden (gather block
        # i+1 under block i's compute) — the end-of-step grad
        # reduce-scatter and zero1/2's update traffic have no compute
        # to hide under and stay fully exposed.
        param_vol = profile.param_count * b / link_bw
        if strategy.sharding in ("fsdp", "tp_fsdp", "sequence"):
            gathers = max(strategy.accum_steps, 1) * param_vol
            comm += gathers * (1.0 - comm_overlap) + param_vol
        else:  # zero1/zero2: RS(grad) + AG(update), both exposed
            comm += 2 * param_vol
    elif dp > 1:
        comm += 2 * profile.param_count * b / link_bw
    if strategy.axis("tensor") > 1:
        per_dev_tokens = tokens / max(dp, 1)
        comm += (
            4 * profile.num_layers * per_dev_tokens
            * profile.hidden_size * b
        ) / (link_bw * strategy.axis("tensor"))
    sp = strategy.axis("seq")
    if sp > 1 and strategy.context_parallel:
        # the ring/ulysses twins must NOT tie (the dedup/selection
        # downstream is otherwise blind to the kind): per layer, ring
        # rotates local K+V around the ring (sp-1 hops of 2 shards,
        # overlappable with the chunk compute — charge half exposed);
        # ulysses all-to-alls Q,K,V in and O out (4 transfers of the
        # local activation shard, exposed)
        local_act = (
            (tokens / max(dp, 1)) / sp * profile.hidden_size * b
        )
        per_layer = (
            0.5 * 2 * (sp - 1) * local_act
            if strategy.context_parallel == "ring"
            else 4.0 * local_act
        )
        comm += profile.num_layers * per_layer / link_bw
    return compute + comm
