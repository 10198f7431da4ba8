"""Model families of the port. Counterpart of ``dlrover_tpu/models``:
each family module exposes a config dataclass, the model, its loss,
``param_count`` and ``flops_per_token``, and the trainer layer
dispatches by config type. Only Llama (dense) is ported so far."""

#: families of the JAX package that the port has not reached yet
_NOT_PORTED = {
    "GPTConfig": "GPT (ROADMAP.md, queue A, 'Other families')",
    "CNNConfig": "the CNN (ROADMAP.md, queue A, 'Other families')",
    "DLRMConfig": "DLRM (ROADMAP.md, queue A, 'Other families')",
}


def model_module_for(cfg):
    """The family module owning ``cfg``; raises on unknown config types
    rather than misrouting them."""
    name = type(cfg).__name__
    if name == "LlamaConfig":
        from dlrover_tpu_torch.models import llama

        return llama
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name}: {_NOT_PORTED[name]} is not ported yet"
        )
    raise TypeError(
        f"unknown model family config {name!r}; register it in "
        "models.model_module_for"
    )


def make_trainer_for(cfg, device=None, strategy: str = "ddp",
                     accum_steps: int = 1, optimizer=None, attn_fn=None):
    """Family-dispatched trainer constructor."""
    model_module_for(cfg)
    from dlrover_tpu_torch.trainer.sharded import make_trainer_for_llama

    return make_trainer_for_llama(
        cfg, device=device, strategy=strategy, accum_steps=accum_steps,
        optimizer=optimizer, attn_fn=attn_fn,
    )
