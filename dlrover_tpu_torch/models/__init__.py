"""Model families of the port. Counterpart of ``dlrover_tpu/models``:
each family module exposes a config dataclass, the model, its loss,
``param_count`` and ``flops_per_token``, and the trainer layer
dispatches by config type. Llama (dense), GPT, the CNN and DLRM are
ported. A config of the JAX package routes by its class name too."""

_FAMILIES = {
    "LlamaConfig": "llama",
    "GPTConfig": "gpt",
    "CNNConfig": "cnn",
    "DLRMConfig": "dlrm",
}
#: each family's model class
_MODELS = {"llama": "Llama", "gpt": "GPT", "cnn": "CNN", "dlrm": "DLRM"}


def model_module_for(cfg):
    """The family module owning ``cfg``; raises on unknown config types
    rather than misrouting them."""
    name = type(cfg).__name__
    if name not in _FAMILIES:
        raise TypeError(
            f"unknown model family config {name!r}; register it in "
            "models.model_module_for"
        )
    import importlib

    return importlib.import_module(
        f"dlrover_tpu_torch.models.{_FAMILIES[name]}")


def meta_model(cfg):
    """The family's model of ``cfg`` on the meta device: its parameters'
    names, shapes and dtypes, nothing allocated."""
    mod = model_module_for(cfg)
    return getattr(mod, _MODELS[mod.__name__.rsplit(".", 1)[1]])(
        cfg, device="meta")


def example_batch(cfg, global_batch: int, seq_len: int = 1):
    """Zero-filled batch of the family's shape: LMs take (tokens,
    targets) int64 [batch, seq], the CNN (images, labels), DLRM (dense,
    cat_ids, labels)."""
    return model_module_for(cfg).example_batch(cfg, global_batch, seq_len)


def make_trainer_for(cfg, device=None, strategy=None,
                     accum_steps: int = 1, optimizer=None, attn_fn=None,
                     mesh=None):
    """Family-dispatched trainer constructor, the single seam the auto
    layer builds trainers through: ``mesh`` goes to the family's
    ``make_trainer`` (None: the family's default mesh), ``strategy=None``
    takes the family's own default ("rowwise" for DLRM, else "ddp")."""
    kw = {} if strategy is None else {"strategy": strategy}
    return model_module_for(cfg).make_trainer(
        cfg, device=device, accum_steps=accum_steps, optimizer=optimizer,
        attn_fn=attn_fn, mesh=mesh, **kw)
