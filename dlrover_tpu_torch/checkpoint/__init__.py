"""The checkpoint plane's format v2, ported from ``dlrover_tpu/checkpoint``:

  manifest  the JAX-free schema (domain normalization, shard keys,
            owner election, step-manifest merge), copied
  saver     owned-only subset archives for the persist tier, copied
  loader    layout-free restore over the local, peer and store tiers
  peer      the ``/ckpt/shard`` endpoint logic and the master-KV peer
            registry

``manifest`` is imported eagerly (the archive codec depends on it); the
others load on first attribute access.
"""

from dlrover_tpu_torch.checkpoint import manifest  # noqa: F401

__all__ = ["manifest", "saver", "loader", "peer"]


def __getattr__(name):
    if name in ("saver", "loader", "peer"):
        import importlib

        return importlib.import_module(f"dlrover_tpu_torch.checkpoint.{name}")
    raise AttributeError(name)
