"""The checkpoint plane's JAX-free schema (format v2), copied from
``dlrover_tpu/checkpoint``: ``manifest`` (domain normalization, shard
keys, owner election, step-manifest merge). The subset saver, the
layout-free loader and the peer tier come with the multi-process slice
(ROADMAP.md, queue A)."""

from dlrover_tpu_torch.checkpoint import manifest  # noqa: F401

__all__ = ["manifest"]
