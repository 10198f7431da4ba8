"""Parallel building blocks of the port (counterpart of
``dlrover_tpu/parallel``). Only the single-device embedding lookup is
ported; meshes and rule tables are ROADMAP.md queue A item 6."""
