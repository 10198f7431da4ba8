"""Parallel building blocks of the port (counterpart of
``dlrover_tpu/parallel``): the mesh over the ranks (``mesh.py``), the
rule tables of the sharding strategies (``sharding.py``), the Megatron
collectives of tensor parallelism (``tensor_parallel.py``) and the
embedding lookup of one device (``embedding.py``). Context and pipeline
parallelism and MoE are ROADMAP.md queue A items 1.3 and 1.4."""
