"""dlrover_tpu_torch: the PyTorch / CUDA port of dlrover_tpu for NVIDIA
Hopper GPUs.

The JAX package ``dlrover_tpu`` stays the reference. This package keeps
its module and public function names where that helps a reader find the
counterpart, imports ``torch`` and never ``jax`` or ``dlrover_tpu``, and
replaces each Pallas TPU kernel with a CUDA kernel written for sm_90a
(``ops/cuda/csrc``). Entry points run on the GPU unless the caller asks
for the CPU.
"""
