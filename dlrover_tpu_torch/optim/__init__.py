"""The optimizers, as optimizer factories (a factory is called on the
parameters its optimizer steps):

- ``optimizers``: optax's ``adamw``, ``adam`` and ``adagrad``, and
  ``Fp32GradAdamW`` (AdamW on fp32 gradients), which the trainer
  (``trainer/sharded.py``) carries; ``state``: their state as optax's
  tree;

and those of ``dlrover_tpu/optim``:

- ``master_weights`` / ``bf16_adamw``: fp32 master copies of bf16
  parameters, and AdamW over them with a bf16 first moment;
- ``nonfinite_guard`` / ``guard_stats``: the whole update skipped, on
  the device, when the global gradient norm is not finite;
- ``wsam_value_and_grad``: Weighted Sharpness-Aware Minimization as a
  ``ShardedTrainer(value_and_grad=...)`` hook.
"""

from dlrover_tpu_torch.optim.bf16 import (  # noqa: F401
    MasterWeights,
    NonfiniteGuard,
    bf16_adamw,
    guard_stats,
    master_weights,
    nonfinite_guard,
)
from dlrover_tpu_torch.optim.wsam import wsam_value_and_grad  # noqa: F401
