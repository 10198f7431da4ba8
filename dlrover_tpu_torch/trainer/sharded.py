"""The train step on one GPU: loss, backward, AdamW, in place.

Counterpart of ``dlrover_tpu/trainer/sharded.py``. The class keeps its
name so that readers find the counterpart, but the port runs only the
``"ddp"`` strategy on one device so far; the rule-table strategies
(ZeRO, FSDP, TP, sequence) are later work (ROADMAP.md, queue A,
"Parallelism"). Where the JAX step donates its buffers, this one updates
the parameters and optimizer state in place. Gradient accumulation sums
the microbatches' gradients in fp32 buffers, as the JAX step does.
"""

from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.nn as nn

from dlrover_tpu_torch.auto.device_context import resolve_device
from dlrover_tpu_torch.common.log import default_logger as logger

OptimizerFactory = Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> OptimizerFactory:
    """``optax.adamw`` with its own defaults written out: eps 1e-8 and a
    weight decay of 1e-4 on every parameter, norms and embedding
    included (``torch.optim.AdamW`` would default to 1e-2)."""

    def make(params):
        return torch.optim.AdamW(
            params, lr=learning_rate, betas=(b1, b2), eps=eps,
            weight_decay=weight_decay,
        )

    return make


class ShardedTrainer:
    """Owns the model and its optimizer; ``train_step`` runs one update.

    Args:
      loss_fn: ``loss_fn(model, batch) -> scalar``.
      init_fn: ``init_fn(seed, device) -> nn.Module``.
      device: where to train; ``None`` is the GPU.
      strategy: only ``"ddp"`` (one device).
      optimizer: a factory from parameters to an optimizer (default
        ``adamw(3e-4)``, the JAX trainer's default).
      accum_steps: microbatches per optimizer update.
    """

    def __init__(
        self,
        loss_fn: Callable,
        init_fn: Callable,
        device=None,
        strategy: str = "ddp",
        optimizer: Optional[OptimizerFactory] = None,
        accum_steps: int = 1,
    ):
        if strategy != "ddp":
            raise NotImplementedError(
                f"strategy {strategy!r} is not ported yet; only 'ddp' on "
                "one device (ROADMAP.md, queue A, 'Parallelism')"
            )
        self.device = resolve_device(device)
        self.strategy = strategy
        self.accum_steps = accum_steps
        self._loss_fn = loss_fn
        self._init_fn = init_fn
        self._make_optimizer = optimizer or adamw(3e-4)
        self.model: Optional[nn.Module] = None
        self.optimizer: Optional[torch.optim.Optimizer] = None

    def init(self, seed: int = 0, model: Optional[nn.Module] = None):
        """Initialize (model, optimizer): ``init_fn(seed)``, or the given
        model moved to the trainer's device."""
        if model is None:
            model = self._init_fn(seed, self.device)
        self.model = model.to(self.device)
        self.optimizer = self._make_optimizer(self.model.parameters())
        return self.model, self.optimizer

    def train_step(self, batch) -> torch.Tensor:
        """One update on ``batch``, whose leaves have a leading microbatch
        axis of length ``accum_steps`` (see :meth:`microbatch`). Returns
        the mean loss, detached, without waiting for the device."""
        accum = self.accum_steps
        if accum == 1:
            loss = self._loss_fn(self.model, tuple(x[0] for x in batch))
            loss.backward()
            loss = loss.detach()
        else:
            params = [p for p in self.model.parameters() if p.requires_grad]
            sums = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            loss = torch.zeros((), device=self.device)
            for i in range(accum):
                micro = self._loss_fn(self.model, tuple(x[i] for x in batch))
                micro.backward()
                for acc, p in zip(sums, params):
                    if p.grad is not None:
                        acc.add_(p.grad.float())
                        p.grad = None
                loss += micro.detach()
            for acc, p in zip(sums, params):
                p.grad = (acc / accum).to(p.dtype)
            loss = loss / accum
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return loss

    def microbatch(self, batch):
        """[global_batch, ...] -> [accum, global_batch / accum, ...]."""
        a = self.accum_steps
        return tuple(
            x.reshape((a, x.shape[0] // a) + tuple(x.shape[1:]))
            for x in batch
        )

    def shard_batch(self, batch):
        """Numpy or torch microbatches onto the trainer's device."""
        return tuple(
            torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x
                            ).to(self.device)
            for x in batch
        )


def make_trainer_for_llama(
    cfg,
    device=None,
    strategy: str = "ddp",
    accum_steps: int = 1,
    optimizer: Optional[OptimizerFactory] = None,
    attn_fn=None,
) -> ShardedTrainer:
    """Trainer for the Llama model; ``device=None`` is the GPU."""
    from dlrover_tpu_torch.models import llama

    def loss(model, batch):
        return llama.next_token_loss(model, batch, attn_fn=attn_fn)

    def init(seed, dev):
        return llama.init_params(cfg, seed=seed, device=dev)

    trainer = ShardedTrainer(
        loss, init, device=device, strategy=strategy, optimizer=optimizer,
        accum_steps=accum_steps,
    )
    logger.info(
        "ShardedTrainer: %s params=%.1fM device=%s strategy=%s accum=%d",
        type(cfg).__name__, llama.param_count(cfg) / 1e6, trainer.device,
        strategy, accum_steps,
    )
    return trainer
