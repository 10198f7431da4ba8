"""The train step on one GPU: loss, backward, AdamW, in place.

Counterpart of ``dlrover_tpu/trainer/sharded.py``. The class keeps its
name so that readers find the counterpart, but the port runs only the
``"ddp"`` strategy on one device so far; the rule-table strategies
(ZeRO, FSDP, TP, sequence) are later work (ROADMAP.md, queue A,
"Parallelism"). Where the JAX step donates its buffers, this one updates
the parameters and optimizer state in place. Gradient accumulation sums
the microbatches' gradients in fp32 buffers and hands their fp32 mean to
AdamW, as the JAX step hands it to optax.
"""

from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch
import torch.nn as nn

from dlrover_tpu_torch.auto.device_context import resolve_device
from dlrover_tpu_torch.common.log import default_logger as logger

OptimizerFactory = Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]


@dataclass(frozen=True)
class AdamW:
    """``optax.adamw``'s hyperparameters; called on parameters, the
    ``torch.optim.AdamW`` that runs them (see :func:`adamw`)."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def __call__(self, params) -> torch.optim.AdamW:
        return torch.optim.AdamW(
            params, lr=self.learning_rate, betas=(self.b1, self.b2),
            eps=self.eps, weight_decay=self.weight_decay,
        )


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> AdamW:
    """``optax.adamw`` with its own defaults written out: eps 1e-8 and a
    weight decay of 1e-4 on every parameter, norms and embedding
    included (``torch.optim.AdamW`` would default to 1e-2)."""
    return AdamW(learning_rate, b1, b2, eps, weight_decay)


class Fp32GradAdamW:
    """``optax.adamw`` on fp32 gradients of parameters of any dtype, as
    the JAX step runs it on the fp32 mean of accumulated microbatch
    gradients: the moments are fp32 (optax's bf16 moments become fp32 at
    the first fp32 gradient), the update is computed in fp32 with the
    decay term ``weight_decay * p`` taken in the parameter's dtype, and
    ``p + update`` is rounded once to the parameter's dtype.
    ``torch.optim.AdamW`` cannot take these gradients: it needs them in
    the parameters' dtype."""

    def __init__(self, params: Iterable[nn.Parameter], hp: AdamW):
        self.params = list(params)
        self.hp = hp
        self.mu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        """One update from ``grads`` (fp32, one per parameter)."""
        hp = self.hp
        self.count += 1
        # mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(self.mu, hp.b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - hp.b1))
        torch._foreach_mul_(self.nu, hp.b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - hp.b2))
        mu_hat = torch._foreach_div(self.mu, 1 - hp.b1 ** self.count)
        nu_hat = torch._foreach_div(self.nu, 1 - hp.b2 ** self.count)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), hp.eps)
        update = torch._foreach_div(mu_hat, denom)
        decay = torch._foreach_mul(self.params, hp.weight_decay)
        torch._foreach_add_(update, [d.float() for d in decay])
        torch._foreach_mul_(update, -hp.learning_rate)
        for p, u in zip(self.params, update):
            p.copy_(p.float() + u)


class ShardedTrainer:
    """Owns the model and its optimizer; ``train_step`` runs one update.

    Args:
      loss_fn: ``loss_fn(model, batch) -> scalar``.
      init_fn: ``init_fn(seed, device) -> nn.Module``.
      device: where to train; ``None`` is the GPU.
      strategy: only ``"ddp"`` (one device).
      optimizer: a factory from parameters to an optimizer (default
        ``adamw(3e-4)``, the JAX trainer's default).
      accum_steps: microbatches per optimizer update. Above 1 the
        optimizer must be an :func:`adamw`, whose update then runs as
        :class:`Fp32GradAdamW` on the fp32 mean of the gradients.
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
        optimizer = optimizer or adamw(3e-4)
        if accum_steps > 1 and not isinstance(optimizer, AdamW):
            raise ValueError(
                "accum_steps > 1 takes an adamw(...) optimizer: the fp32 "
                "mean of the microbatch gradients goes to Fp32GradAdamW")
        self.device = resolve_device(device)
        self.strategy = strategy
        self.accum_steps = accum_steps
        self._loss_fn = loss_fn
        self._init_fn = init_fn
        self._make_optimizer = optimizer
        self.model: Optional[nn.Module] = None
        self.optimizer = None

    def init(self, seed: int = 0, model: Optional[nn.Module] = None):
        """Initialize (model, optimizer): ``init_fn(seed)``, or the given
        model moved to the trainer's device."""
        if model is None:
            model = self._init_fn(seed, self.device)
        self.model = model.to(self.device)
        if self.accum_steps == 1:
            self.optimizer = self._make_optimizer(self.model.parameters())
        else:
            self.optimizer = Fp32GradAdamW(self._trained(),
                                           self._make_optimizer)
        return self.model, self.optimizer

    def _trained(self) -> List[nn.Parameter]:
        return [p for p in self.model.parameters() if p.requires_grad]

    def train_step(self, batch) -> torch.Tensor:
        """One update on ``batch``, whose leaves have a leading microbatch
        axis of length ``accum_steps`` (see :meth:`microbatch`). Returns
        the mean loss, detached, without waiting for the device."""
        accum = self.accum_steps
        if accum == 1:
            loss = self._loss_fn(self.model, tuple(x[0] for x in batch))
            loss.backward()
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            return loss.detach()
        params = self._trained()
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
        self.optimizer.step([acc.div_(accum) for acc in sums])
        return loss / accum

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
