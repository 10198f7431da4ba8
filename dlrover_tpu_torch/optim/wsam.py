"""Weighted Sharpness-Aware Minimization (WSAM), gradient-side.

Counterpart of ``dlrover_tpu/optim/wsam.py``: a ``ShardedTrainer(
value_and_grad=...)`` hook that evaluates the gradient twice, at the
parameters and at the adversarial point ``w + rho * g / ||g||`` (taken
in fp32, then cast back to each parameter's dtype), and returns

    grad = g + beta * (g_adv - g),   beta = gamma / (1 - gamma)

In a trainer the hook is bound to the trainer's loss (the rank's share
of the global batch's) and to the norm of the global gradient -- the
gradients summed over the data-parallel ranks -- so every rank moves to
the same adversarial point; the trainer then reduces the combined
gradient as its own. Both are linear in the ranks' gradients, so their
sum is the JAX gradient of the global batch.
"""

from typing import Callable, List, Optional, Tuple

import torch
import torch.nn as nn


def _local_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([
        torch.linalg.vector_norm(g, dtype=torch.float32).square()
        for g in grads]).sum().sqrt()


class WsamValueAndGrad:
    """``(model, batch) -> (loss, wsam gradients)``, one gradient per
    trained parameter (``requires_grad``, in ``model.parameters()``
    order). ``loss_fn(model, batch) -> scalar``; None takes the
    trainer's loss at :meth:`bind`."""

    def __init__(self, loss_fn: Optional[Callable], rho: float,
                 gamma: float, grad_norm: Optional[Callable] = None):
        self.loss_fn = loss_fn
        self.rho = rho
        self.gamma = gamma
        self.beta = gamma / (1.0 - gamma)
        self._grad_norm = grad_norm

    def bind(self, loss: Callable, grad_norm: Callable) -> "WsamValueAndGrad":
        """The hook inside a trainer: its loss where none was given, and
        the norm of its global gradient."""
        return WsamValueAndGrad(self.loss_fn or loss, self.rho, self.gamma,
                                grad_norm)

    def _grads(self, model: nn.Module, batch, params):
        loss = self.loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss, [g if g is not None else torch.zeros_like(p)
                      for g, p in zip(grads, params)]

    def __call__(self, model: nn.Module, batch
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        if self.loss_fn is None:
            raise ValueError("wsam_value_and_grad(None) takes its loss from "
                             "a ShardedTrainer; give a loss_fn to call it "
                             "alone")
        params = [p for p in model.parameters() if p.requires_grad]
        loss, g = self._grads(model, batch, params)
        norm = (self._grad_norm(g) if self._grad_norm is not None
                else _local_norm(g))
        scale = self.rho / (norm + 1e-12)
        held = [p.data for p in params]
        try:
            with torch.no_grad():
                for p, gi in zip(params, g):
                    p.data = (p.data.float() + scale * gi.float()).to(
                        p.dtype)
            _, g_adv = self._grads(model, batch, params)
        finally:
            for p, data in zip(params, held):
                p.data = data
        return loss.detach(), [a + (b - a) * self.beta
                               for a, b in zip(g, g_adv)]


def wsam_value_and_grad(loss_fn: Optional[Callable] = None,
                        rho: float = 0.05, gamma: float = 0.9
                        ) -> WsamValueAndGrad:
    """Wrap ``loss_fn(model, batch) -> scalar`` into ``(model, batch) ->
    (loss, wsam gradients)``: the drop-in for the step's autograd call
    (one extra forward and backward). In a ``ShardedTrainer`` leave
    ``loss_fn`` None to take the trainer's own loss."""
    return WsamValueAndGrad(loss_fn, rho, gamma)
