"""optax's optimizers as the port's optimizer factories.

A factory is called on the parameters its optimizer steps. ``adamw`` and
``adam`` give ``torch.optim.AdamW``; ``adagrad`` gives
:class:`RssAdagrad`, optax's formula; :class:`Fp32GradAdamW` is optax's
AdamW on fp32 gradients, which gradient accumulation
(``trainer/sharded.py``) and the fp32 masters of ``optim/bf16.py`` step.
An optimizer's state as optax's tree is ``optim/state.py``'s.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
import torch.nn as nn

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


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> AdamW:
    """``optax.adam``: :func:`adamw` without weight decay (optax's adamw
    is adam plus the decay term), so its state and checkpoint layout are
    AdamW's."""
    return AdamW(learning_rate, b1, b2, eps, weight_decay=0.0)


@dataclass(frozen=True)
class Adagrad:
    """``optax.adagrad``'s hyperparameters; called on parameters, the
    :class:`RssAdagrad` that runs them. Made by :func:`adagrad`, which
    holds optax's defaults."""

    learning_rate: float
    initial_accumulator_value: float
    eps: float

    def __call__(self, params) -> "RssAdagrad":
        return RssAdagrad(params, self)


def adagrad(learning_rate: float, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> Adagrad:
    """``optax.adagrad`` with its own defaults. ``torch.optim.Adagrad``
    is another optimizer: its accumulator starts at 0, its eps is added
    after the square root, and it decays the learning rate."""
    return Adagrad(learning_rate, initial_accumulator_value, eps)


class RssAdagrad:
    """``optax.adagrad`` to optax's formula (``scale_by_rss``, then the
    learning rate): ``acc += g * g``, then ``p -= lr * g * rsqrt(acc +
    eps)`` where ``acc > 0`` (else no step). The accumulators
    (``sum_of_squares``, in parameter order) start at
    ``initial_accumulator_value`` in each parameter's dtype, as optax's
    do. A plain object with ``step`` and ``zero_grad``: a
    ``torch.optim.Optimizer`` would load ``torch._dynamo`` at its first
    construction, seconds of every worker's start. A table of more than
    ``CHUNK_ROWS`` rows is updated a block of rows at a time, so its step
    needs one block of scratch, not a table's; the other parameters take
    one ``_foreach`` pass."""

    CHUNK_ROWS = 1 << 20

    def __init__(self, params: Iterable[nn.Parameter], hp: Adagrad):
        self.params = [p for p in params if p.requires_grad]
        self.hp = hp
        self.sum_of_squares = [
            torch.full_like(p, hp.initial_accumulator_value)
            for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad`` (those without one
        are left alone)."""
        live = [(p, a) for p, a in zip(self.params, self.sum_of_squares)
                if p.grad is not None]
        whole = [(p, a) for p, a in live
                 if p.dim() == 0 or p.shape[0] <= self.CHUNK_ROWS]
        if whole:
            self._update([p for p, _ in whole], [a for _, a in whole],
                         [p.grad for p, _ in whole])
        for p, acc in live:
            if p.dim() and p.shape[0] > self.CHUNK_ROWS:
                for i in range(0, p.shape[0], self.CHUNK_ROWS):
                    part = slice(i, i + self.CHUNK_ROWS)
                    self._update([p[part]], [acc[part]], [p.grad[part]])

    def _update(self, params, acc, grads) -> None:
        torch._foreach_add_(acc, torch._foreach_mul(grads, grads))
        scale = torch._foreach_add(acc, self.hp.eps)
        torch._foreach_rsqrt_(scale)
        for s, a in zip(scale, acc):
            s.masked_fill_(a <= 0, 0.0)
        torch._foreach_mul_(scale, grads)
        torch._foreach_add_(params, scale, alpha=-self.hp.learning_rate)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def state_tree(self) -> Dict[str, Any]:
        return {"sum_of_squares": list(self.sum_of_squares)}

    @torch.no_grad()
    def load_state_tree(self, tree: Dict[str, Any]) -> None:
        for acc, src in zip(self.sum_of_squares, tree["sum_of_squares"]):
            acc.copy_(src)

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor a step writes: the parameters and the state."""
        return self.params + self.sum_of_squares


class Fp32GradAdamW:
    """``optax.adamw(..., mu_dtype=...)`` on fp32 gradients of parameters
    of any dtype, as the JAX step runs it on the fp32 mean of accumulated
    microbatch gradients, and as ``optim/bf16.py`` runs it on fp32
    masters. The moments are updated in fp32 (optax's bf16 moments
    become fp32 at the first fp32 gradient); the first is stored in
    ``mu_dtype`` (default fp32), and ``b1 * mu`` takes ``b1`` as that
    dtype holds it (JAX's weak-typed scalar: 0.8984375 for bf16), the
    product in fp32, as XLA's CPU compile keeps it. The bias corrections
    come from the update count, a device tensor, in fp32; the decay term
    ``weight_decay * p`` is taken in the parameter's dtype, and ``p +
    update`` is rounded once to the parameter's dtype.
    ``torch.optim.AdamW`` cannot take these gradients: it needs them in
    the parameters' dtype. A plain object with ``step`` and
    ``zero_grad``, as :class:`RssAdagrad` is. The update runs in
    ``_foreach`` passes over blocks of parameters of about ``BLOCK``
    elements, so its fp32 scratch is a few blocks, not a few models."""

    BLOCK = 1 << 26

    def __init__(self, params: Iterable[nn.Parameter], hp: AdamW,
                 mu_dtype: Optional[torch.dtype] = None):
        self.params = list(params)
        self.hp = hp
        self.mu_dtype = mu_dtype or torch.float32
        self.mu = [torch.zeros_like(p, dtype=self.mu_dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]
        dev = self.params[0].device if self.params else None
        self.count = torch.zeros((), dtype=torch.int32, device=dev)

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None,
             finite: Optional[torch.Tensor] = None) -> None:
        """One update from ``grads`` (fp32, one per parameter), or from
        the parameters' ``.grad`` (those without one are left alone).
        Where ``finite``, a device flag, is false, the parameters, the
        moments and the count keep their bits (``torch.where``, no host
        sync)."""
        if grads is None:
            live = [i for i, p in enumerate(self.params)
                    if p.grad is not None]
            grads = [self.params[i].grad.float() for i in live]
        else:
            live = range(len(self.params))
        count = self.count + 1
        c = count.float()
        bc = (1 - torch.full_like(c, self.hp.b1).pow(c),
              1 - torch.full_like(c, self.hp.b2).pow(c))
        block, size = [], 0
        for i, g in zip(live, grads):
            block.append((i, g))
            size += g.numel()
            if size >= self.BLOCK:
                self._update(block, bc, finite)
                block, size = [], 0
        if block:
            self._update(block, bc, finite)
        self.count = (count if finite is None
                      else torch.where(finite, count, self.count))

    def _update(self, block, bc, finite) -> None:
        """The update of the parameters ``block`` names, ``[(index,
        gradient)]``, in ``_foreach`` passes."""
        hp = self.hp
        grads = [g for _, g in block]
        params = [self.params[i] for i, _ in block]
        mu = [self.mu[i] for i, _ in block]
        nu = [self.nu[i] for i, _ in block]
        # mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu
        b1 = float(torch.tensor(hp.b1, dtype=self.mu_dtype))
        mu_new = torch._foreach_mul([m.float() for m in mu], b1)
        torch._foreach_add_(mu_new, torch._foreach_mul(grads, 1 - hp.b1))
        nu_new = torch._foreach_mul(nu, hp.b2)
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - hp.b2)
        torch._foreach_add_(nu_new, g2)
        del g2
        update = torch._foreach_div(mu_new, bc[0])
        denom = torch._foreach_div(nu_new, bc[1])
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, hp.eps)
        torch._foreach_div_(update, denom)
        del denom
        decay = torch._foreach_mul(params, hp.weight_decay)
        torch._foreach_add_(update, [d.float() for d in decay])
        del decay
        torch._foreach_mul_(update, -hp.learning_rate)
        torch._foreach_add_(update, [p.float() for p in params])
        new = [u.to(p.dtype) for p, u in zip(params, update)]
        del update
        old = params + mu + nu
        new += list(mu_new) + list(nu_new)
        if finite is None:
            torch._foreach_copy_(old, new)
        else:
            for t, n in zip(old, new):
                t.copy_(torch.where(finite, n, t))

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    def state_tree(self) -> Dict[str, Any]:
        return {"mu": list(self.mu), "nu": list(self.nu),
                "count": self.count}

    @torch.no_grad()
    def load_state_tree(self, tree: Dict[str, Any]) -> None:
        for dst, src in zip(self.mu + self.nu,
                            list(tree["mu"]) + list(tree["nu"])):
            dst.copy_(src)
        self.count = torch.as_tensor(tree["count"], dtype=torch.int32).to(
            self.count.device).clone()
