"""The train step on one GPU: loss, backward, the optimizer, in place.

Counterpart of ``dlrover_tpu/trainer/sharded.py``. The class keeps its
name so that readers find the counterpart, but the port runs on one
device only: ``"ddp"``, and ``"rowwise"``, which on one device is the
same step (the JAX rule table shards a table's rows over an ``fsdp``
axis of size 1 there). The other rule-table strategies (ZeRO, FSDP, TP,
sequence) and a sharded table are later work (ROADMAP.md, queue A,
"Parallelism"). Where the JAX step donates its buffers, this one updates
the parameters and optimizer state in place. Three of optax's optimizers
are carried: ``adamw``, ``adam`` (AdamW without decay) and ``adagrad``.
Gradient accumulation sums the microbatches' gradients in fp32 buffers
and hands their fp32 mean to AdamW, as the JAX step hands it to optax.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from dlrover_tpu_torch.auto.device_context import resolve_device
from dlrover_tpu_torch.common.log import default_logger as logger

#: the strategies of one device; "rowwise" equals "ddp" there
STRATEGIES = ("ddp", "rowwise")

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
    construction, seconds of every worker's start."""

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
        if not live:
            return
        params = [p for p, _ in live]
        acc = [a for _, a in live]
        grads = [p.grad for p in params]
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


def _init_adamw_state(opt: torch.optim.AdamW) -> None:
    """Create AdamW's per-parameter state now, as its first step would
    (zero moments in the parameter's dtype, a step count of 0), so the
    state exists -- and a checkpoint of it has one layout -- from the
    start."""
    for group in opt.param_groups:
        for p in group["params"]:
            if p.requires_grad and not opt.state[p]:
                opt.state[p] = {
                    "step": torch.zeros((), dtype=torch.float32),
                    "exp_avg": torch.zeros_like(
                        p, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(
                        p, memory_format=torch.preserve_format),
                }


class ShardedTrainer:
    """Owns the model and its optimizer; ``train_step`` runs one update.

    Args:
      loss_fn: ``loss_fn(model, batch) -> scalar``.
      init_fn: ``init_fn(seed, device) -> nn.Module``.
      device: where to train; ``None`` is the GPU.
      strategy: ``"ddp"`` or ``"rowwise"`` (the same on one device).
      optimizer: a factory from parameters to an optimizer (default
        ``adamw(3e-4)``, the JAX trainer's default); :meth:`train_state`
        carries :func:`adamw`, :func:`adam` and :func:`adagrad`.
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
        if strategy not in STRATEGIES:
            raise NotImplementedError(
                f"strategy {strategy!r} is not ported yet; only {STRATEGIES}"
                " on one device (ROADMAP.md, queue A, 'Parallelism')"
            )
        if (strategy == "rowwise" and torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise NotImplementedError(
                "strategy 'rowwise' over more than one device shards the "
                "table rows, which is not ported yet (ROADMAP.md, queue A, "
                "item 6, 'Parallelism')")
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
        #: called right before the optimizer's in-place writes of each
        #: step (the elastic loop orders them after a checkpoint's
        #: device-to-host copies here)
        self.before_update: Optional[Callable[[], None]] = None

    def init(self, seed: int = 0, model: Optional[nn.Module] = None):
        """Initialize (model, optimizer): ``init_fn(seed)``, or the given
        model moved to the trainer's device."""
        if model is None:
            model = self._init_fn(seed, self.device)
        self.model = model.to(self.device)
        if self.accum_steps == 1:
            self.optimizer = self._make_optimizer(self.model.parameters())
            if isinstance(self.optimizer, torch.optim.AdamW):
                _init_adamw_state(self.optimizer)
        else:
            self.optimizer = Fp32GradAdamW(self._trained(),
                                           self._make_optimizer)
        return self.model, self.optimizer

    def _trained(self) -> List[nn.Parameter]:
        return [p for p in self.model.parameters() if p.requires_grad]

    def _named_trained(self) -> List[Tuple[str, nn.Parameter]]:
        return [(n, p) for n, p in self.model.named_parameters()
                if p.requires_grad]

    def _moments(self):
        """(mu, nu, count): the optimizer's moments as lists in parameter
        order, and its update count -- optax's ``ScaleByAdamState``."""
        opt = self.optimizer
        if isinstance(opt, Fp32GradAdamW):
            return opt.mu, opt.nu, opt.count
        if not isinstance(opt, torch.optim.AdamW):
            raise TypeError(
                f"train state of a {type(opt).__name__}: only AdamW "
                "(torch.optim.AdamW or Fp32GradAdamW) and RssAdagrad are "
                "carried")
        states = [opt.state[p] for p in self._trained()]
        count = int(states[0]["step"]) if states else 0
        return ([s["exp_avg"] for s in states],
                [s["exp_avg_sq"] for s in states], count)

    def train_state(self) -> Dict[str, Any]:
        """The live training state, without copies: ``{"model": {name:
        parameter}, "optimizer": ...}``, the layout a checkpoint saves.
        The optimizer's part is optax's state by parameter name:
        ``{"mu": {name: moment}, "nu": {name: moment}, "count": updates}``
        for AdamW and Adam, ``{"sum_of_squares": {name: accumulator}}``
        for Adagrad."""
        named = self._named_trained()
        names = [n for n, _ in named]
        if isinstance(self.optimizer, RssAdagrad):
            opt = {"sum_of_squares": dict(
                zip(names, self.optimizer.sum_of_squares))}
        else:
            mu, nu, count = self._moments()
            opt = {"mu": dict(zip(names, mu)), "nu": dict(zip(names, nu)),
                   "count": count}
        return {"model": {n: p.detach() for n, p in named},
                "optimizer": opt}

    @torch.no_grad()
    def load_train_state(self, state: Dict[str, Any]) -> None:
        """Copy a :meth:`train_state` tree (from a checkpoint) into the
        live parameters and optimizer, in place. The moments' dtype picks
        the optimizer as optax's state would: moments in the parameters'
        dtype keep ``torch.optim.AdamW`` at one microbatch, fp32 moments
        of lower-precision parameters mean :class:`Fp32GradAdamW`."""
        named = self._named_trained()
        if set(state["model"]) != {n for n, _ in named}:
            raise ValueError("checkpoint parameters differ from the model's")
        for n, p in named:
            p.copy_(state["model"][n])
        opt = state["optimizer"]
        if "sum_of_squares" in opt:
            if not isinstance(self.optimizer, RssAdagrad):
                raise ValueError(
                    "an Adagrad state for a trainer whose optimizer is a "
                    f"{type(self.optimizer).__name__}")
            for (n, _), acc in zip(named, self.optimizer.sum_of_squares):
                acc.copy_(opt["sum_of_squares"][n])
            return
        mu = [opt["mu"][n] for n, _ in named]
        nu = [opt["nu"][n] for n, _ in named]
        self._set_optimizer(mu, nu, int(opt["count"]))

    def set_accum_steps(self, accum_steps: int) -> None:
        """Change the microbatches per update, carrying the moments and
        the update count across. Going above one microbatch moves the
        moments to fp32 (optax's bf16 moments become fp32 at the first
        fp32 gradient); they stay fp32 from then on, as optax's do."""
        if accum_steps == self.accum_steps:
            return
        if accum_steps > 1 and not isinstance(self._make_optimizer, AdamW):
            raise ValueError(
                "accum_steps > 1 takes an adamw(...) optimizer: the fp32 "
                "mean of the microbatch gradients goes to Fp32GradAdamW")
        self.accum_steps = accum_steps
        if self.model is not None:
            self._set_optimizer(*self._moments())

    def _set_optimizer(self, mu, nu, count: int) -> None:
        params = self._trained()
        fp32 = self.accum_steps > 1 or any(
            m.dtype != p.dtype for m, p in zip(mu, params))
        if fp32:
            opt = Fp32GradAdamW(params, self._make_optimizer)
            for dst, src in zip(opt.mu + opt.nu, list(mu) + list(nu)):
                dst.copy_(src)
            opt.count = count
        else:
            opt = self._make_optimizer(self.model.parameters())
            _init_adamw_state(opt)
            for p, m, v in zip(params, mu, nu):
                st = opt.state[p]
                st["exp_avg"].copy_(m)
                st["exp_avg_sq"].copy_(v)
                st["step"].fill_(count)
        self.optimizer = opt

    def train_step(self, batch) -> torch.Tensor:
        """One update on ``batch``, whose leaves have a leading microbatch
        axis of length ``accum_steps`` (see :meth:`microbatch`). Returns
        the mean loss, detached, without waiting for the device."""
        accum = self.accum_steps
        if not isinstance(self.optimizer, Fp32GradAdamW):
            loss = self._loss_fn(self.model, tuple(x[0] for x in batch))
            loss.backward()
            if self.before_update is not None:
                self.before_update()
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
        if self.before_update is not None:
            self.before_update()
        self.optimizer.step([acc.div_(accum) for acc in sums])
        return loss / accum

    def forward_backward(self, batch) -> None:
        """The step's forward and backward on ``batch`` (the layout of
        :meth:`train_step`) without its update: the gradients come from
        ``torch.autograd.grad`` and are dropped, so neither ``.grad``
        nor the optimizer is touched (the step profile,
        trainer/profiler.py)."""
        params = self._trained()
        for i in range(self.accum_steps):
            loss = self._loss_fn(self.model, tuple(x[i] for x in batch))
            torch.autograd.grad(loss, params, allow_unused=True)

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


def family_trainer(cfg, loss_fn: Callable, init_fn: Callable,
                   param_count: int, device=None, strategy: str = "ddp",
                   accum_steps: int = 1,
                   optimizer: Optional[OptimizerFactory] = None
                   ) -> ShardedTrainer:
    """A family's trainer (each family's ``make_trainer``), logged with
    its config and size."""
    trainer = ShardedTrainer(
        loss_fn, init_fn, device=device, strategy=strategy,
        optimizer=optimizer, accum_steps=accum_steps,
    )
    logger.info(
        "ShardedTrainer: %s params=%.1fM device=%s strategy=%s accum=%d",
        type(cfg).__name__, param_count / 1e6, trainer.device, strategy,
        accum_steps,
    )
    return trainer


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

    return family_trainer(cfg, loss, init, llama.param_count(cfg),
                          device=device, strategy=strategy,
                          accum_steps=accum_steps, optimizer=optimizer)
