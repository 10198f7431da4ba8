"""BF16 parameters with fp32 master weights, and the non-finite guard.

Counterpart of ``dlrover_tpu/optim/bf16.py``, whose optax wrappers
become optimizer factories (``optim/optimizers.py``): each is called on
the parameters it steps and returns a plain object with ``step`` and
``zero_grad``, not a ``torch.optim.Optimizer`` (which would load
``torch._dynamo`` at its first construction). Their state is the JAX
state's tree (``state_tree``): ``MasterWeightsState(master,
inner_state)`` as ``{"master", "inner_state"}`` and
``NonfiniteGuardState`` as ``{"inner_state", "nonfinite_count",
"last_grad_norm"}``, so a sharded strategy saves the masters and the
moments as the ZeRO or fsdp boxes of the JAX leaves.

Exactness, as in JAX: the masters are stepped in fp32 and every
parameter is then written as ``round_bf16(master)``. The guard decides
on the device: the global gradient norm's ``isfinite`` selects, by
``torch.where``, between the stepped and the previous parameters,
masters and moments, with no host sync in the step; the skip count and
the norm stay on the device until :func:`guard_stats` reads them.
"""

import functools
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn as nn

from dlrover_tpu_torch.optim.optimizers import AdamW, Fp32GradAdamW
from dlrover_tpu_torch.optim.state import (
    init_adamw_state,
    load_optimizer_state,
    optimizer_state,
)

OptimizerFactory = Callable[[Iterable[nn.Parameter]], Any]


def _local_norm(grads: List[Optional[torch.Tensor]]) -> torch.Tensor:
    """``optax.global_norm`` of the gradients at hand, in fp32."""
    sq = [torch.linalg.vector_norm(g, dtype=torch.float32).square()
          for g in grads if g is not None]
    if not sq:
        return torch.zeros(())
    return torch.stack(sq).sum().sqrt()


def _step_tensors(opt) -> List[torch.Tensor]:
    """Every tensor a step of ``opt`` writes: its parameters and state."""
    if hasattr(opt, "tensors"):
        return opt.tensors()
    out = []
    for group in opt.param_groups:
        for p in group["params"]:
            out.append(p)
            out += [t for t in opt.state[p].values()
                    if isinstance(t, torch.Tensor)]
    return out


@torch.no_grad()
def _selected_step(opt, finite: torch.Tensor) -> None:
    """``opt.step()``, then every tensor it wrote set back where
    ``finite`` is false (state it created during the step: to zeros, the
    optax state's initial value). A tensor held off the flag's device (a
    ``torch.optim`` step counter on the host) takes a copy of the flag,
    which waits for the device."""
    old = [(t, t.clone()) for t in _step_tensors(opt)]
    opt.step()
    kept = {id(t) for t, _ in old}
    pairs = old + [(t, torch.zeros_like(t)) for t in _step_tensors(opt)
                   if id(t) not in kept]
    for t, prev in pairs:
        t.copy_(torch.where(finite.to(t.device), t, prev))


def _step(opt, finite: Optional[torch.Tensor]) -> None:
    """``opt``'s update; where the device flag ``finite`` is false, every
    tensor it writes keeps its bits. :class:`Fp32GradAdamW` and
    :class:`MasterWeights` take the flag into their step; any other
    optimizer is stepped and then set back (:func:`_selected_step`)."""
    if finite is None:
        opt.step()
    elif isinstance(opt, (Fp32GradAdamW, MasterWeights)):
        opt.step(finite=finite)
    else:
        _selected_step(opt, finite)


class MasterWeights:
    """``inner`` run against fp32 master copies of the parameters:
    gradients cast up to the masters' dtype, the inner update applied to
    the masters, and each parameter then written as its master rounded
    to the parameter's dtype."""

    def __init__(self, params: Iterable[nn.Parameter],
                 inner: OptimizerFactory,
                 master_dtype: torch.dtype = torch.float32):
        self.params = [p for p in params if p.requires_grad]
        self.master = [nn.Parameter(p.detach().to(master_dtype).clone())
                       for p in self.params]
        self.inner = inner(self.master)
        if isinstance(self.inner, torch.optim.AdamW):
            init_adamw_state(self.inner)

    def bind_grad_norm(self, fn: Callable) -> None:
        bind = getattr(self.inner, "bind_grad_norm", None)
        if bind is not None:
            bind(fn)

    @torch.no_grad()
    def step(self, finite: Optional[torch.Tensor] = None) -> None:
        """The inner update on the masters from the parameters' gradients
        cast up; where the device flag ``finite`` is false, the masters
        and the inner state keep their bits."""
        for p, m in zip(self.params, self.master):
            m.grad = None if p.grad is None else p.grad.to(m.dtype)
        _step(self.inner, finite)
        # a skipped step leaves the master, so round(master) is the
        # parameter's own bits
        for p, m in zip(self.params, self.master):
            m.grad = None
            p.copy_(m)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    def state_tree(self) -> Dict[str, Any]:
        return {"master": list(self.master),
                "inner_state": optimizer_state(self.inner)}

    @torch.no_grad()
    def load_state_tree(self, tree: Dict[str, Any]) -> None:
        for m, src in zip(self.master, tree["master"]):
            m.copy_(src)
        load_optimizer_state(self.inner, tree["inner_state"])


def master_weights(inner: OptimizerFactory,
                   master_dtype: torch.dtype = torch.float32
                   ) -> OptimizerFactory:
    """The factory of :class:`MasterWeights` around ``inner``."""
    return functools.partial(MasterWeights, inner=inner,
                             master_dtype=master_dtype)


class NonfiniteGuard:
    """``inner``'s update skipped whole when the global gradient norm is
    not finite: parameters and state keep their bits, the skip is
    counted and the norm kept, all on the device (a ``torch.where`` on
    the norm's ``isfinite``). The norm is of the gradients at hand, or of
    the global gradient through ``bind_grad_norm`` (a sharded strategy's
    trainer binds it, so every rank decides alike)."""

    def __init__(self, params: Iterable[nn.Parameter],
                 inner: OptimizerFactory):
        self.params = [p for p in params if p.requires_grad]
        self.inner = inner(self.params)
        if isinstance(self.inner, torch.optim.AdamW):
            init_adamw_state(self.inner)
        dev = self.params[0].device if self.params else None
        #: updates skipped so far, and the newest gradient norm
        self.nonfinite_count = torch.zeros((), dtype=torch.int32, device=dev)
        self.last_grad_norm = torch.zeros((), dtype=torch.float32,
                                          device=dev)
        self._grad_norm: Optional[Callable] = None

    def bind_grad_norm(self, fn: Callable) -> None:
        """``fn(grads) -> norm`` of the global gradient from the
        gradients of this optimizer's parameters."""
        self._grad_norm = fn

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params]
        norm = (self._grad_norm(grads) if self._grad_norm is not None
                else _local_norm(grads)).to(self.last_grad_norm.device)
        finite = torch.isfinite(norm)
        _step(self.inner, finite)
        self.nonfinite_count.add_((~finite).to(torch.int32))
        self.last_grad_norm.copy_(norm)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    def state_tree(self) -> Dict[str, Any]:
        return {"inner_state": optimizer_state(self.inner),
                "nonfinite_count": self.nonfinite_count,
                "last_grad_norm": self.last_grad_norm}

    @torch.no_grad()
    def load_state_tree(self, tree: Dict[str, Any]) -> None:
        load_optimizer_state(self.inner, tree["inner_state"])
        self.nonfinite_count.copy_(torch.as_tensor(tree["nonfinite_count"]))
        self.last_grad_norm.copy_(torch.as_tensor(tree["last_grad_norm"]))


def nonfinite_guard(inner: OptimizerFactory) -> OptimizerFactory:
    """The factory of :class:`NonfiniteGuard` around ``inner``: any of
    the port's factories, or one of a ``torch.optim`` optimizer."""
    return functools.partial(NonfiniteGuard, inner=inner)


def _find_guard(opt) -> Optional[NonfiniteGuard]:
    opt = getattr(opt, "optimizer", opt)  # a trainer: its optimizer
    while opt is not None and not isinstance(opt, NonfiniteGuard):
        opt = getattr(opt, "inner", None)
    return opt


def guard_stats(optimizer) -> Optional[Tuple[int, float]]:
    """Host-side read of the guard's counters: ``(skipped updates, last
    global gradient norm)`` of the :class:`NonfiniteGuard` that
    ``optimizer`` is or wraps (a trainer: its optimizer's), or None when
    there is none. Publishes newly observed skips to
    ``dlrover_optim_nonfinite_skips_total``. The norm is what a caller
    passes to ``ElasticTrainer.report_step(grad_norm=...)``."""
    guard = _find_guard(optimizer)
    if guard is None:
        return None
    skips = int(guard.nonfinite_count.item())
    norm = float(guard.last_grad_norm.item())
    _publish_skips(skips)
    return skips, norm


#: monotone watermark so the cumulative device count maps onto the
#: monotone process counter without double-counting repeated reads
_skips_published = 0
_skips_lock = threading.Lock()


def _publish_skips(total: int) -> None:
    global _skips_published
    from dlrover_tpu_torch.telemetry import counter

    with _skips_lock:
        delta = total - _skips_published
        if delta <= 0:
            return
        _skips_published = total
    counter(
        "dlrover_optim_nonfinite_skips_total",
        "Optimizer updates skipped for a non-finite global grad norm",
    ).inc(delta)


def bf16_adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.95,
               eps: float = 1e-8, weight_decay: float = 0.0,
               mu_dtype: Optional[torch.dtype] = torch.bfloat16,
               guard_nonfinite: bool = False) -> OptimizerFactory:
    """AdamW (:class:`Fp32GradAdamW`) over fp32 masters with a bf16 first
    moment: an fp32 master,
    a bf16 mu and an fp32 nu, 10 bytes of state per parameter.
    ``guard_nonfinite=True`` wraps it in :func:`nonfinite_guard` (its
    state tree is then the guard's)."""
    inner = functools.partial(
        Fp32GradAdamW, hp=AdamW(learning_rate, b1, b2, eps, weight_decay),
        mu_dtype=mu_dtype)
    opt = master_weights(inner)
    return nonfinite_guard(opt) if guard_nonfinite else opt
