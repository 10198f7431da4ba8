"""The train step: loss, backward, the optimizer, in place.

Counterpart of ``dlrover_tpu/trainer/sharded.py``. The class keeps its
name so that readers find the counterpart. A trainer runs one strategy
of the rule tables (``parallel/sharding.py``) on a mesh
(``parallel/mesh.py``; by default JAX's ``[(data, 1), (fsdp, world)]``).
The batch is split over the data-parallel ranks (``batch_axes``: data
and fsdp): each of them steps on its own rows, and the ranks of one
``tensor`` group see the same rows. The JAX loss is the masked mean
over the global batch, so a loss function returns its masked sum and
the count it averages over, and each rank divides its sum by the count
summed over the data-parallel ranks; their quotients sum to the JAX
loss.

* ``"ddp"``: parameters and optimizer state replicated; between
  ``backward`` and the update the gradients and losses are summed over
  the data-parallel ranks (one ``all_reduce`` per dtype bucket), where
  XLA sums them (psum) in the JAX step. ``"rowwise"`` is the same step
  on one rank; its sharded table above one rank is later work (ROADMAP
  queue A).
* ``"zero1"``: parameters and gradients replicated, the AdamW moments
  sharded under the ZeRO rules (``opt_state_rules``). The gradients are
  reduce-scattered to the rank's slice, AdamW runs on that slice of the
  parameters, and the updated slices are all-gathered: what the JAX
  docstring says XLA does. ``"zero2"`` is zero1 with the fp32
  accumulation buffers of gradient accumulation held sharded too
  (``grad_rules``): each microbatch's gradients are reduce-scattered.
* ``"fsdp"``: each parameter held as the rank's shard under
  ``fsdp_rules`` (on the dimension the table picks: the port's dim 1 of
  ``wq``, its ``embed``; norms replicated). The shards are all-gathered
  into whole parameters before the forward, the gradients
  reduce-scattered back to the shards, the gathered copies dropped after
  the backward; AdamW steps the shards.
* ``"tp"``: the Megatron layout over ``tensor`` (``models/llama.py``):
  each rank holds and steps its column/row/vocab shard, and the model
  runs the collectives of ``parallel/tensor_parallel.py``.
* ``"tp_fsdp"``: ``tensor`` shards as under tp, and ``fsdp`` shards the
  ``embed`` dims of those shards, gathered before use as under fsdp.

"sequence" and "pipeline" raise (ROADMAP queue A.1.3 and A.1.4). Every
collective goes through ``trainer/distributed.py``'s layer, on the
mesh's groups. The strategies other than ddp and rowwise need the
model's logical axes (``make_trainer_for_llama`` gives them), and their
:meth:`ShardedTrainer.train_state` is the JAX parameter tree
(``models/llama.py``'s ``jax_coordinates``: stacked layers, ``[in,
out]`` matrices) whose leaves are ``ckpt_store.ShardedLeaf``: the boxes
this rank holds, and the global map of every rank's boxes, which the
flash checkpoint writes as the leaf's domains.
Where the JAX step donates its buffers, this one updates
the parameters and optimizer state in place. Three of optax's optimizers
are carried: ``adamw``, ``adam`` (AdamW without decay) and ``adagrad``.
Gradient accumulation sums the microbatches' gradients in fp32 buffers
and hands their fp32 mean to AdamW, as the JAX step hands it to optax.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from dlrover_tpu_torch.auto.device_context import resolve_device
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.parallel import mesh as mesh_lib
from dlrover_tpu_torch.parallel import sharding as shd
from dlrover_tpu_torch.trainer import distributed as coll

#: the strategies a trainer runs ("rowwise" equals "ddp" on one device,
#: and raises above one rank)
STRATEGIES = ("ddp", "rowwise", "zero1", "zero2", "fsdp", "tp", "tp_fsdp")
#: the strategies that shard a parameter or its optimizer state
SHARDED = ("zero1", "zero2", "fsdp", "tp", "tp_fsdp")


def allreduce_sum_(tensors: List[torch.Tensor], group) -> None:
    """Sum ``tensors`` over the ranks of ``group`` in place: one
    ``all_reduce`` per dtype on a flattened bucket, so every rank ends
    with the same bits."""
    if not tensors:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype in sorted(by_dtype, key=str):
        bucket = by_dtype[dtype]
        flat = _flatten_dense_tensors(bucket)
        coll.all_reduce_(flat, group)
        for t, r in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            t.copy_(r)


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


@dataclass
class _Layout:
    """How a strategy holds one parameter (port order of dims): ``store``,
    what the rank keeps between steps; ``opt``, the box its optimizer
    steps; ``gather``, the (dim, axis) pairs along which the stored
    shard is all-gathered into the parameter the forward uses (fsdp);
    ``scatter``, those along which the gradient is reduce-scattered to
    the optimizer's box; ``reduce_axes``, the data-parallel axes it is
    all-reduced over besides."""

    name: str
    shape: Tuple[int, ...]
    store: shd.Spec
    opt: shd.Spec
    gather: List[Tuple[int, str]]
    scatter: List[Tuple[int, str]]
    reduce_axes: Tuple[str, ...]


def _non_tensor(spec: shd.Spec) -> List[Tuple[int, str]]:
    out = []
    for d, entry in enumerate(spec):
        axes = [a for a in shd.spec_axes(entry) if a != mesh_lib.TENSOR_AXIS]
        if len(shd.spec_axes(entry)) > 1:
            raise NotImplementedError(
                f"a parameter dim sharded over {shd.spec_axes(entry)}: one "
                "mesh axis per parameter dim is carried")
        out += [(d, a) for a in axes]
    return out


def _tensor_part(spec: shd.Spec) -> shd.Spec:
    return tuple(e if mesh_lib.TENSOR_AXIS in shd.spec_axes(e) else None
                 for e in spec)


def _box(t: torch.Tensor, box) -> torch.Tensor:
    return t[tuple(slice(a, b) for a, b in box)]


class ShardedTrainer:
    """Owns the model and its optimizer; ``train_step`` runs one update.

    Args:
      loss_fn: ``loss_fn(model, batch) -> (sum, count)``: the masked
        loss summed over the batch, and the count of unmasked targets it
        is a mean over (``next_token_sums`` of the LMs, ``loss_sums`` of
        the CNN and DLRM); the step's loss is their quotient, over the
        global batch above one rank.
      init_fn: ``init_fn(seed, device) -> nn.Module``.
      device: where to train; ``None`` is the GPU.
      strategy: one of :data:`STRATEGIES` (see the module docstring);
        "sequence" and "pipeline" raise ``NotImplementedError``.
      optimizer: a factory from parameters to an optimizer (default
        ``adamw(3e-4)``, the JAX trainer's default); :meth:`train_state`
        carries :func:`adamw`, :func:`adam` and :func:`adagrad` (the
        sharded strategies: the first two).
      accum_steps: microbatches per optimizer update. Above 1 the
        optimizer must be an :func:`adamw`, whose update then runs as
        :class:`Fp32GradAdamW` on the fp32 mean of the gradients.
      mesh: the ranks' mesh (``parallel/mesh.py``); ``None`` builds the
        JAX default, ``[(data, 1), (fsdp, world)]``.
      param_axes: ``param_axes(model) -> {name: logical axes}`` and
      jax_coordinates: ``jax_coordinates(name) -> models.llama.JaxLeaf``,
        which the sharded strategies need (the model's layout).
    """

    def __init__(
        self,
        loss_fn: Callable,
        init_fn: Callable,
        device=None,
        strategy: str = "ddp",
        optimizer: Optional[OptimizerFactory] = None,
        accum_steps: int = 1,
        mesh=None,
        param_axes: Optional[Callable] = None,
        jax_coordinates: Optional[Callable] = None,
    ):
        if strategy in shd.NOT_PORTED:
            raise NotImplementedError(
                f"strategy {strategy!r} is not ported yet: ROADMAP.md "
                f"queue {shd.NOT_PORTED[strategy]}")
        if strategy not in STRATEGIES:
            raise ValueError(f"Unknown strategy {strategy!r}; one of "
                             f"{sorted(STRATEGIES)}")
        if (strategy == "rowwise" and torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise NotImplementedError(
                "strategy 'rowwise' over more than one device shards the "
                "table rows, which is not ported yet (ROADMAP.md, queue A, "
                "item 1.1: a sharded vocab_parallel_lookup with dlrm_large)")
        if strategy in SHARDED and (param_axes is None
                                    or jax_coordinates is None):
            raise NotImplementedError(
                f"strategy {strategy!r} needs the model's logical axes, "
                "which only make_trainer_for_llama gives: the other "
                "families on a mesh are not ported yet (ROADMAP.md, queue "
                "A, item 1.1)")
        optimizer = optimizer or adamw(3e-4)
        if strategy in SHARDED and not isinstance(optimizer, AdamW):
            raise ValueError(f"strategy {strategy!r} carries adamw/adam")
        #: seconds the newest step spent in collectives, the device
        #: synchronized on both sides (0 at one rank): ddp's reduction,
        #: or every collective of a sharded strategy's step
        self.reduce_seconds = 0.0
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
        self._param_axes = param_axes
        self._jax_coordinates = jax_coordinates
        if mesh is None:
            mesh = mesh_lib.create_mesh(
                [(mesh_lib.DATA_AXIS, 1), (mesh_lib.FSDP_AXIS, -1)],
                device=self.device)
        self.mesh = mesh
        self.rules = shd.get_rules(strategy)
        #: the data-parallel axes (of size > 1) and their group: the
        #: batch is split, and the loss, its count and the gradients
        #: summed, over these ranks only
        self.batch_axes = tuple(a for a in mesh_lib.batch_axes(mesh)
                                if mesh_lib.axis_size(mesh, a) > 1)
        self._dp_group = mesh_lib.axes_group(mesh, self.batch_axes)
        self._tp_group = mesh_lib.axes_group(mesh, (mesh_lib.TENSOR_AXIS,))
        self.model: Optional[nn.Module] = None
        self.optimizer = None
        self._layouts: List[_Layout] = []
        #: per trained parameter: the tensor the rank keeps (the
        #: parameter itself, or its fsdp shard) and the one its
        #: optimizer steps (the kept one, or its ZeRO slice)
        self._stored: List[torch.Tensor] = []
        self._opt_params: List[torch.Tensor] = []
        #: called right before the optimizer's in-place writes of each
        #: step (the elastic loop orders them after a checkpoint's
        #: device-to-host copies here)
        self.before_update: Optional[Callable[[], None]] = None

    @property
    def sharded(self) -> bool:
        return self.strategy in SHARDED

    def data_parallel_index(self) -> int:
        """This rank's index among the data-parallel ranks (data major,
        fsdp minor): which part of the global batch it steps on."""
        idx = 0
        for a in self.batch_axes:
            idx = (idx * mesh_lib.axis_size(self.mesh, a)
                   + mesh_lib.axis_index(self.mesh, a))
        return idx

    def split_batch(self, batch):
        """This rank's rows of a global batch (leaves [global, ...]):
        the data-parallel ranks split it, a tensor group shares a part."""
        dp = mesh_lib.data_parallel_size(self.mesh)
        i = self.data_parallel_index()
        return tuple(x[i * (x.shape[0] // dp):(i + 1) * (x.shape[0] // dp)]
                     for x in batch)

    def init(self, seed: int = 0, model: Optional[nn.Module] = None):
        """Initialize (model, optimizer): ``init_fn(seed)``, or the given
        model moved to the trainer's device; a sharded strategy then
        keeps only this rank's shards of it."""
        if model is None:
            model = self._init_fn(seed, self.device)
        self.model = model.to(self.device)
        if self.sharded:
            self._shard_model()
        else:
            self._stored = self._opt_params = self._trained()
        if self.accum_steps == 1:
            self.optimizer = self._make_optimizer(self._opt_params)
            if isinstance(self.optimizer, torch.optim.AdamW):
                _init_adamw_state(self.optimizer)
        else:
            self.optimizer = Fp32GradAdamW(self._opt_params,
                                           self._make_optimizer)
        return self.model, self.optimizer

    # ------------------------------------------------------------ layouts

    def _layout(self, name: str, shape, logical) -> _Layout:
        mesh = self.mesh
        # the first logical axis in the JAX leaf's order wins a mesh axis
        order = self._jax_coordinates(name).dims
        store = shd.spec_in_order(logical, order, self.rules, mesh)
        opt_rules = shd.opt_state_rules(self.strategy)
        opt = (shd.spec_in_order(logical, order, opt_rules, mesh)
               if opt_rules is not None else store)
        if _tensor_part(opt) != _tensor_part(store):
            raise NotImplementedError(f"{name}: optimizer state sharded "
                                      "over tensor unlike the parameter")
        scatter = _non_tensor(opt)
        if any(a not in self.batch_axes for _, a in scatter):
            raise NotImplementedError(
                f"{name}: {scatter} shards over a non-data-parallel axis")
        return _Layout(
            name, tuple(shape), store, opt, _non_tensor(store), scatter,
            tuple(a for a in self.batch_axes
                  if a not in {a for _, a in scatter}))

    @torch.no_grad()
    def _shard_model(self) -> None:
        """Cut the whole model every rank built down to this rank's
        shards: the tensor-parallel shard as the parameter the forward
        uses, the fsdp shard kept apart (the parameter emptied until a
        step gathers it), the ZeRO slice as the optimizer's own."""
        axes = self._param_axes(self.model)
        self._layouts, self._stored, self._opt_params = [], [], []
        tensor_box = {}
        for name, p in self._named_trained():
            lay = self._layout(name, p.shape, axes[name])
            whole = p.detach()
            mesh = self.mesh
            tensor_box[name] = shd.local_slices(
                _tensor_part(lay.store), whole.shape, mesh)
            p.data = _box(whole, tensor_box[name]).clone()
            stored = p
            if lay.gather:
                stored = nn.Parameter(_box(whole, shd.local_slices(
                    lay.store, whole.shape, mesh)).clone())
                p.data = p.data.new_empty(0)
            opt_param = stored
            if lay.opt != lay.store:
                opt_param = nn.Parameter(_box(whole, shd.local_slices(
                    lay.opt, whole.shape, mesh)).clone())
            self._layouts.append(lay)
            self._stored.append(stored)
            self._opt_params.append(opt_param)
        if self._tp_group is not None:
            self.model.tp_group = self._tp_group
            self.model.vocab_start = tensor_box["embed"][0][0]
            for module in self.model.modules():
                if hasattr(module, "tp_group"):
                    module.tp_group = self._tp_group

    def _gather_params(self) -> None:
        """fsdp: the parameters the forward uses, from the ranks' shards."""
        for (_, p), lay, stored in zip(self._named_trained(), self._layouts,
                                       self._stored):
            if lay.gather:
                whole = stored.detach()
                for d, a in lay.gather:
                    whole = coll.all_gather(
                        whole, d, mesh_lib.axes_group(self.mesh, (a,)))
                p.data = whole

    def _release_params(self) -> None:
        for (_, p), lay in zip(self._named_trained(), self._layouts):
            p.grad = None
            if lay.gather:
                p.data = p.data.new_empty(0)

    def _reduce_to_opt(self, grads: List[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """Whole (or tensor-parallel) gradients of this rank's rows ->
        the optimizer's boxes of their sum over the data-parallel ranks:
        reduce-scattered along the sharded dims, all-reduced over the
        data-parallel axes that do not shard it (one bucket per group
        and dtype)."""
        out, buckets = [], {}
        for lay, g in zip(self._layouts, grads):
            for d, a in lay.scatter:
                g = coll.reduce_scatter(
                    g, d, mesh_lib.axes_group(self.mesh, (a,)))
            out.append(g)
            if lay.reduce_axes:
                buckets.setdefault(lay.reduce_axes, []).append(g)
        for axes, tensors in buckets.items():
            allreduce_sum_(tensors, mesh_lib.axes_group(self.mesh, axes))
        return out

    def _publish_params(self) -> None:
        """ZeRO: the updated slices all-gathered into every rank's whole
        parameters."""
        for (_, p), lay, op in zip(self._named_trained(), self._layouts,
                                   self._opt_params):
            if lay.opt != lay.store:
                whole = op.detach()
                for d, a in lay.scatter:
                    whole = coll.all_gather(
                        whole, d, mesh_lib.axes_group(self.mesh, (a,)))
                p.detach().copy_(whole)

    @torch.no_grad()
    def gathered_params(self) -> Dict[str, torch.Tensor]:
        """Every trained parameter whole, by name: the stored shards
        all-gathered over every axis that shards them (a collective:
        every rank of the mesh calls it)."""
        out = {}
        for (name, _), lay, stored in zip(self._named_trained(),
                                          self._layouts, self._stored):
            whole = stored.detach()
            for d, entry in enumerate(lay.store):
                for a in shd.spec_axes(entry):
                    whole = coll.all_gather(
                        whole, d, mesh_lib.axes_group(self.mesh, (a,)))
            out[name] = whole
        if not self.sharded:
            out = {n: p.detach() for n, p in self._named_trained()}
        return out

    def local_shards(self) -> List[Tuple[str, List[Tuple[int, int]],
                                         torch.Tensor]]:
        """``[(name, box, tensor)]``: the box of each trained parameter
        (port order of dims) this rank keeps between steps."""
        if not self.sharded:
            return [(n, [(0, k) for k in p.shape], p.detach())
                    for n, p in self._named_trained()]
        return [(lay.name, shd.local_slices(lay.store, lay.shape, self.mesh),
                 stored.detach())
                for lay, stored in zip(self._layouts, self._stored)]

    def state_bytes(self) -> Dict[str, int]:
        """Bytes this rank keeps between steps: its parameters (the
        stored shards) and its optimizer state."""
        mu, nu, _ = self._moments()
        return {
            "params": sum(t.numel() * t.element_size()
                          for t in self._stored),
            "optimizer": sum(t.numel() * t.element_size()
                             for t in list(mu) + list(nu)),
        }

    # -------------------------------------------------------------- state

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
        states = [opt.state[p] for p in self._opt_params]
        count = int(states[0]["step"]) if states else 0
        return ([s["exp_avg"] for s in states],
                [s["exp_avg_sq"] for s in states], count)

    def train_state(self) -> Dict[str, Any]:
        """The live training state, without copies: ``{"model": {name:
        parameter}, "optimizer": ...}``, the layout a checkpoint saves.
        The optimizer's part is optax's state by parameter name:
        ``{"mu": {name: moment}, "nu": {name: moment}, "count": updates}``
        for AdamW and Adam, ``{"sum_of_squares": {name: accumulator}}``
        for Adagrad. Under a sharded strategy the names are the JAX
        parameter tree's and each leaf a ``ckpt_store.ShardedLeaf`` of
        this rank's boxes (:meth:`_jax_state`)."""
        if self.sharded:
            return self._jax_state()
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

    def _jax_state(self) -> Dict[str, Any]:
        """The sharded state in the JAX parameter tree's coordinates:
        every port parameter is a box of its JAX leaf (a layer of a
        stacked leaf, transposed for a matrix), viewed in JAX order; the
        leaf's domains are every rank's boxes of every parameter in it,
        with the ranks that hold each."""
        from dlrover_tpu_torch.trainer.ckpt_store import ShardedLeaf

        mu, nu, count = self._moments()
        trees: Dict[str, Dict] = {"model": {}, "mu": {}, "nu": {}}
        for i, lay in enumerate(self._layouts):
            leaf = self._jax_coordinates(lay.name)
            for key, spec, t in (("model", lay.store, self._stored[i]),
                                 ("mu", lay.opt, mu[i]),
                                 ("nu", lay.opt, nu[i])):
                node = trees[key]
                for k in leaf.path[:-1]:
                    node = node.setdefault(k, {})
                sl = node.get(leaf.path[-1])
                if sl is None:
                    sl = node[leaf.path[-1]] = ShardedLeaf(
                        tuple(leaf.shape), t.dtype, [], [])
                box = shd.local_slices(spec, lay.shape, self.mesh)
                sl.pieces.append((leaf.index(box), leaf.to_jax(t.detach())))
                sl.domains += [
                    {"idx": leaf.index(b), "replicas": r}
                    for b, r in shd.global_boxes(spec, lay.shape, self.mesh)]
        return {"model": trees["model"],
                "optimizer": {"mu": trees["mu"], "nu": trees["nu"],
                              "count": count}}

    @torch.no_grad()
    def _load_jax_state(self, state: Dict[str, Any]) -> None:
        """:meth:`_jax_state`'s tree (restored) into the live shards."""
        moments = []
        seen: Dict[Tuple, int] = {}
        for i, lay in enumerate(self._layouts):
            leaf = self._jax_coordinates(lay.name)
            k = seen[leaf.path] = seen.get(leaf.path, -1) + 1

            def piece(tree):
                for key in leaf.path:
                    tree = tree[key]
                return leaf.from_jax(tree.pieces[k][1])

            self._stored[i].copy_(piece(state["model"]))
            moments.append((piece(state["optimizer"]["mu"]),
                            piece(state["optimizer"]["nu"])))
        for (_, p), lay, stored, op in zip(
                self._named_trained(), self._layouts, self._stored,
                self._opt_params):
            if op is not stored:  # ZeRO: the slice of the parameter
                op.copy_(_box(stored, shd.local_slices(
                    lay.opt, lay.shape, self.mesh)))
        self._set_optimizer([m for m, _ in moments],
                            [v for _, v in moments],
                            int(state["optimizer"]["count"]))

    @torch.no_grad()
    def load_train_state(self, state: Dict[str, Any]) -> None:
        """Copy a :meth:`train_state` tree (from a checkpoint) into the
        live parameters and optimizer, in place. The moments' dtype picks
        the optimizer as optax's state would: moments in the parameters'
        dtype keep ``torch.optim.AdamW`` at one microbatch, fp32 moments
        of lower-precision parameters mean :class:`Fp32GradAdamW`."""
        if self.sharded:
            self._load_jax_state(state)
            return
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
        params = self._opt_params
        fp32 = self.accum_steps > 1 or any(
            m.dtype != p.dtype for m, p in zip(mu, params))
        if fp32:
            opt = Fp32GradAdamW(params, self._make_optimizer)
            for dst, src in zip(opt.mu + opt.nu, list(mu) + list(nu)):
                dst.copy_(src)
            opt.count = count
        else:
            opt = self._make_optimizer(params)
            _init_adamw_state(opt)
            for p, m, v in zip(params, mu, nu):
                st = opt.state[p]
                st["exp_avg"].copy_(m)
                st["exp_avg_sq"].copy_(v)
                st["step"].fill_(count)
        self.optimizer = opt

    # --------------------------------------------------------------- step

    def train_step(self, batch) -> torch.Tensor:
        """One update on ``batch``, whose leaves have a leading microbatch
        axis of length ``accum_steps`` (see :meth:`microbatch`). Returns
        the mean loss (over the microbatches, and over the global batch
        of a process group), detached, without waiting for the device."""
        if self.sharded:
            return self._sharded_step(batch)
        accum = self.accum_steps
        reduced = self._dp_group is not None
        if not isinstance(self.optimizer, Fp32GradAdamW):
            loss = self._mean_loss(tuple(x[0] for x in batch))
            loss.backward()
            loss = loss.detach()
            if reduced:
                params = self._trained()
                for p in params:
                    if p.grad is None:  # one layout on every rank
                        p.grad = torch.zeros_like(p)
                loss = self._reduce([p.grad for p in params], loss)
            if self.before_update is not None:
                self.before_update()
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            return loss
        params = self._trained()
        sums = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        loss = torch.zeros((), device=self.device)
        for i in range(accum):
            micro = self._mean_loss(tuple(x[i] for x in batch))
            micro.backward()
            for acc, p in zip(sums, params):
                if p.grad is not None:
                    acc.add_(p.grad.float())
                    p.grad = None
            loss += micro.detach()
        grads = [acc.div_(accum) for acc in sums]
        loss = loss / accum
        if reduced:
            loss = self._reduce(grads, loss)
        if self.before_update is not None:
            self.before_update()
        self.optimizer.step(grads)
        return loss

    def _sharded_step(self, batch) -> torch.Tensor:
        """The step of zero1, zero2, fsdp, tp and tp_fsdp: gather what the
        forward needs, forward and backward on this rank's rows, the
        gradients reduced to the optimizer's boxes (zero1 once after the
        microbatches, the others per microbatch), the update, and the
        updated ZeRO slices gathered back."""
        coll.collective_seconds(reset=True)
        accum = self.accum_steps
        params = [p for _, p in self._named_trained()]
        self._gather_params()

        def grads_of():
            out = [p.grad if p.grad is not None else torch.zeros_like(p)
                   for p in params]
            for p in params:
                p.grad = None
            return out

        fp32 = isinstance(self.optimizer, Fp32GradAdamW)
        if not fp32:
            loss = self._mean_loss(tuple(x[0] for x in batch))
            loss.backward()
            loss = loss.detach()
            grads = self._reduce_to_opt(grads_of())
        else:
            per_micro = self.strategy != "zero1"
            sums = None
            loss = torch.zeros((), device=self.device)
            for i in range(accum):
                micro = self._mean_loss(tuple(x[i] for x in batch))
                micro.backward()
                g = grads_of()
                if per_micro:
                    g = self._reduce_to_opt(g)
                if sums is None:
                    sums = [x.float() for x in g]
                else:
                    for acc, x in zip(sums, g):
                        acc.add_(x.float())
                loss += micro.detach()
            if not per_micro:
                sums = self._reduce_to_opt(sums)
            grads = [acc.div_(accum) for acc in sums]
            loss = loss / accum
        if self._dp_group is not None:
            loss = coll.all_reduce_(loss.clone(), self._dp_group)
        self._release_params()
        if self.before_update is not None:
            self.before_update()
        if fp32:
            self.optimizer.step(grads)
        else:
            for op, g in zip(self._opt_params, grads):
                op.grad = g
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
        self._publish_params()
        self.reduce_seconds = coll.collective_seconds()
        return loss

    def _mean_loss(self, batch) -> torch.Tensor:
        """The loss's masked sum over its count (at least 1), as the JAX
        loss; above one data-parallel rank the count is the global
        batch's, so the ranks' quotients sum to the JAX loss on the
        global batch."""
        total, count = self._loss_fn(self.model, batch)
        if self._dp_group is not None:
            count = count.detach().clone()
            coll.all_reduce_(count, self._dp_group)
        return total / count.clamp(min=1.0)

    def _reduce(self, grads: List[torch.Tensor],
                loss: torch.Tensor) -> torch.Tensor:
        """The ddp step's reduction: ``grads`` summed over the
        data-parallel ranks in place, and the summed loss returned. It
        runs before ``before_update``, so a checkpoint's copies, ordered
        there, see the reduced and updated state of one step."""
        self._sync()
        t0 = time.perf_counter()
        loss = loss.clone()
        allreduce_sum_(grads + [loss], self._dp_group)
        self._sync()
        self.reduce_seconds = time.perf_counter() - t0
        return loss

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def forward_backward(self, batch) -> None:
        """The step's forward and backward on ``batch`` (the layout of
        :meth:`train_step`) without its update: the gradients come from
        ``torch.autograd.grad`` and are dropped, so neither ``.grad``
        nor the optimizer is touched, and nothing is reduced over the
        ranks (the step profile, trainer/profiler.py). A sharded
        strategy gathers its parameters for it, and drops them after."""
        if self.sharded:
            self._gather_params()
        params = self._trained()
        try:
            for i in range(self.accum_steps):
                total, count = self._loss_fn(
                    self.model, tuple(x[i] for x in batch))
                torch.autograd.grad(total / count.clamp(min=1.0), params,
                                    allow_unused=True)
        finally:
            if self.sharded:
                self._release_params()

    def microbatch(self, batch):
        """[global_batch, ...] -> [accum, global_batch / accum, ...]."""
        a = self.accum_steps
        return tuple(
            x.reshape((a, x.shape[0] // a) + tuple(x.shape[1:]))
            for x in batch
        )

    def shard_batch(self, batch):
        """Numpy or torch microbatches (this rank's rows, see
        :meth:`split_batch`) onto the trainer's device."""
        return tuple(
            torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x
                            ).to(self.device)
            for x in batch
        )


def family_trainer(cfg, loss_fn: Callable, init_fn: Callable,
                   param_count: int, device=None, strategy: str = "ddp",
                   accum_steps: int = 1,
                   optimizer: Optional[OptimizerFactory] = None,
                   mesh=None, param_axes: Optional[Callable] = None,
                   jax_coordinates: Optional[Callable] = None
                   ) -> ShardedTrainer:
    """A family's trainer (each family's ``make_trainer``), logged with
    its config and size."""
    trainer = ShardedTrainer(
        loss_fn, init_fn, device=device, strategy=strategy,
        optimizer=optimizer, accum_steps=accum_steps, mesh=mesh,
        param_axes=param_axes, jax_coordinates=jax_coordinates,
    )
    logger.info(
        "ShardedTrainer: %s params=%.1fM device=%s mesh=%s strategy=%s "
        "accum=%d", type(cfg).__name__, param_count / 1e6, trainer.device,
        mesh_lib.mesh_info(trainer.mesh), strategy, accum_steps,
    )
    return trainer


def make_trainer_for_llama(
    cfg,
    device=None,
    strategy: str = "ddp",
    accum_steps: int = 1,
    optimizer: Optional[OptimizerFactory] = None,
    attn_fn=None,
    mesh=None,
) -> ShardedTrainer:
    """Trainer for the Llama model; ``device=None`` is the GPU. The
    default strategy stays "ddp" (the JAX default is "fsdp"), which the
    port's callers before the mesh rely on; ``mesh=None`` is the JAX
    default mesh, ``[(data, 1), (fsdp, world)]``."""
    from dlrover_tpu_torch.models import llama

    def loss(model, batch):
        return llama.next_token_sums(model, batch, attn_fn=attn_fn)

    def init(seed, dev):
        return llama.init_params(cfg, seed=seed, device=dev)

    return family_trainer(
        cfg, loss, init, llama.param_count(cfg), device=device,
        strategy=strategy, accum_steps=accum_steps, optimizer=optimizer,
        mesh=mesh, param_axes=lambda model: llama.param_axes(cfg),
        jax_coordinates=lambda name: llama.jax_coordinates(cfg, name))
