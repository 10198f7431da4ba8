"""The train step: loss, backward, the optimizer, in place.

Counterpart of ``dlrover_tpu/trainer/sharded.py``. The class keeps its
name so that readers find the counterpart. A trainer runs one strategy
of the rule tables (``parallel/sharding.py``) on a mesh
(``parallel/mesh.py``; by default JAX's ``[(data, 1), (fsdp, world)]``).
The batch's rows are split over the data-parallel ranks (``batch_axes``:
data and fsdp), and under "sequence" each row's tokens over the ``seq``
ranks too: each rank steps on its own tokens, and the ranks of one
``tensor`` (or ``expert``) group see the same tokens. The JAX loss is
the masked mean over the global batch, so a loss function returns its
masked sum and the count it averages over, and each rank divides its
sum by the count summed over the ranks that hold other tokens
(``sum_axes``: the batch axes, and ``seq``); their quotients sum to the
JAX loss. A third term of the loss function, the MoE auxiliary loss
(the same on every rank), is added once over those ranks.

* ``"ddp"``: parameters and optimizer state replicated; between
  ``backward`` and the update the gradients and losses are summed over
  the data-parallel ranks (one ``all_reduce`` per dtype bucket), where
  XLA sums them (psum) in the JAX step.
* ``"rowwise"``: the recommender's layout (``models/dlrm.py``): the
  tables' rows (logical axis ``vocab``) split over fsdp and the batch
  over data only, so every rank of an fsdp group steps the same rows.
  The fsdp dim of a table is used sharded, as a tensor-parallel dim is:
  the forward looks the ids up in the rank's rows and sums the rows over
  fsdp (``parallel/embedding.py``), and the gradient and the optimizer
  state stay on those rows. Nothing is gathered, and only the data axis
  reduces gradients.
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
  ``embed`` dims of those shards, gathered before use as under fsdp. An
  MoE model's experts split over ``expert``: each rank runs its own
  experts on the global routing (``parallel/moe.py``).
* ``"sequence"``: tp_fsdp's parameter layout, and each sequence split
  over ``seq`` (``parallel/context_parallel.py``): the model's RoPE
  tables start at the rank's chunk, attention is ring attention (the
  default of ``make_trainer_for_llama``) or Ulysses, and the gradients
  and the loss's count are summed over ``seq`` as over the batch axes.
* ``"pipeline"``: tp_fsdp's layout within a stage, and the layers over
  ``pipe`` (``parallel/pipeline.py``): each rank holds and steps its
  stage's blocks only (the model's ``pipe_stage``; GPipe, or the
  interleaved schedule's chunks), and the loss runs the block stack as
  the stage's pipeline schedule (``pipeline_llama_forward``'s path),
  embed, final norm and head on every stage. The embedding's gradient,
  which arises on the first stage, is summed over ``pipe``; the head's
  and the final norm's are the same on every stage. ``pipe`` is neither
  a batch axis nor summed over otherwise. A model without a stage view
  (DLRM), or a mesh without a pipe axis, runs as tp_fsdp.

Every collective goes through
``trainer/distributed.py``'s layer, on the mesh's groups. A trainer runs
any table registered in ``parallel/sharding.STRATEGIES`` (a planned one,
``auto/planner.py``, too). A mesh axis of the rule table's ``batch``
entry splits the batch's rows and reduces the gradients; ``seq`` splits
the rows' tokens and reduces the gradients. A sharded parameter dim is
held -- used as the rank holds it -- only where the model's own parallel
code consumes it (``held_axes``: the Llama's and GPT's whole Megatron
layout over tensor, the experts over expert, DLRM's rows over fsdp under
rowwise). Every other sharded dim is gathered before use, as fsdp's are,
its gradient reduce-scattered over the ranks that hold other tokens and
cut where the ranks hold the same; a sharded stacked ``layers`` dim
(outside a pipeline) makes each rank own its layers whole: sent from
the owner before use, the gradient summed onto it. A dim that does not
divide splits as GSPMD pads it (``sharding.block``). The
strategies other than ddp need the model's logical axes (every family's
``make_trainer`` gives them), and their
:meth:`ShardedTrainer.train_state` is the JAX parameter tree
(``models/llama.py``'s ``jax_coordinates``: stacked layers, ``[in,
out]`` matrices) whose leaves are ``ckpt_store.ShardedLeaf``: the boxes
this rank holds, and the global map of every rank's boxes, which the
flash checkpoint writes as the leaf's domains.
Where the JAX step donates its buffers, this one updates
the parameters and optimizer state in place. The optimizers are
``optim/``'s: optax's ``adamw``, ``adam`` (AdamW without decay) and
``adagrad`` (``optim/optimizers.py``, re-exported here), and
``bf16_adamw`` and the wrappers ``master_weights`` and
``nonfinite_guard`` (``optim/bf16.py``). An optimizer's state is
optax's tree (``optim/state.py``). Gradient accumulation sums the
microbatches' gradients in fp32 buffers and hands their fp32 mean to
AdamW, as the JAX step hands it to optax. ``value_and_grad=`` replaces
the step's autograd call, as the JAX trainer's does (``optim/wsam.py``).
"""

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

import math
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from dlrover_tpu_torch.auto.device_context import resolve_device
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.optim.optimizers import (  # noqa: F401
    AdamW,
    Adagrad,
    Fp32GradAdamW,
    OptimizerFactory,
    RssAdagrad,
    adagrad,
    adam,
    adamw,
)
from dlrover_tpu_torch.optim.state import (
    init_adamw_state,
    load_optimizer_state,
    map_per_param,
    optimizer_state,
    per_param_leaves,
)
from dlrover_tpu_torch.parallel import mesh as mesh_lib
from dlrover_tpu_torch.parallel import pipeline
from dlrover_tpu_torch.parallel import sharding as shd
from dlrover_tpu_torch.trainer import distributed as coll

#: the named strategies (``parallel/sharding.py``'s tables); a trainer
#: runs any table registered in ``sharding.STRATEGIES``, a planned one
#: (``auto/planner.py``) too
STRATEGIES = ("ddp", "rowwise", "zero1", "zero2", "fsdp", "tp", "tp_fsdp",
              "sequence", "pipeline")


def allreduce_sum_(tensors: List[torch.Tensor], group,
                   label: Optional[str] = None) -> None:
    """Sum ``tensors`` over the ranks of ``group`` in place: one
    ``all_reduce`` per dtype on a flattened bucket, so every rank ends
    with the same bits; ``label`` counts the bytes
    (``collective_bytes``)."""
    if not tensors:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype in sorted(by_dtype, key=str):
        bucket = by_dtype[dtype]
        flat = _flatten_dense_tensors(bucket)
        coll.all_reduce_(flat, group, label=label)
        for t, r in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            t.copy_(r)


@dataclass
class _Layout:
    """How a strategy holds one parameter (port order of dims): its global
    ``shape``; ``store``, the spec of what the rank keeps between steps;
    ``opt``, of the box its optimizer steps; ``used``, the held part of
    ``store``: how the parameter the forward uses is sharded; ``gather``,
    the (dim, axis) pairs along which the stored shard is all-gathered
    into that parameter; ``scatter``, those along which the gradient is
    reduce-scattered to the optimizer's box (axes of ``sum_axes``);
    ``cut``, those along which the rank cuts its box out of the gradient
    (axes whose ranks see the same tokens, so hold the same gradient);
    ``reduce_axes``, the axes of ``sum_axes`` it is all-reduced over
    besides."""

    name: str
    shape: Tuple[int, ...]
    store: shd.Spec
    opt: shd.Spec
    used: shd.Spec
    gather: List[Tuple[int, str]]
    scatter: List[Tuple[int, str]]
    cut: List[Tuple[int, str]]
    reduce_axes: Tuple[str, ...]
    #: held by one pipeline stage only (a block's parameter)
    staged: bool = False
    #: a layer of a stacked leaf whose ``layers`` axis is sharded outside
    #: a pipeline: (the mesh axis, the coordinate on it that owns the
    #: layer whole); the other ranks hold nothing of it between steps
    owner: Optional[Tuple[str, int]] = None
    owned: bool = True


def _box(t: torch.Tensor, box) -> torch.Tensor:
    return t[tuple(slice(a, b) for a, b in box)]


def _as_lists(node):
    """A tree whose dicts keyed 0..n-1 become lists (the JAX trees' lists
    of layers)."""
    if not isinstance(node, dict):
        return node
    out = {k: _as_lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[k] for k in sorted(out)]
    return out


def _norm_sq(t: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(t, dtype=torch.float32).square()


class ShardedTrainer:
    """Owns the model and its optimizer; ``train_step`` runs one update.

    Args:
      loss_fn: ``loss_fn(model, batch) -> (sum, count)``: the masked
        loss summed over the batch, and the count of unmasked targets it
        is a mean over (``next_token_sums`` of the LMs, ``loss_sums`` of
        the CNN and DLRM); the step's loss is their quotient, over the
        global batch above one rank. A third element, if there is one
        and not None, is added to that mean once (the MoE Llama's
        auxiliary loss).
      init_fn: ``init_fn(seed, device) -> nn.Module``. Under a sharded
        strategy a parameter may come as the rank's box of its forward
        (a rowwise table's rows, ``models/dlrm.py``) instead of whole.
      device: where to train; ``None`` is the GPU.
      strategy: one of :data:`STRATEGIES` (see the module docstring).
      optimizer: a factory from parameters to an optimizer (default
        ``adamw(3e-4)``, the JAX trainer's default); :meth:`train_state`
        carries :func:`adamw`, :func:`adam`, :func:`adagrad` and the
        optimizers of ``optim/bf16.py``.
      accum_steps: microbatches per optimizer update. Above 1 the
        optimizer must be an :func:`adamw`, whose update then runs as
        :class:`Fp32GradAdamW` on the fp32 mean of the gradients.
      mesh: the ranks' mesh (``parallel/mesh.py``); ``None`` builds the
        JAX default, ``[(data, 1), (fsdp, world)]``.
      param_axes: ``param_axes(model) -> {name: logical axes}`` and
      jax_coordinates: ``jax_coordinates(name) -> models.llama.JaxLeaf``,
        which the sharded strategies need (the model's layout).
      value_and_grad: ``value_and_grad(model, batch) -> (loss, grads)``
        in place of the step's autograd call (the JAX trainer's hook,
        ``optim/wsam.py``): the rank's share of the loss and its
        gradients, one per trained parameter (or None), which the step
        then reduces as its own. A hook with ``bind(loss, grad_norm)``
        is bound at :meth:`init` to the trainer's loss on the rank's
        rows and to the norm of the data-parallel sum of gradients.
      pipe_stage: under "pipeline", the rank's stage
        (``parallel/pipeline.py``'s ``pipe_stage``; None: no pipeline):
        the model keeps the stage's blocks, and its forward runs the
        stage's schedule.
      held_axes: ``held_axes(rules) -> {(logical axis, mesh axis)}``, the
        sharded dims the model's parallel code consumes as the rank holds
        them (``models/llama.py``'s); every other sharded dim is gathered
        before use (None: every one).
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
        value_and_grad: Optional[Callable] = None,
        pipe_stage=None,
        held_axes: Optional[Callable] = None,
    ):
        if strategy in shd.NOT_PORTED:
            raise NotImplementedError(
                f"strategy {strategy!r} is not ported yet: ROADMAP.md "
                f"queue {shd.NOT_PORTED[strategy]}")
        if strategy not in shd.STRATEGIES:
            raise ValueError(f"Unknown strategy {strategy!r}; one of "
                             f"{sorted(shd.STRATEGIES)}")
        if strategy != "ddp" and (param_axes is None
                                  or jax_coordinates is None):
            raise NotImplementedError(
                f"strategy {strategy!r} needs the model's logical axes, "
                "which every family's make_trainer gives")
        optimizer = optimizer or adamw(3e-4)
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
        self._hook = value_and_grad
        self._value_and_grad: Optional[Callable] = None
        if mesh is None:
            mesh = mesh_lib.create_mesh(
                [(mesh_lib.DATA_AXIS, 1), (mesh_lib.FSDP_AXIS, -1)],
                device=self.device)
        self.mesh = mesh
        self.rules = shd.get_rules(strategy)
        #: the (logical axis, mesh axis) pairs the model's own parallel
        #: code consumes sharded
        self._held = set(held_axes(self.rules)) if held_axes else set()
        self.pipe_stage = pipe_stage if strategy == "pipeline" else None

        def rule_axes(logical):
            return tuple(a for a in shd.spec_axes(self.rules.get(logical))
                         if mesh_lib.axis_size(mesh, a) > 1)

        #: the data-parallel axes (the rule table's batch axes of size
        #: > 1): the batch's rows are split over these ranks
        self.batch_axes = rule_axes("batch")
        #: the seq axis under "sequence": each row's tokens split over it
        self.seq_axes = rule_axes("seq")
        #: the ranks that hold other tokens, and their group: the loss,
        #: its count and the gradients are summed over these ranks only
        self.sum_axes = self.batch_axes + self.seq_axes
        self._sum_group = mesh_lib.axes_group(mesh, self.sum_axes)
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
        return self.strategy != "ddp"

    @property
    def data_parallel_size(self) -> int:
        """The ranks that step different rows of the global batch."""
        return math.prod(mesh_lib.axis_size(self.mesh, a)
                         for a in self.batch_axes)

    def data_parallel_index(self) -> int:
        """This rank's index among the data-parallel ranks (in the order
        of the batch axes, the last minor): which part of the global
        batch it steps on."""
        idx = 0
        for a in self.batch_axes:
            idx = (idx * mesh_lib.axis_size(self.mesh, a)
                   + mesh_lib.axis_index(self.mesh, a))
        return idx

    def split_batch(self, batch):
        """This rank's part of a global batch (leaves [global, ...]):
        the data-parallel ranks split its rows, the ranks of one tensor
        group (or, under rowwise, of one fsdp group) share a part; under
        "sequence" the seq ranks split dim 1 of each row."""
        dp = self.data_parallel_size
        i = self.data_parallel_index()
        out = tuple(x[i * (x.shape[0] // dp):(i + 1) * (x.shape[0] // dp)]
                    for x in batch)
        if not self.seq_axes:
            return out
        sp = math.prod(mesh_lib.axis_size(self.mesh, a)
                       for a in self.seq_axes)
        j = mesh_lib.axis_index(self.mesh, self.seq_axes[0])
        return tuple(x[:, j * (x.shape[1] // sp):(j + 1) * (x.shape[1] // sp)]
                     for x in out)

    def init(self, seed: int = 0, model: Optional[nn.Module] = None):
        """Initialize (model, optimizer): ``init_fn(seed)``, or the given
        model moved to the trainer's device; a sharded strategy then
        keeps only this rank's shards of it."""
        if model is None:
            model = self._init_fn(seed, self.device)
        self.model = model.to(self.device)
        if self.pipe_stage is not None:
            self.model.keep_layers(self.pipe_stage.layers(
                len(self.model.blocks)))
        if self.sharded:
            self._shard_model()
        else:
            self._stored = self._opt_params = self._trained()
            self._place_model({})
        if self.accum_steps == 1:
            self.optimizer = self._make_optimizer(self._opt_params)
            if isinstance(self.optimizer, torch.optim.AdamW):
                init_adamw_state(self.optimizer)
        else:
            self.optimizer = Fp32GradAdamW(self._opt_params,
                                           self._make_optimizer)
        self._bind_optimizer()
        hook = self._hook
        if hook is not None and hasattr(hook, "bind"):
            hook = hook.bind(lambda model, batch: self._mean_loss(batch),
                             self._used_grad_norm)
        self._value_and_grad = hook
        return self.model, self.optimizer

    def _bind_optimizer(self) -> None:
        """A sharded strategy's optimizer sees its boxes of the
        gradients: a guard among its wrappers takes the global norm of
        the boxes of every rank (:meth:`_opt_grad_norm`)."""
        bind = getattr(self.optimizer, "bind_grad_norm", None)
        if bind is not None and self.sharded:
            bind(self._opt_grad_norm)

    # ------------------------------------------------------------ layouts

    def _global_shape(self, name: str, p: torch.Tensor) -> Tuple[int, ...]:
        leaf = self._jax_coordinates(name)
        return tuple(leaf.shape[leaf.dims[d]] for d in range(p.dim()))

    def _specs(self, name: str, logical, rules: shd.Rules):
        """(the spec of the port's dims, the entry of the JAX leaf's
        stacked ``layers`` dim or None) of a parameter under ``rules``:
        the first logical axis in the JAX leaf's order wins a mesh axis,
        the stacked layers dim first of all."""
        leaf = self._jax_coordinates(name)
        jax_axes: List[Optional[str]] = [None] * len(leaf.shape)
        if leaf.layer is not None:
            jax_axes[0] = "layers"
        for d, ax in enumerate(logical):
            jax_axes[leaf.dims[d]] = ax
        full = shd.spec_for_axes(tuple(jax_axes), rules, self.mesh)
        port = tuple(full[leaf.dims[d]] for d in range(len(logical)))
        return port, (full[0] if leaf.layer is not None else None)

    def _is_held(self, logical: Optional[str], axis: str) -> bool:
        """Whether the forward uses a dim sharded over ``axis`` as the
        rank holds it (the model's parallel code consumes it) rather than
        gathered first."""
        return (axis not in self.batch_axes
                and (logical, axis) in self._held)

    def _layout(self, name: str, shape, logical) -> _Layout:
        mesh = self.mesh
        store, layers = self._specs(name, logical, self.rules)
        opt_rules = shd.opt_state_rules(self.strategy)
        opt = (self._specs(name, logical, opt_rules)[0]
               if opt_rules is not None else store)
        for d, entry in enumerate(store + opt):
            if len(shd.spec_axes(entry)) > 1:
                raise NotImplementedError(
                    f"{name}: its {logical[d % len(logical)]!r} dim sharded "
                    f"over {shd.spec_axes(entry)}: one mesh axis per "
                    "parameter dim is carried")

        def held_part(spec):
            return tuple(e if e is not None and self._is_held(logical[d], e)
                         else None for d, e in enumerate(spec))

        def gathered(spec):
            return [(d, e) for d, e in enumerate(spec)
                    if e is not None and not self._is_held(logical[d], e)]

        used = held_part(store)
        if held_part(opt) != used:
            raise NotImplementedError(f"{name}: optimizer state sharded "
                                      "over a model axis unlike the "
                                      "parameter")
        scatter = [(d, a) for d, a in gathered(opt) if a in self.sum_axes]
        cut = [(d, a) for d, a in gathered(opt) if a not in self.sum_axes]
        owner, owned = None, True
        if layers is not None and not (self.pipe_stage is not None
                                       and layers == mesh_lib.PIPE_AXIS):
            axes = shd.spec_axes(layers)
            if len(axes) > 1 or opt != store:
                raise NotImplementedError(
                    f"{name}: its 'layers' dim sharded over {axes} under "
                    f"{self.strategy!r}: a layer is owned whole on one mesh "
                    "axis, its optimizer state with it")
            leaf = self._jax_coordinates(name)
            step = -(-leaf.shape[0] // mesh_lib.axis_size(mesh, axes[0]))
            owner = (axes[0], leaf.layer // step)
            owned = mesh_lib.axis_index(mesh, axes[0]) == owner[1]
        reduce_axes = tuple(
            a for a in self.sum_axes
            if a not in {a for _, a in scatter}
            and (owner is None or a != owner[0]))
        staged = False
        if self.pipe_stage is not None:
            staged = self._jax_coordinates(name).layer is not None
            if name in pipeline.FEED_PARAMS:  # its gradient: stage 0's
                reduce_axes += (mesh_lib.PIPE_AXIS,)
        return _Layout(name, tuple(shape), store, opt, used, gathered(store),
                       scatter, cut, reduce_axes, staged, owner, owned)

    @torch.no_grad()
    def _shard_model(self) -> None:
        """Cut the whole model every rank built down to this rank's
        shards: the held box (tensor, experts, or a rowwise table's rows)
        as the parameter the forward uses, the gathered dims' shard kept
        apart (the parameter emptied until a step gathers it), the ZeRO
        slice as the optimizer's own; a layer owned on another rank of a
        sharded ``layers`` axis is not kept at all. A parameter the model
        already holds as its forward box stays as it is."""
        axes = self._param_axes(self.model)
        self._layouts, self._stored, self._opt_params = [], [], []
        used_box = {}
        mesh = self.mesh
        for name, p in self._named_trained():
            shape = self._global_shape(name, p)
            lay = self._layout(name, shape, axes[name])
            used_box[name] = shd.local_slices(lay.used, shape, mesh)
            whole = None
            if tuple(p.shape) == shape:
                whole = p.detach()
                p.data = _box(whole, used_box[name]).clone()
            elif (tuple(p.shape) != tuple(b - a for a, b in used_box[name])
                  or lay.gather or lay.opt != lay.store or lay.owner):
                raise ValueError(
                    f"{name}: {tuple(p.shape)} is neither the whole "
                    f"{shape} nor this rank's box {used_box[name]}")
            stored = p
            if not lay.owned:
                stored = nn.Parameter(whole.new_empty(0))
                p.data = p.data.new_empty(0)
            elif lay.gather or lay.owner:
                stored = nn.Parameter(_box(whole, shd.local_slices(
                    lay.store, shape, mesh)).clone())
                p.data = p.data.new_empty(0)
            opt_param = stored
            if lay.opt != lay.store:
                opt_param = nn.Parameter(_box(whole, shd.local_slices(
                    lay.opt, shape, mesh)).clone())
            self._layouts.append(lay)
            self._stored.append(stored)
            self._opt_params.append(opt_param)
        self._place_model(used_box)

    def _place_model(self, used_box: Dict[str, list]) -> None:
        """Tell the model where the rank sits: the tensor group and its
        vocab rows, its chunk of each sequence (``seq_shard``), and each
        MoE block's experts and token groups (``moe_shard``).
        ``used_box``: each parameter's box of the forward (empty when the
        strategy shards none)."""
        from dlrover_tpu_torch.parallel.context_parallel import seq_shard
        from dlrover_tpu_torch.parallel.moe import ExpertShard

        mesh, model = self.mesh, self.model
        if self._tp_group is not None and any(
                mesh_lib.TENSOR_AXIS in shd.spec_axes(e)
                for lay in self._layouts for e in lay.used):
            model.tp_group = self._tp_group
            model.vocab_start = used_box["embed"][0][0]
            for module in model.modules():
                if hasattr(module, "tp_group"):
                    module.tp_group = self._tp_group
        if self.seq_axes and hasattr(model, "seq_shard"):
            model.seq_shard = seq_shard(mesh, self.seq_axes[0])
        if hasattr(model, "pipe_stage"):
            model.pipe_stage = self.pipe_stage
        used = {lay.name: lay.used for lay in self._layouts}
        for name, module in model.named_modules():
            if not hasattr(module, "moe_shard"):
                continue
            # the axes that split the experts' work: the expert dim's and
            # the mlp dim's of the forward's w_gate
            spec = used.get(f"{name}.w_gate", ())
            module.moe_shard = ExpertShard(
                expert_start=(used_box[f"{name}.w_gate"][0][0]
                              if used_box else 0),
                expert_group=mesh_lib.axes_group(
                    mesh, [a for e in spec for a in shd.spec_axes(e)]),
                seq_group=mesh_lib.axes_group(mesh, self.seq_axes),
                batch_group=mesh_lib.axes_group(mesh, self.batch_axes))

    def _group(self, axis: str):
        return mesh_lib.axes_group(self.mesh, (axis,))

    def _gather_params(self) -> None:
        """The parameters the forward uses, from the ranks' shards: the
        gathered dims all-gathered, an owned layer sent from its owner."""
        for (_, p), lay, stored in zip(self._named_trained(), self._layouts,
                                       self._stored):
            if not (lay.gather or lay.owner):
                continue
            whole = stored.detach()
            if lay.owned:
                for d, a in lay.gather:
                    whole = coll.all_gather(whole, d, self._group(a),
                                            size=lay.shape[d])
            if lay.owner is not None:
                if not lay.owned:
                    whole = stored.new_empty([b - a for a, b in (
                        shd.local_slices(lay.used, lay.shape, self.mesh))])
                whole = coll.broadcast(whole, lay.owner[1],
                                       self._group(lay.owner[0]))
            p.data = whole

    def _release_params(self) -> None:
        for (_, p), lay in zip(self._named_trained(), self._layouts):
            p.grad = None
            if lay.gather or lay.owner:
                p.data = p.data.new_empty(0)

    def _reduce_to_opt(self, grads: List[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """Gradients of the parameters the forward used, from this rank's
        rows -> the optimizer's boxes of their sum over the ranks that
        hold other tokens, each counted once: an owned layer's summed
        onto its owner (the others keep nothing), reduce-scattered along
        the dims sharded over those ranks, cut along the dims sharded
        over ranks that hold the same gradient, all-reduced over the
        rest (one bucket per group and dtype)."""
        out, buckets = [], {}
        for lay, g in zip(self._layouts, grads):
            if lay.owner is not None and lay.owner[0] in self.sum_axes:
                g = coll.all_reduce_(g, self._group(lay.owner[0]))
            if not lay.owned:
                out.append(g.new_empty(0))
                continue
            for d, a in lay.scatter:
                g = coll.reduce_scatter(g, d, self._group(a))
            for d, a in lay.cut:
                lo, hi = shd.block(g.shape[d], mesh_lib.axis_size(
                    self.mesh, a), mesh_lib.axis_index(self.mesh, a))
                g = g.narrow(d, lo, hi - lo).contiguous()
            out.append(g)
            if lay.reduce_axes:
                buckets.setdefault(lay.reduce_axes, []).append(g)
        for axes, tensors in buckets.items():
            # the pipeline's feed (the embedding), counted apart
            allreduce_sum_(tensors, mesh_lib.axes_group(self.mesh, axes),
                           label=("pipeline_feed" if mesh_lib.PIPE_AXIS in axes
                                  else None))
        return out

    def _publish_params(self) -> None:
        """ZeRO: the updated slices all-gathered into every rank's whole
        parameters."""
        for (_, p), lay, op in zip(self._named_trained(), self._layouts,
                                   self._opt_params):
            if lay.opt != lay.store:
                whole = op.detach()
                for d, a in lay.scatter + lay.cut:
                    whole = coll.all_gather(whole, d, self._group(a),
                                            size=lay.shape[d])
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
            if lay.owned:
                for d, entry in enumerate(lay.store):
                    for a in shd.spec_axes(entry):
                        whole = coll.all_gather(whole, d, self._group(a),
                                                size=lay.shape[d])
            if lay.owner is not None:
                if not lay.owned:
                    whole = stored.new_empty(lay.shape)
                whole = coll.broadcast(whole, lay.owner[1],
                                       self._group(lay.owner[0]))
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
                for lay, stored in zip(self._layouts, self._stored)
                if lay.owned]

    def state_bytes(self) -> Dict[str, int]:
        """Bytes this rank keeps between steps: its parameters (the
        stored shards) and its optimizer's per-parameter state."""
        return {
            "params": sum(t.numel() * t.element_size()
                          for t in self._stored),
            "optimizer": sum(
                t.numel() * t.element_size()
                for _, ts in per_param_leaves(optimizer_state(
                    self.optimizer)) for t in ts),
        }

    # ------------------------------------------------------------- norms

    def _global_norm(self, tensors: List[torch.Tensor],
                     specs: List[shd.Spec], owned: bool = True
                     ) -> torch.Tensor:
        """The norm of the global tensors whose boxes, laid out by
        ``specs``, the ranks hold: each box's square counted once over
        the ranks that hold a copy of it (a block's, under "pipeline",
        only its stage's ranks; with ``owned``, an owned layer's only its
        owner's), summed over the mesh. On the device, without a host
        sync."""
        ranks = math.prod(self.mesh.mesh.shape) if self.sharded else 1
        stages = (mesh_lib.axis_size(self.mesh, mesh_lib.PIPE_AXIS)
                  if self.pipe_stage is not None else 1)
        holders = [
            (stages if lay.staged else 1)
            * (mesh_lib.axis_size(self.mesh, lay.owner[0])
               if owned and lay.owner else 1)
            for lay in self._layouts] or [1] * len(tensors)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for t, spec, share in zip(tensors, specs, holders):
            parts = math.prod(mesh_lib.axis_size(self.mesh, a)
                              for e in spec for a in shd.spec_axes(e))
            total = total + _norm_sq(t) * (parts * share / ranks)
        if ranks > 1:
            coll.all_reduce_(total, dist.group.WORLD)
        return total.sqrt()

    def _opt_grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global gradient's norm from the optimizer's boxes of the
        reduced gradients (a guard's non-finite test: every rank
        decides alike)."""
        grads = [g if g is not None else torch.zeros_like(p)
                 for g, p in zip(grads, self._opt_params)]
        return self._global_norm(grads, [lay.opt for lay in self._layouts])

    def _used_grad_norm(self, grads: List[Optional[torch.Tensor]]
                        ) -> torch.Tensor:
        """The norm of the global gradient from this rank's gradients of
        the parameters the forward used: their sum over the
        data-parallel ranks (a copy), then :meth:`_global_norm`."""
        grads = [g if g is not None else torch.zeros_like(p)
                 for g, p in zip(grads, self._trained())]
        if self._sum_group is not None:
            grads = [g.clone() for g in grads]
            allreduce_sum_(grads, self._sum_group)
        if self.pipe_stage is not None:  # the feed's, over the stages
            for i, lay in enumerate(self._layouts):
                if mesh_lib.PIPE_AXIS in lay.reduce_axes:
                    grads[i] = coll.all_reduce_(grads[i].clone(),
                                                self.pipe_stage.group)
        if not self.sharded:
            return self._global_norm(grads, [()] * len(grads))
        return self._global_norm(grads, [lay.used for lay in self._layouts],
                                 owned=False)

    # -------------------------------------------------------------- state

    def _trained(self) -> List[nn.Parameter]:
        return [p for p in self.model.parameters() if p.requires_grad]

    def _named_trained(self) -> List[Tuple[str, nn.Parameter]]:
        return [(n, p) for n, p in self.model.named_parameters()
                if p.requires_grad]

    def _moments(self):
        """(mu, nu, count): AdamW's moments in parameter order and its
        update count -- optax's ``ScaleByAdamState``."""
        tree = optimizer_state(self.optimizer)
        return tree["mu"], tree["nu"], tree["count"]

    def train_state(self) -> Dict[str, Any]:
        """The live training state, without copies: ``{"model": {name:
        parameter}, "optimizer": ...}``, the layout a checkpoint saves.
        The optimizer's part is optax's state (:func:`optimizer_state`)
        with each per-parameter list keyed by parameter name: ``{"mu",
        "nu", "count"}`` for AdamW and Adam, ``{"sum_of_squares"}`` for
        Adagrad. Under a sharded strategy the names are the JAX parameter
        tree's and each leaf a ``ckpt_store.ShardedLeaf`` of this rank's
        boxes (:meth:`_jax_state`)."""
        if self.sharded:
            return self._jax_state()
        named = self._named_trained()
        names = [n for n, _ in named]
        opt = map_per_param(optimizer_state(self.optimizer),
                            lambda _, ts: dict(zip(names, ts)))
        return {"model": {n: p.detach() for n, p in named},
                "optimizer": opt}

    def _jax_tree(self, specs: List[shd.Spec],
                  tensors: List[torch.Tensor]) -> Dict[str, Any]:
        """One tensor per layout, each the box of its JAX leaf that
        ``specs`` gives this rank, as the JAX parameter tree: every port
        parameter is a box of its leaf (a layer of a stacked leaf,
        transposed for a matrix), viewed in JAX order; the leaf's domains
        are every rank's boxes of every parameter in it, with the ranks
        that hold each (a pipeline stage's layers: its ranks alone)."""
        from dlrover_tpu_torch.trainer.ckpt_store import ShardedLeaf

        root: Dict = {}
        for lay, spec, t in zip(self._layouts, specs, tensors):
            leaf = self._jax_coordinates(lay.name)
            node = root
            for k in leaf.path[:-1]:
                node = node.setdefault(k, {})
            sl = node.get(leaf.path[-1])
            if sl is None:
                sl = node[leaf.path[-1]] = ShardedLeaf(
                    tuple(leaf.shape), t.dtype, [], [])
                if lay.staged:  # every layer's boxes, on its stage's ranks
                    sl.domains += [
                        {"idx": replace(leaf, layer=i).index(b),
                         "replicas": r}
                        for i in range(leaf.shape[0])
                        for b, r in shd.global_boxes(
                            spec, lay.shape, self.mesh,
                            where={mesh_lib.PIPE_AXIS: self.pipe_stage.owner(
                                i, leaf.shape[0])})]
            if lay.owned:
                box = shd.local_slices(spec, lay.shape, self.mesh)
                sl.pieces.append((leaf.index(box), leaf.to_jax(t.detach())))
            if not lay.staged:
                sl.domains += [
                    {"idx": leaf.index(b), "replicas": r}
                    for b, r in shd.global_boxes(
                        spec, lay.shape, self.mesh,
                        where=dict([lay.owner]) if lay.owner else None)]
        return _as_lists(root)

    def _jax_state(self) -> Dict[str, Any]:
        """The sharded state in the JAX parameter tree's coordinates."""
        opt_specs = [lay.opt for lay in self._layouts]
        return {
            "model": self._jax_tree([lay.store for lay in self._layouts],
                                    self._stored),
            "optimizer": map_per_param(
                optimizer_state(self.optimizer),
                lambda _, ts: self._jax_tree(opt_specs, ts))}

    @torch.no_grad()
    def _load_jax_state(self, state: Dict[str, Any]) -> None:
        """:meth:`_jax_state`'s tree (restored) into the live shards."""
        seen: Dict[Tuple, int] = {}
        pieces = []
        for lay in self._layouts:
            leaf = self._jax_coordinates(lay.name)
            if not lay.owned:  # an owned layer of another rank: no piece
                pieces.append((leaf, None))
                continue
            k = seen[leaf.path] = seen.get(leaf.path, -1) + 1
            pieces.append((leaf, k))

        def boxes(tree, live) -> List[torch.Tensor]:
            out = []
            for (leaf, k), own in zip(pieces, live):
                node = tree
                for key in leaf.path:
                    node = node[key]
                out.append(own if k is None
                           else leaf.from_jax(node.pieces[k][1]))
            return out

        for dst, src in zip(self._stored, boxes(state["model"],
                                                self._stored)):
            if src is not dst:
                dst.copy_(src)
        for lay, stored, op in zip(self._layouts, self._stored,
                                   self._opt_params):
            if op is not stored:  # ZeRO: the slice of the parameter
                op.copy_(_box(stored, shd.local_slices(
                    lay.opt, lay.shape, self.mesh)))

        def saved(path, live):
            node = state["optimizer"]
            for key in path:
                node = node[key]
            return boxes(node, live)

        self._load_optimizer(map_per_param(optimizer_state(self.optimizer),
                                           saved), state["optimizer"])

    def _load_optimizer(self, tree: Dict[str, Any], saved) -> None:
        """A restored optimizer state (per-parameter lists in the order of
        the optimizer's parameters; scalars from ``saved``) into the
        optimizer. AdamW's moments pick its class by their dtype (see
        :meth:`load_train_state`)."""
        tree = map_per_param(tree, lambda _, ts: ts)

        def scalars(node, src):
            for k, v in node.items():
                if isinstance(v, dict):
                    scalars(v, src[k])
                elif not isinstance(v, list):
                    node[k] = src[k]

        scalars(tree, saved)
        if isinstance(self._make_optimizer, AdamW):
            self._set_optimizer(tree["mu"], tree["nu"], int(tree["count"]))
        else:
            load_optimizer_state(self.optimizer, tree)

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

        def saved(path, _):
            node = opt
            for key in path:
                if not isinstance(node, dict) or key not in node:
                    raise ValueError(
                        f"an optimizer state of {sorted(opt)} for a trainer "
                        f"whose optimizer is a "
                        f"{type(self.optimizer).__name__}")
                node = node[key]
            return [node[n] for n, _ in named]

        self._load_optimizer(map_per_param(
            optimizer_state(self.optimizer), saved), opt)

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
            tree = optimizer_state(self.optimizer)
            self._set_optimizer(tree["mu"], tree["nu"], tree["count"])

    def _set_optimizer(self, mu, nu, count: int) -> None:
        params = self._opt_params
        fp32 = self.accum_steps > 1 or any(
            m.dtype != p.dtype for m, p in zip(mu, params))
        opt = (Fp32GradAdamW(params, self._make_optimizer) if fp32
               else self._make_optimizer(params))
        load_optimizer_state(opt, {"mu": mu, "nu": nu, "count": count})
        self.optimizer = opt
        self._bind_optimizer()

    # --------------------------------------------------------------- step

    def _loss_and_grads(self, batch):
        """The rank's share of the loss on ``batch`` (detached) and its
        gradient of every trained parameter (None where it has none):
        autograd, or the ``value_and_grad`` hook."""
        if self._value_and_grad is not None:
            loss, grads = self._value_and_grad(self.model, batch)
            return loss.detach(), list(grads)
        loss = self._mean_loss(batch)
        loss.backward()
        grads = []
        for p in self._trained():
            grads.append(p.grad)
            p.grad = None
        return loss.detach(), grads

    def train_step(self, batch) -> torch.Tensor:
        """One update on ``batch``, whose leaves have a leading microbatch
        axis of length ``accum_steps`` (see :meth:`microbatch`). Returns
        the mean loss (over the microbatches, and over the global batch
        of a process group), detached, without waiting for the device."""
        if self.sharded:
            return self._sharded_step(batch)
        accum = self.accum_steps
        reduced = self._sum_group is not None
        params = self._trained()
        if not isinstance(self.optimizer, Fp32GradAdamW):
            loss, grads = self._loss_and_grads(tuple(x[0] for x in batch))
            if reduced:  # one layout on every rank
                grads = [g if g is not None else torch.zeros_like(p)
                         for g, p in zip(grads, params)]
                loss = self._reduce(grads, loss)
            for p, g in zip(params, grads):
                p.grad = g
            if self.before_update is not None:
                self.before_update()
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            return loss
        sums = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        loss = torch.zeros((), device=self.device)
        for i in range(accum):
            micro, grads = self._loss_and_grads(tuple(x[i] for x in batch))
            for acc, g in zip(sums, grads):
                if g is not None:
                    acc.add_(g.float())
            loss += micro
        grads = [acc.div_(accum) for acc in sums]
        loss = loss / accum
        if reduced:
            loss = self._reduce(grads, loss)
        if self.before_update is not None:
            self.before_update()
        self.optimizer.step(grads)
        return loss

    def _sharded_step(self, batch) -> torch.Tensor:
        """The step of the sharded strategies: gather what the forward
        needs, forward and backward on this rank's rows, the gradients
        reduced to the optimizer's boxes (zero1 once after the
        microbatches, the others per microbatch), the update, and the
        updated ZeRO slices gathered back."""
        coll.collective_seconds(reset=True)
        accum = self.accum_steps
        params = [p for _, p in self._named_trained()]
        self._gather_params()

        def grads_of(batch):
            loss, grads = self._loss_and_grads(batch)
            return loss, [g if g is not None else torch.zeros_like(p)
                          for g, p in zip(grads, params)]

        fp32 = isinstance(self.optimizer, Fp32GradAdamW)
        if not fp32:
            loss, grads = grads_of(tuple(x[0] for x in batch))
            grads = self._reduce_to_opt(grads)
        else:
            per_micro = self.strategy != "zero1"
            sums = None
            loss = torch.zeros((), device=self.device)
            for i in range(accum):
                micro, g = grads_of(tuple(x[i] for x in batch))
                if per_micro:
                    g = self._reduce_to_opt(g)
                if sums is None:
                    sums = [x.float() for x in g]
                else:
                    for acc, x in zip(sums, g):
                        acc.add_(x.float())
                loss += micro
            if not per_micro:
                sums = self._reduce_to_opt(sums)
            grads = [acc.div_(accum) for acc in sums]
            loss = loss / accum
        if self._sum_group is not None:
            loss = coll.all_reduce_(loss.clone(), self._sum_group)
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

    def _mean_loss(self, batch, global_count: bool = True
                   ) -> torch.Tensor:
        """The loss's masked sum over its count (at least 1), as the JAX
        loss; above one rank of ``sum_axes`` the count is the global
        batch's (``global_count``), so the ranks' quotients sum to the
        JAX loss on the global batch. An auxiliary term of the loss
        function is added divided by those ranks, so it counts once in
        the sum."""
        total, count, *rest = self._loss_fn(self.model, batch)
        if self._sum_group is not None and global_count:
            count = count.detach().clone()
            coll.all_reduce_(count, self._sum_group)
        loss = total / count.clamp(min=1.0)
        aux = rest[0] if rest else None
        if aux is not None:
            loss = loss + aux / math.prod(
                mesh_lib.axis_size(self.mesh, a) for a in self.sum_axes)
        return loss

    def _reduce(self, grads: List[torch.Tensor],
                loss: torch.Tensor) -> torch.Tensor:
        """The ddp step's reduction: ``grads`` summed over the
        data-parallel ranks in place, and the summed loss returned. It
        runs before ``before_update``, so a checkpoint's copies, ordered
        there, see the reduced and updated state of one step."""
        self._sync()
        t0 = time.perf_counter()
        loss = loss.clone()
        allreduce_sum_(grads + [loss], self._sum_group)
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
                loss = self._mean_loss(tuple(x[i] for x in batch),
                                       global_count=False)
                torch.autograd.grad(loss, params, allow_unused=True)
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
                   jax_coordinates: Optional[Callable] = None,
                   value_and_grad: Optional[Callable] = None,
                   pipe_stage=None,
                   held_axes: Optional[Callable] = None) -> ShardedTrainer:
    """A family's trainer (each family's ``make_trainer``), logged with
    its config and size."""
    trainer = ShardedTrainer(
        loss_fn, init_fn, device=device, strategy=strategy,
        optimizer=optimizer, accum_steps=accum_steps, mesh=mesh,
        param_axes=param_axes, jax_coordinates=jax_coordinates,
        value_and_grad=value_and_grad, pipe_stage=pipe_stage,
        held_axes=held_axes,
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
    value_and_grad: Optional[Callable] = None,
    num_microbatches: int = 4,
    num_chunks: int = 1,
) -> ShardedTrainer:
    """Trainer for the Llama model; ``device=None`` is the GPU. The
    default strategy stays "ddp" (the JAX default is "fsdp"), which the
    port's callers before the mesh rely on; ``mesh=None`` is the JAX
    default mesh, ``[(data, 1), (fsdp, world)]``; ``value_and_grad`` is
    :class:`ShardedTrainer`'s hook. Under "sequence" without an
    ``attn_fn`` attention is ring attention over the mesh's seq axis,
    as in the JAX package (``parallel/context_parallel.py``). Under
    "pipeline" the loss runs ``pipeline_llama_forward``'s pipeline over
    the mesh's pipe axis with ``num_microbatches`` microbatches and
    ``num_chunks`` chunks a stage (1: GPipe), and each rank builds only
    its stage's blocks; without a pipe axis it runs as tp_fsdp."""
    from dlrover_tpu_torch.models import llama

    if mesh is None:
        mesh = mesh_lib.create_mesh(
            [(mesh_lib.DATA_AXIS, 1), (mesh_lib.FSDP_AXIS, -1)],
            device=resolve_device(device))
    llama.check_heads(cfg, shd.get_rules(strategy), mesh)
    if attn_fn is None and strategy == "sequence":
        from dlrover_tpu_torch.parallel.context_parallel import (
            make_context_parallel_attn,
        )

        attn_fn = make_context_parallel_attn(mesh, kind="ring")
    stage = None
    if strategy == "pipeline":
        stage = pipeline.pipe_stage(mesh, num_microbatches, num_chunks)
    if stage is not None:
        pipeline.check_schedule(cfg.num_layers, stage)

    def loss(model, batch):
        return llama.next_token_sums(model, batch, attn_fn=attn_fn)

    def init(seed, dev):
        return llama.init_params(
            cfg, seed=seed, device=dev,
            layers=None if stage is None else stage.layers(cfg.num_layers))

    return family_trainer(
        cfg, loss, init, llama.param_count(cfg), device=device,
        strategy=strategy, accum_steps=accum_steps, optimizer=optimizer,
        mesh=mesh, param_axes=lambda model: llama.param_axes(cfg),
        jax_coordinates=lambda name: llama.jax_coordinates(cfg, name),
        value_and_grad=value_and_grad, pipe_stage=stage,
        held_axes=llama.held_axes)
