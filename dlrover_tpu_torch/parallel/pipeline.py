"""Pipeline parallelism: GPipe and the interleaved schedule over "pipe".

Counterpart of ``dlrover_tpu/parallel/pipeline.py``. The JAX package
shards the scan-stacked layer dim over the ``pipe`` mesh axis and runs
the schedule under ``shard_map``: each tick every stage applies its
blocks to its current microbatch and hands the activation on with
``lax.ppermute``; the backward is autodiff, each ppermute's transpose
the reverse one. Here each rank of a pipe group holds only its own
blocks (:meth:`PipeStage.layers`: with GPipe stage ``s`` holds the
``L/P`` layers from ``s x L/P``, with ``V`` chunks the JAX chunks
``{v x P + s}``), and one autograd Function per pipeline call runs the
whole schedule, so that every rank issues its sends and receives in the
one order the static schedule gives:

* the forward walks the ticks: a stage with work at a tick runs the
  blocks of its chunk on its microbatch -- the feed on stage 0's first
  chunk, else what its neighbour sent at the tick before -- keeps the
  microbatch's stage graph (the blocks under their remat policy:
  ``"dots"`` keeps the matmul outputs), and sends the output on with
  :func:`~dlrover_tpu_torch.trainer.distributed.exchange`; the last
  stage keeps the outputs of its last chunk, and a masked all-reduce
  gives them to every rank, as JAX's psum does;
* the backward walks the ticks in reverse: receive dY, the backward of
  the kept stage graph (``torch.autograd.grad``), send dX back along
  the reverse pairs -- the mirrored schedule that JAX gets from
  ppermute's transpose. Only the last stage reads its cotangent of the
  outputs (the rank's own copy, once); the feed's gradient arises on
  stage 0 alone. Each stage parameter's gradient is summed over the
  microbatches in fp32 and rounded once.

Unlike JAX, a bubble tick (no work on a stage) computes nothing and
sends nothing: every rank knows the schedule, so the pairs of each
tick name only the stages that work. The MoE auxiliary loss of the
blocks is summed over each stage's work, over the pipe group, and
divided by the microbatch count, as JAX's ``psum(aux) / M``.

A model holds its stage as ``Llama.pipe_stage`` (the trainer's
"pipeline" strategy sets it): its forward then runs the block stack as
this pipeline, with embed, final norm and ``lm_head`` outside it on
every stage.
"""

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from dlrover_tpu_torch.parallel.mesh import (
    PIPE_AXIS, Mesh, axes_group, axis_index, axis_size,
)
from dlrover_tpu_torch.trainer import distributed as coll

#: parameters a model uses before the pipeline (the Llama embedding):
#: their gradient arises on the first stage only, so the "pipeline"
#: strategy sums it over the pipe axis
FEED_PARAMS = ("embed",)

#: remat policies under pipelining (JAX ``pipeline_llama_forward``):
#: the activations kept scale with the microbatches in flight, so
#: "dots_attn_out"'s saved attention residuals are the wrong trade
_REMAT = {"off": "off", "dots": "dots", "dots_attn_out": "dots",
          "minimal": "minimal"}


def bubble_fraction(pp: int, num_micro: int, num_chunks: int = 1) -> float:
    """Idle fraction of the schedule: (P-1)/(M*V+P-1); 0 at one stage."""
    if pp <= 1:
        return 0.0
    return (pp - 1) / (num_micro * num_chunks + pp - 1)


def _work(t: int, stage: int, pp: int, num_micro: int, num_chunks: int
          ) -> Optional[Tuple[int, int]]:
    """(microbatch, chunk) of ``stage`` at tick ``t``, or None (a bubble):
    microbatch m = a*P + r meets chunk v on stage s at tick a*V*P + v*P
    + r + s (JAX's ``_interleaved_local``; with V = 1 GPipe's m = t - s)."""
    rel = t - stage
    if rel < 0:
        return None
    a, v, r = (rel // (num_chunks * pp), (rel % (num_chunks * pp)) // pp,
               rel % pp)
    m = a * pp + r
    return (m, v) if m < num_micro else None


@dataclass
class _Plan:
    """One pipeline call: the block function, this stage's chunks of
    layers (``chunks[v]``, in layer order) and their tensors' places in
    the Function's parameter list, the group and the schedule."""

    block_fn: Callable
    chunks: List[List[Any]]
    spans: List[Tuple[int, int]]
    params: List[torch.Tensor]
    group: Any
    stage: int
    pp: int
    num_micro: int
    num_chunks: int
    #: filled by the forward: the work items this stage ran
    worked: int = 0
    graphs: Dict[int, tuple] = field(default_factory=dict)

    @property
    def ticks(self) -> int:
        return self.num_micro * self.num_chunks + self.pp - 1

    def work(self, t: int, stage: Optional[int] = None):
        return _work(t, self.stage if stage is None else stage, self.pp,
                     self.num_micro, self.num_chunks)

    def emits(self, stage: int, v: int) -> bool:
        """The last stage's last chunk gives the pipeline's output."""
        return stage == self.pp - 1 and v == self.num_chunks - 1

    def pairs(self, t: int) -> List[Tuple[int, int]]:
        """(source, destination) stages of the activations sent after
        tick ``t``: every stage with work whose output is not final sends
        to the next stage around the ring."""
        out = []
        for s in range(self.pp):
            w = self.work(t, s)
            if w is not None and not self.emits(s, w[1]):
                out.append((s, (s + 1) % self.pp))
        return out

    def run_stage(self, v: int, x):
        """The blocks of chunk ``v`` on ``x``: (y, summed aux or None)."""
        return _plain(self.block_fn, self.chunks[v], x)


def _forward(plan: _Plan, x_mb: torch.Tensor, keep: bool):
    """The schedule's forward: (outputs on every rank, the aux summed
    over every stage's work over the microbatch count, or None). ``keep``
    keeps each work item's stage graph in ``plan.graphs`` for the
    backward."""
    like = x_mb[0]
    ybuf = torch.zeros_like(x_mb)
    aux_total = None
    got = None
    for t in range(plan.ticks):
        w = plan.work(t)
        y = None
        if w is not None:
            m, v = w
            feed = plan.stage == 0 and v == 0
            inp = x_mb[m] if feed else got
            if keep:
                inp = inp.detach().requires_grad_(True)
            with torch.set_grad_enabled(keep):
                y, aux = plan.run_stage(v, inp)
            if keep:
                plan.graphs[t] = (inp, y, aux)
            y = y.detach()
            if aux is not None:
                aux = aux.detach().float()
                aux_total = aux if aux_total is None else aux_total + aux
            if plan.emits(plan.stage, v):
                ybuf[m] = y
            plan.worked += 1
        got = coll.exchange(y, plan.group, plan.pairs(t), like)
    # the last stage's outputs, zeros elsewhere: summed, every rank's
    coll.all_reduce_(ybuf, plan.group, label="pipeline_outputs")
    if aux_total is not None:
        aux_total = coll.all_reduce_(aux_total, plan.group) / plan.num_micro
    return ybuf, aux_total


class _PipelineFn(torch.autograd.Function):
    """The whole schedule of one pipeline call, forward and backward
    (see the module docstring). Inputs: the plan, the microbatched feed
    [M, mb, ...], and this stage's parameters; outputs: the last stage's
    outputs on every rank, and the aux mean (a zero scalar without
    one)."""

    @staticmethod
    def forward(ctx, plan: _Plan, x_mb: torch.Tensor, *params):
        ybuf, aux = _forward(plan, x_mb, keep=True)
        ctx.plan = plan
        ctx.has_aux = aux is not None
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x_mb.device)
            ctx.mark_non_differentiable(aux)
        return ybuf, aux

    @staticmethod
    def backward(ctx, d_ybuf, d_aux):
        plan = ctx.plan
        sums: List[Optional[torch.Tensor]] = [None] * len(plan.params)
        d_feed = None
        got = None
        for t in reversed(range(plan.ticks)):
            w = plan.work(t)
            dx = None
            if w is not None:
                m, v = w
                inp, y, aux = plan.graphs.pop(t)
                dy = d_ybuf[m] if plan.emits(plan.stage, v) else got
                outs, douts = [y], [dy]
                if ctx.has_aux:
                    outs.append(aux)
                    douts.append((d_aux / plan.num_micro).to(aux.dtype))
                lo, hi = plan.spans[v]
                grads = torch.autograd.grad(
                    outs, [inp] + plan.params[lo:hi], douts,
                    allow_unused=True)
                dx = grads[0]
                for i, g in zip(range(lo, hi), grads[1:]):
                    if g is not None:
                        sums[i] = (g.float() if sums[i] is None
                                   else sums[i].add_(g.float()))
                if plan.stage == 0 and v == 0:
                    if d_feed is None:
                        d_feed = torch.zeros_like(d_ybuf)
                    d_feed[m] = dx
                    dx = None
            if t > 0:
                # dX goes back to the stage that sent the input
                back = [(b, a) for a, b in plan.pairs(t - 1)]
                got = coll.exchange(dx, plan.group, back, d_ybuf[0])
        grads = [None if s is None else s.to(p.dtype)
                 for s, p in zip(sums, plan.params)]
        return (None, d_feed, *grads)


def _tensors(layer) -> List[torch.Tensor]:
    """The trainable tensors of one layer: a module's parameters, or
    the tensors of a (nested) list, tuple or dict."""
    if isinstance(layer, nn.Module):
        return [p for p in layer.parameters() if p.requires_grad]
    if isinstance(layer, torch.Tensor):
        return [layer] if layer.requires_grad else []
    if isinstance(layer, dict):
        return [t for k in sorted(layer) for t in _tensors(layer[k])]
    if isinstance(layer, (list, tuple)):
        return [t for x in layer for t in _tensors(x)]
    return []


@dataclass(frozen=True)
class PipeStage:
    """This rank's stage of a pipeline over a pipe group (None for one
    stage): its ``index`` among ``size`` stages, and the schedule --
    ``num_microbatches``, and ``num_chunks`` chunks a stage (1: GPipe;
    more: the interleaved schedule)."""

    group: Any
    index: int
    size: int
    num_microbatches: int = 4
    num_chunks: int = 1

    def layers(self, n_layers: int) -> List[int]:
        """The global layers this stage holds, chunk by chunk."""
        return stage_layers(n_layers, self.size, self.index,
                            self.num_chunks)

    def owner(self, layer: int, n_layers: int) -> int:
        """The stage that holds ``layer``."""
        return (layer // (n_layers // (self.size * self.num_chunks))
                ) % self.size

    def run(self, blocks: Sequence[Any], x: torch.Tensor, cos, sin,
            attn_fn, remat: str, schedule_stats: bool = False):
        """A model's block stack (``blocks[i]``: layer i's block, this
        stage's at least) as this pipeline on the hidden states ``x``
        [batch, ...], each block under ``remat`` mapped for pipelining:
        (hidden states, aux or None), and with ``schedule_stats`` the
        stats of :func:`interleaved_pipeline_apply`."""
        from dlrover_tpu_torch.models.llama import remat_block

        policy = _REMAT[remat]

        def block_fn(h, block):
            return remat_block(block, policy, h, attn_fn, cos, sin)

        return _apply(block_fn, list(blocks), x, self,
                      schedule_stats=schedule_stats)


def stage_layers(n_layers: int, pp: int, stage: int, num_chunks: int = 1
                 ) -> List[int]:
    """Layers of ``stage``: chunk v of it covers ``[(v*P + s)*K, (v*P +
    s + 1)*K)`` with K = L / (P*V) (GPipe: the contiguous L/P)."""
    k = n_layers // (pp * num_chunks)
    return [i for v in range(num_chunks)
            for i in range((v * pp + stage) * k, (v * pp + stage + 1) * k)]


def pipe_stage(mesh: Mesh, num_microbatches: int = 4, num_chunks: int = 1,
               axis_name: str = PIPE_AXIS) -> Optional[PipeStage]:
    """This rank's :class:`PipeStage` on the mesh axis ``axis_name``, or
    None where the axis is absent or of size 1."""
    pp = axis_size(mesh, axis_name)
    if pp == 1:
        return None
    return PipeStage(axes_group(mesh, (axis_name,)),
                     axis_index(mesh, axis_name), pp, num_microbatches,
                     num_chunks)


def _plain(block_fn, stacked, x):
    """The layers of ``stacked`` one after another: (x, summed aux or
    None)."""
    aux = None
    for layer in stacked:
        x, a = block_fn(x, layer)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _apply(block_fn, stacked: List[Any], x: torch.Tensor,
           stage: PipeStage, schedule_stats: bool = False):
    """The schedule of ``stage`` over the global stack ``stacked`` (its
    own layers' entries used, the others may be None): (output [batch,
    ...], aux or None[, stats])."""
    pp, M, V = stage.size, stage.num_microbatches, stage.num_chunks
    mb = x.shape[0] // M
    x_mb = x.reshape((M, mb) + tuple(x.shape[1:]))
    layers = stage.layers(len(stacked))
    k = len(layers) // V
    chunks = [[stacked[i] for i in layers[v * k:(v + 1) * k]]
              for v in range(V)]
    spans, params = [], []
    for chunk in chunks:
        tensors = [p for layer in chunk for p in _tensors(layer)]
        spans.append((len(params), len(params) + len(tensors)))
        params += tensors
    plan = _Plan(block_fn, chunks, spans, params, stage.group, stage.index,
                 pp, M, V)
    if torch.is_grad_enabled() and (x_mb.requires_grad or any(
            p.requires_grad for p in params)):
        y, aux = _PipelineFn.apply(plan, x_mb, *params)
        aux = aux if aux.requires_grad else None
    else:
        y, aux = _forward(plan, x_mb, keep=False)
    out = (y.reshape(x.shape), aux)
    if not schedule_stats:
        return out
    # the work the stages ran, counted on each and summed over them
    work = torch.tensor(float(plan.worked), device=x.device)
    coll.all_reduce_(work, stage.group)
    slots = pp * plan.ticks
    return out + ({"ticks": plan.ticks, "slots_total": slots,
                   "work_slots_used": int(work.item()),
                   "bubble_measured": 1.0 - work.item() / slots},)


def _check(n_layers: int, batch: int, pp: int, num_microbatches: int,
           num_chunks: int, circular: bool) -> None:
    """JAX's errors of a schedule over ``pp`` stages."""
    if circular:
        if n_layers % (pp * num_chunks):
            raise ValueError(f"{n_layers} layers not divisible by "
                             f"pp*chunks={pp}*{num_chunks}")
        if num_microbatches % pp:
            raise ValueError(
                f"microbatches={num_microbatches} must be a multiple of "
                f"pp={pp} for the circular schedule")
    elif n_layers % pp:
        raise ValueError(f"{n_layers} layers not divisible by pipe={pp}")
    if batch % num_microbatches:
        raise ValueError(f"batch {batch} not divisible by "
                         f"microbatches={num_microbatches}")


def check_schedule(n_layers: int, stage: PipeStage) -> None:
    """JAX's errors of ``stage``'s schedule over ``n_layers`` layers that
    no batch size changes."""
    _check(n_layers, stage.num_microbatches, stage.size,
           stage.num_microbatches, stage.num_chunks,
           circular=stage.num_chunks > 1)


def interleaved_pipeline_apply(
    block_fn: Callable,
    stacked_params: Sequence[Any],
    x: torch.Tensor,
    mesh: Mesh,
    num_microbatches: int,
    num_chunks: int = 2,
    axis_name: str = PIPE_AXIS,
    schedule_stats: bool = False,
) -> Tuple[Any, ...]:
    """The circular/interleaved pipeline over ``axis_name`` with
    ``num_chunks`` chunks a stage: ``block_fn(x, layer) -> (x, aux or
    None)``, ``stacked_params[i]`` layer i's parameters (a module, or
    tensors; only this stage's entries are read, the others may be
    None), ``x`` the whole batch [batch, ...]. Returns (output [batch,
    ...], aux: the mean over microbatches of the blocks' aux summed, or
    None where they return none); with ``schedule_stats`` also {ticks,
    slots_total, work_slots_used, bubble_measured}, the work the ranks
    ran against every (stage, tick) slot. At one stage the plain stack.
    JAX's checks and errors."""
    pp = axis_size(mesh, axis_name)
    if num_chunks < 1:
        raise ValueError("num_chunks >= 1")
    if pp == 1:
        return _plain(block_fn, stacked_params, x)
    _check(len(stacked_params), x.shape[0], pp, num_microbatches,
           num_chunks, circular=True)
    return _apply(block_fn, list(stacked_params), x,
                  pipe_stage(mesh, num_microbatches, num_chunks, axis_name),
                  schedule_stats=schedule_stats)


def gpipe_apply(
    block_fn: Callable,
    stacked_params: Sequence[Any],
    x: torch.Tensor,
    mesh: Mesh,
    num_microbatches: int,
    axis_name: str = PIPE_AXIS,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The blocks as a GPipe pipeline over ``axis_name`` (arguments as
    :func:`interleaved_pipeline_apply`'s): (output [batch, ...], aux or
    None). At one stage the plain stack."""
    pp = axis_size(mesh, axis_name)
    if len(stacked_params) % pp:
        raise ValueError(f"{len(stacked_params)} layers not divisible by "
                         f"pipe={pp}")
    if pp == 1:
        return _plain(block_fn, stacked_params, x)
    _check(len(stacked_params), x.shape[0], pp, num_microbatches, 1,
           circular=False)
    return _apply(block_fn, list(stacked_params), x,
                  pipe_stage(mesh, num_microbatches, 1, axis_name))


def pipeline_llama_forward(
    params, tokens: torch.Tensor, cfg, mesh: Mesh,
    num_microbatches: int = 4, attn_fn=None, return_aux: bool = False,
    num_chunks: int = 1, schedule_stats: bool = False,
):
    """fp32 logits of the Llama ``params`` (a ``models.llama.Llama``
    holding at least this stage's blocks, or the JAX parameter tree as
    numpy, loaded with ``params_from_jax``) on int ``tokens`` [batch,
    seq], the block stack pipelined over the mesh's pipe axis: GPipe, or
    with ``num_chunks > 1`` the interleaved schedule (the model's
    stage view, :meth:`PipeStage.run`). Embed, final norm and
    ``lm_head`` run on every stage; the config's remat ``"dots_attn_out"``
    runs as ``"dots"``. ``return_aux`` also returns the MoE auxiliary
    loss (a zero scalar for a dense model); ``schedule_stats``
    (interleaved only) returns ``(logits, aux, stats)``. JAX's checks
    and errors; at one stage the plain stack."""
    from dlrover_tpu_torch.models import llama

    circular = num_chunks > 1
    if not circular and schedule_stats:
        raise ValueError("schedule_stats needs num_chunks > 1")
    model = (params if isinstance(params, nn.Module)
             else llama.params_from_jax(params, cfg, device=tokens.device))
    chunks = num_chunks if circular else 1
    stage = pipe_stage(mesh, num_microbatches, chunks)
    if stage is not None:
        _check(cfg.num_layers, tokens.shape[0], stage.size,
               num_microbatches, chunks, circular)
    saved = model.pipe_stage
    model.pipe_stage = stage
    try:
        out = model.hidden_states_and_aux(tokens, attn_fn,
                                          schedule_stats=schedule_stats)
    finally:
        model.pipe_stage = saved
    logits = model.lm_head(out[0]).float()
    aux = out[1]
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    if schedule_stats:
        ticks = num_microbatches * chunks
        stats = out[2] if stage is not None else {
            "ticks": ticks, "slots_total": ticks, "work_slots_used": ticks,
            "bubble_measured": 0.0}
        return logits, aux, stats
    if return_aux:
        return logits, aux
    return logits
