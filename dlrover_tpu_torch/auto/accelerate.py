"""auto_accelerate: pick and apply the best acceleration strategy.

Counterpart of ``dlrover_tpu/auto/accelerate.py``: enumerate candidates
(``auto/strategy.py``), rank them with the analytic memory and time
models (``auto/analyser.py``), optionally dry-run the top-k (or let BO,
``auto/bo.py``, pick which) by timing the real train step, and return
the winner's trainer, built through ``models.make_trainer_for``.

The JAX search is one controller: the same deterministic search runs
everywhere and agrees without communication. That holds here for the
analytic ranking (:func:`rank_candidates`, a pure function of the
device count), but each rank is its own process and times its own
dryruns. Were each rank to rank its own timings, the ranks could pick
different winners, build different layouts and hang in their first
collective. So every dryrun's seconds are all-reduced MAX over the
world, and a failure on any rank is a failure on every rank (an
all-reduced flag), before anything ranks them.
"""

import dataclasses
import time
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from dlrover_tpu_torch.auto import strategy as strategy_lib
from dlrover_tpu_torch.auto.analyser import (
    ModelProfile,
    estimate_memory,
    estimate_step_time,
)
from dlrover_tpu_torch.auto.device_context import (
    get_device_context,
    resolve_device,
)
from dlrover_tpu_torch.auto.strategy import (
    Strategy,
    enumerate_strategies,
    envelope_max_seq,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.parallel.mesh import create_mesh

#: dryrun failures that mark a candidate unfit by the card's own limits:
#: out of memory, and a layout that cannot split the model (the flash
#: kernels take whole heads). Any other failure is the program's.
EXPECTED_FAILURES = ("out of memory", "do not split over")


@dataclasses.dataclass
class CandidateReport:
    strategy: Strategy
    memory_bytes: float
    est_step_seconds: float
    measured_step_seconds: Optional[float] = None
    fits: bool = True
    error: Optional[str] = None


@dataclasses.dataclass
class AccelerateResult:
    trainer: object
    strategy: Strategy
    reports: List[CandidateReport]


def world_size() -> int:
    """The ranks of the process group (1 without one): the search's
    device count."""
    return dist.get_world_size() if dist.is_initialized() else 1


def build_trainer(cfg, strategy: Strategy, device=None, optimizer=None):
    """The trainer of one strategy over the world's ranks, for any model
    family (``models.make_trainer_for``): its mesh from
    ``strategy.mesh_spec``, ring or Ulysses attention under
    ``context_parallel``, the config's remat policy replaced by the
    strategy's where the family has one."""
    from dlrover_tpu_torch.models import make_trainer_for

    device = resolve_device(device)
    mesh = create_mesh(list(strategy.mesh_spec), device=device)
    attn_fn = None
    if strategy.context_parallel:
        from dlrover_tpu_torch.parallel.context_parallel import (
            make_context_parallel_attn,
        )

        attn_fn = make_context_parallel_attn(
            mesh, kind=strategy.context_parallel)
    if hasattr(cfg, "remat"):
        cfg = dataclasses.replace(cfg, remat=strategy.remat)
    return make_trainer_for(
        cfg, device=device, strategy=strategy.sharding,
        accum_steps=strategy.accum_steps, optimizer=optimizer,
        attn_fn=attn_fn, mesh=mesh)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _example_batch(trainer, cfg, global_batch: int, seq_len: int):
    """The rank's part of a zero-filled global batch, as microbatches on
    the trainer's device."""
    from dlrover_tpu_torch.models import example_batch

    return trainer.shard_batch(trainer.microbatch(trainer.split_batch(
        example_batch(cfg, global_batch, seq_len))))


def agree(seconds: Optional[float], error: Optional[str], device
          ) -> Tuple[Optional[float], Optional[str]]:
    """One dryrun's result agreed over the world: the seconds all-reduced
    MAX, and a failure on any rank a failure on every rank (this rank's
    error, or that of another). Without a process group, as it is."""
    if world_size() == 1:
        return seconds, error
    flags = torch.tensor([seconds or 0.0, 1.0 if error else 0.0],
                         dtype=torch.float64, device=device)
    dist.all_reduce(flags, op=dist.ReduceOp.MAX)
    if flags[1].item() > 0:
        return None, error or "the dryrun failed on another rank"
    return flags[0].item(), None


def _measure(cfg, strategy: Strategy, global_batch: int, seq_len: int,
             device, steps: int, optimizer) -> float:
    trainer = build_trainer(cfg, strategy, device, optimizer)
    trainer.init(seed=0)
    batch = _example_batch(trainer, cfg, global_batch, seq_len)
    trainer.train_step(batch).item()  # out of the timing: the first step
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = trainer.train_step(batch)
    loss.item()
    _sync(device)
    return (time.perf_counter() - t0) / steps


def dryrun_strategy(cfg, strategy: Strategy, global_batch: int,
                    seq_len: int, device=None, steps: int = 3,
                    optimizer=None) -> float:
    """Time the real train step (parity: DryRunner.profile): one untimed
    step, then ``steps`` timed, the device synchronized on both sides;
    the seconds a step, agreed over the world (:func:`agree`). Raises,
    on every rank, where any rank failed."""
    device = resolve_device(device)
    seconds, error = None, None
    try:
        seconds = _measure(cfg, strategy, global_batch, seq_len, device,
                           steps, optimizer)
    except Exception as e:  # agreed below: every rank raises alike
        error = f"{type(e).__name__}: {e}"
    finally:
        if device.type == "cuda":
            torch.cuda.empty_cache()
    seconds, error = agree(seconds, error, device)
    if error is not None:
        raise RuntimeError(error)
    return seconds


def abstract_bytes(cfg, strategy: Strategy, global_batch: int,
                   seq_len: int, device=None, optimizer=None
                   ) -> Tuple[int, int]:
    """(argument, output) bytes of this rank's train step, from the held
    shapes and dtypes alone (a model on the meta device; nothing is
    allocated): the arguments are the parameters and optimizer state the
    rank keeps and its microbatches; the outputs, the updated
    parameters and state (in place) and the loss."""
    from dlrover_tpu_torch.models import example_batch, meta_model
    from dlrover_tpu_torch.parallel import sharding as shd

    trainer = build_trainer(cfg, strategy, device, optimizer)
    model = meta_model(cfg)
    param_bytes = opt_bytes = 0
    if trainer.sharded:
        axes = trainer._param_axes(model)
    for name, p in model.named_parameters():
        if trainer.sharded:
            lay = trainer._layout(name, trainer._global_shape(name, p),
                                  axes[name])
            if not lay.owned:
                continue
            n = 1
            for a, b in shd.local_slices(lay.store, lay.shape, trainer.mesh):
                n *= b - a
            opt_n = 1
            for a, b in shd.local_slices(lay.opt, lay.shape, trainer.mesh):
                opt_n *= b - a
        else:
            n = opt_n = p.numel()
        param_bytes += n * p.element_size()
        # AdamW's two moments: in the parameter's dtype at one
        # microbatch, fp32 above (Fp32GradAdamW)
        moment = 4 if trainer.accum_steps > 1 else p.element_size()
        opt_bytes += 2 * opt_n * moment
    batch = trainer.microbatch(trainer.split_batch(
        example_batch(cfg, global_batch, seq_len)))
    batch_bytes = sum(x.nbytes for x in batch)  # as shard_batch moves it
    state = param_bytes + opt_bytes
    return state + batch_bytes, state + 4


def dryrun_abstract(cfg, strategy: Strategy, global_batch: int,
                    seq_len: int, device=None, optimizer=None):
    """(argument_bytes, temp_bytes, output_bytes) of one train step
    (parity: the JAX package's AOT memory analysis). Argument and output
    bytes come from the held shapes (:func:`abstract_bytes`). The card
    has no ahead-of-time memory analysis, so the temp bytes come from one
    real step's ``max_memory_allocated``, less the argument bytes: on
    the CPU the call raises."""
    device = resolve_device(device)
    args, out = abstract_bytes(cfg, strategy, global_batch, seq_len, device,
                               optimizer)
    if device.type != "cuda":
        raise RuntimeError(
            "dryrun_abstract's temp bytes are one step's peak on the card; "
            "on the CPU use abstract_bytes for the argument and output bytes")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    trainer = build_trainer(cfg, strategy, device, optimizer)
    trainer.init(seed=0)
    trainer.train_step(_example_batch(trainer, cfg, global_batch,
                                      seq_len)).item()
    peak = torch.cuda.max_memory_allocated(device) - base
    del trainer
    torch.cuda.empty_cache()
    return args, max(0, peak - args), out


def rank_candidates(cfg, global_batch: int, seq_len: int, num_devices: int,
                    strategies: Optional[List[Strategy]], hbm: float,
                    mfu_guess: float, peak_flops: float,
                    link_bandwidth: float
                    ) -> Tuple[List[CandidateReport], List[CandidateReport]]:
    """The analytic ranking, a pure function of the device count:
    (every candidate's report, the fitting ones fastest first).
    Candidates: ``strategies``, or the enumeration for ``num_devices``
    with the remat twins of a family without ``remat`` collapsed, DLRM's
    rowwise layouts added, Ulysses kept where the Q heads divide by the
    seq axis; a candidate fits under 0.9 x ``hbm`` and, for an attention
    model, within the single-card envelope
    (``strategy.envelope_max_seq``). Where nothing fits, the least
    memory-hungry one stands."""
    profile = ModelProfile.from_config(cfg, seq_len)
    candidates = strategies or enumerate_strategies(
        num_devices, global_batch,
        # past the measured single-card envelope no per-card layout
        # holds the sequence: sequence-parallel candidates join
        context_lengths_long=seq_len > strategy_lib.SINGLE_CHIP_MAX_SEQ,
        num_experts=getattr(cfg, "num_experts", 0),
    )
    if not hasattr(cfg, "remat") and not strategies:
        # remat variants build identical trainers for families without a
        # remat field: one per effective layout
        seen_eff = set()
        collapsed = []
        for s in candidates:
            key = (s.mesh_spec, s.sharding, s.accum_steps,
                   s.context_parallel)
            if key in seen_eff:
                continue
            seen_eff.add(key)
            collapsed.append(s)
        candidates = collapsed
    if type(cfg).__name__ == "DLRMConfig":
        # the recommender's natural layout: table rows over fsdp, batch
        # over data only, for every (data, fsdp) mesh of the set
        extra = []
        seen = {(s.mesh_spec, s.sharding, s.remat, s.accum_steps)
                for s in candidates}
        for s in candidates:
            sizes = dict(s.mesh_spec)
            if sizes.get("tensor", 1) > 1 or s.sharding == "rowwise":
                continue
            spec = tuple(
                (n, v) for n, v in s.mesh_spec if n != "tensor"
            ) or (("data", num_devices),)
            cand = Strategy(mesh_spec=spec, sharding="rowwise",
                            remat=s.remat, accum_steps=s.accum_steps)
            key = (cand.mesh_spec, cand.sharding, cand.remat,
                   cand.accum_steps)
            if key not in seen:
                seen.add(key)
                extra.append(cand)
        candidates = list(candidates) + extra
    if not strategies:
        # Ulysses reshards Q heads over the seq axis: drop the candidates
        # whose Q-head count does not divide by it
        q_heads = getattr(cfg, "num_heads", 0)
        candidates = [
            s for s in candidates
            if s.context_parallel != "ulysses"
            or (q_heads and q_heads % max(s.axis("seq"), 1) == 0)
        ]
    # the measured envelope: attention models, enumerated candidates only
    # (an explicit list is the caller's to rank as given)
    seq_cap = (
        envelope_max_seq(profile.hidden_size, profile.num_layers)
        if getattr(cfg, "num_heads", 0) and strategies is None
        else float("inf")
    )
    reports: List[CandidateReport] = []
    for s in candidates:
        if s.num_devices != num_devices:
            continue
        mem = estimate_memory(profile, s, global_batch, seq_len)
        t = estimate_step_time(
            profile, s, global_batch, seq_len, peak_flops=peak_flops,
            mfu=mfu_guess, link_bandwidth=link_bandwidth,
        )
        per_chip_seq = seq_len / max(s.axis("seq"), 1)
        reports.append(CandidateReport(
            s, mem.total, t,
            fits=(mem.total < 0.9 * hbm and per_chip_seq <= seq_cap),
        ))
    fitting = [r for r in reports if r.fits]
    if not fitting:
        fitting = sorted(reports, key=lambda r: r.memory_bytes)[:1]
        if not fitting:
            raise ValueError(
                f"no strategy candidates for {num_devices} devices")
    fitting.sort(key=lambda r: r.est_step_seconds)
    return reports, fitting


def auto_accelerate(
    cfg,
    global_batch: int,
    seq_len: int,
    device=None,
    strategies: Optional[List[Strategy]] = None,
    dryrun_top_k: int = 0,
    bo_iters: int = 0,
    load_strategy_path: Optional[str] = None,
    optimizer=None,
    hbm_bytes: Optional[float] = None,
    mfu_guess: float = 0.4,
    job_name: Optional[str] = None,
    brain_client=None,
) -> AccelerateResult:
    """Pick the best strategy for ``cfg`` over the world's ranks on
    ``device`` (None: the GPU) and return its ready-to-init trainer
    (parity: auto_accelerate, with the load fast path). Every rank of
    the process group calls it alike, and every rank returns the same
    strategy: the ranking is analytic, and the dryruns' times and
    failures are agreed over the world.

    With ``job_name`` and ``brain_client`` (an object with
    ``get_job_runs``, ``get_strategy`` and ``report_strategy``) the
    search warm-starts from the archived winner of earlier runs (two
    dryruns: it and the analytic top-1), and every search archives its
    winner."""
    device = resolve_device(device)
    num_devices = world_size()
    if load_strategy_path:
        strategy = strategy_lib.load_strategy(load_strategy_path)
        strategy = adjust_strategy(strategy, num_devices, global_batch)
        trainer = build_trainer(cfg, strategy, device, optimizer)
        return AccelerateResult(trainer, strategy, [])

    ctx = get_device_context(device)
    reports, fitting = rank_candidates(
        cfg, global_batch, seq_len, num_devices, strategies,
        hbm_bytes or ctx.hbm_bytes, mfu_guess, ctx.peak_flops,
        ctx.link_bandwidth)

    def dryrun(s):
        return dryrun_strategy(cfg, s, global_batch, seq_len, device,
                               optimizer=optimizer)

    if brain_client is not None and job_name:
        warm = _try_warm_start(cfg, dryrun, num_devices, global_batch,
                               fitting, job_name, brain_client, device,
                               optimizer, reports)
        if warm is not None:
            return warm
        # warm-start dryruns may have disqualified candidates: never fall
        # through onto one of those
        fitting = [r for r in fitting if r.fits] or sorted(
            reports, key=lambda r: r.memory_bytes)[:1]

    if bo_iters > 0:
        from dlrover_tpu_torch.auto.bo import bo_search

        by_strategy = {r.strategy: r for r in fitting}

        def measure(s):
            try:
                return dryrun(s)
            except Exception as e:  # disqualified, as under top-k
                by_strategy[s].fits = False
                by_strategy[s].error = str(e)[:200]
                raise

        best_s, measured = bo_search(
            [r.strategy for r in fitting], measure,
            seed_order=[r.strategy for r in fitting],
            n_init=max(dryrun_top_k, 2), n_iters=bo_iters,
        )
        for s, t in measured.items():
            by_strategy[s].measured_step_seconds = t
        best = by_strategy[best_s]
        logger.info(
            "auto_accelerate (BO, %d measured) picked %s (%.1f ms/step)",
            len(measured), best.strategy,
            best.measured_step_seconds * 1e3)
        _archive_winner(brain_client, job_name, best.strategy,
                        best.measured_step_seconds)
        trainer = build_trainer(cfg, best.strategy, device, optimizer)
        return AccelerateResult(trainer, best.strategy, reports)

    if dryrun_top_k > 0:
        for r in fitting[:dryrun_top_k]:
            try:
                r.measured_step_seconds = dryrun(r.strategy)
                logger.info("dryrun %s: %.1f ms", r.strategy,
                            r.measured_step_seconds * 1e3)
            except Exception as e:  # OOM / build failure disqualifies
                r.fits, r.error = False, str(e)[:200]
                logger.warning("dryrun failed for %s: %s", r.strategy, e)
        measured = [r for r in fitting[:dryrun_top_k]
                    if r.measured_step_seconds is not None]
        if measured:
            measured.sort(key=lambda r: r.measured_step_seconds)
            best = measured[0]
        else:
            best = fitting[0]
    else:
        best = fitting[0]
    logger.info(
        "auto_accelerate picked %s (est %.1f ms/step, mem %.1f GB)",
        best.strategy, best.est_step_seconds * 1e3,
        best.memory_bytes / 1e9)
    _archive_winner(brain_client, job_name, best.strategy,
                    best.measured_step_seconds)
    trainer = build_trainer(cfg, best.strategy, device, optimizer)
    return AccelerateResult(trainer, best.strategy, reports)


def warm_start_strategies(client, job_name: str) -> List[dict]:
    """Archived winning strategies of ``job_name``, best-measured first
    (each ``{"strategy_json", "measured_seconds"}``): a copy of the JAX
    package's ``brain/algorithms.warm_start_strategies``."""
    out = []
    for uuid in client.get_job_runs(job_name):
        doc = client.get_strategy(job_name, uuid)
        if doc and doc.get("strategy_json"):
            out.append(doc)
    out.sort(key=lambda d: d.get("measured_seconds") or float("inf"))
    return out


def _archive_winner(brain_client, job_name, strategy: Strategy,
                    measured: Optional[float]) -> None:
    if brain_client is None or not job_name:
        return
    try:
        import uuid as _uuid

        from dlrover_tpu_torch.master.stats.reporter import JobMeta

        brain_client.report_strategy(
            JobMeta(uuid=_uuid.uuid4().hex[:12], name=job_name),
            strategy.to_json(), measured)
    except Exception as e:  # an archive failure must not fail training
        logger.warning("strategy archive failed: %s", e)


def _try_warm_start(cfg, dryrun, num_devices, global_batch, fitting,
                    job_name, brain_client, device, optimizer, reports
                    ) -> Optional[AccelerateResult]:
    """Re-validate the archived winner against the analytic top-1 (two
    dryruns instead of a cold sweep); None: no usable archive, run the
    cold search."""
    archived = warm_start_strategies(brain_client, job_name)
    if not archived:
        return None
    try:
        saved = Strategy.from_json(archived[0]["strategy_json"])
        saved = adjust_strategy(saved, num_devices, global_batch)
    except Exception as e:
        logger.warning("archived strategy unusable: %s", e)
        return None
    by_strategy = {r.strategy: r for r in fitting}
    if saved not in by_strategy:
        logger.info("archived strategy %s no longer fits this fleet; cold "
                    "search", saved)
        return None
    contenders = [saved]
    if fitting[0].strategy != saved:
        contenders.append(fitting[0].strategy)
    measured: List[Tuple[Strategy, float]] = []
    for s in contenders:
        try:
            t = dryrun(s)
            by_strategy[s].measured_step_seconds = t
            measured.append((s, t))
        except Exception as e:
            by_strategy[s].fits = False
            by_strategy[s].error = str(e)[:200]
            logger.warning("warm-start dryrun failed for %s: %s", s, e)
    if not measured:
        return None
    best_s, best_t = min(measured, key=lambda st: st[1])
    logger.info("auto_accelerate warm start (%d dryruns) picked %s "
                "(%.1f ms/step)", len(measured), best_s, best_t * 1e3)
    _archive_winner(brain_client, job_name, best_s, best_t)
    trainer = build_trainer(cfg, best_s, device, optimizer)
    return AccelerateResult(trainer, best_s, reports)


def adjust_strategy(strategy: Strategy, num_devices: int,
                    global_batch: int) -> Strategy:
    """Refit a saved strategy to the current device count (parity:
    adjust_strategy): the data-parallel dim absorbs the change, the
    model-parallel dims are kept."""
    model_axes = [(a, s) for a, s in strategy.mesh_spec if a != "data"]
    model_size = 1
    for _, s in model_axes:
        model_size *= s
    if num_devices % model_size:
        raise ValueError(
            f"saved strategy needs a multiple of {model_size} devices, "
            f"have {num_devices}")
    data = num_devices // model_size
    return dataclasses.replace(
        strategy, mesh_spec=tuple([("data", data)] + model_axes))
