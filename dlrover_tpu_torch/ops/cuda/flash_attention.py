"""Flash attention on hand-written Hopper kernels: forward, dQ, dK/dV.

Counterpart of ``dlrover_tpu/ops/pallas/flash_attention.py``. The three
Pallas TPU kernels (``_fwd_kernel``, ``_dq_kernel``, ``_dkv_kernel``)
are CUDA C++ for sm_90a in ``csrc/`` (built by ``build.py`` at first
use); beside each kernel's wrapper is its plain PyTorch version, which
writes out the same equations and which the wrapper takes only for a
tensor on the CPU. On a CUDA tensor a wrapper launches its kernel or
raises.

Layouts stay the models' own: q, o, dO are ``[batch, seq, heads, d]``,
k, v ``[batch, seq, kv_heads, d]``, and query head i reads kv head
``i // (heads // kv_heads)`` with no repeat. lse and delta are fp32
``[batch, heads, seq]``; the TPU kernels' ``[b*kvh, g, 1, seq]`` shape
was a tiling artifact.

``RingFlashAttentionFn`` runs the same three kernels per chunk of a
sequence split over ranks (``parallel/context_parallel.py``'s ring
attention): the forward kernel causal on the diagonal chunk and
non-causal on an earlier one, and the backward kernels given the lse
and delta of the merged output.

Numerics follow the TPU kernels: S = Q K^T from bf16 operands into fp32
times ``scale``, masked to ``NEG_INF``; P rounded to the value dtype
before P V, dS to the key/query dtype before dS K and dS^T Q, P before
P^T dO; ``scale`` applied once to dQ and dK at the end; l = 0 read as 1.
"""

from typing import Dict, Optional, Tuple

import torch

from dlrover_tpu_torch.ops.cuda import schedule
from dlrover_tpu_torch.ops.cuda.build import load_library
from dlrover_tpu_torch.trainer.distributed import ppermute

NEG_INF = -1e30
#: kernel launches per kernel, counted where each wrapper launches
LAUNCHES: Dict[str, int] = {"fwd": 0, "dq": 0, "dkv": 0}
#: the same launches by (kernel, (b, s, h, kvh, d), causal)
SHAPE_LAUNCHES: Dict[tuple, int] = {}
#: head dims the kernels are built for (template instances in csrc/)
KERNEL_HEAD_DIMS = (64, 128)
#: the sequence must be a multiple of this, as in the JAX package's
#: ``_use_pallas`` gate (and the kernels' 128-row tiles)
KERNEL_SEQ_MULTIPLE = 128
#: work lists on the device, by (kernel, shape, causal, SMs, device)
_SCHEDULES: Dict[tuple, Tuple[torch.Tensor, int]] = {}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    SHAPE_LAUNCHES.clear()


def _count(kernel: str, q, k, causal: bool) -> None:
    LAUNCHES[kernel] += 1
    key = (kernel, _dims(q, k), bool(causal))
    SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + 1


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path, and the kernels' yardstick on the card)

def _grouped(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """[b, s, h, d] -> fp32 [b, s, kvh, g, d]."""
    b, s, h, d = x.shape
    return x.float().reshape(b, s, kvh, h // kvh, d)


def _scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """fp32 S = Q K^T * scale, masked: [b, kvh, g, q_len, kv_len]."""
    s = torch.einsum(
        "bqhgd,bkhd->bhgqk", _grouped(q, k.shape[2]), k.float()
    ) * scale
    if causal:
        qlen, klen = q.shape[1], k.shape[1]
        keep = torch.ones(
            qlen, klen, dtype=torch.bool, device=q.device
        ).tril(klen - qlen)
        s = s.masked_fill(~keep, NEG_INF)
    return s


def _rows(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """[b, h, s] -> [b, kvh, g, s, 1], to broadcast over score rows."""
    b, h, s = x.shape
    return x.reshape(b, kvh, h // kvh, s, 1)


def fwd_plain(q, k, v, causal: bool, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o like q, lse fp32 [b, h, s]) -- the equations of ``_fwd_kernel``
    with the softmax taken over the whole row at once."""
    b, s_len, h, d = q.shape
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    o = (o / l_safe).permute(0, 3, 1, 2, 4).reshape(b, s_len, h, d)
    lse = (m + torch.log(l_safe))[..., 0].reshape(b, h, s_len)
    return o.to(q.dtype), lse


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(O * dO) in fp32, [b, h, s] (the JAX package also
    computes it outside its kernels)."""
    return (o.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _bwd_terms(q, k, v, do, lse, delta, causal, scale):
    """(P, dS) of the backward, fp32 [b, kvh, g, q_len, kv_len]."""
    kvh = k.shape[2]
    p = torch.exp(_scores(q, k, causal, scale) - _rows(lse, kvh))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", _grouped(do, kvh), v.float())
    return p, p * (dp - _rows(delta, kvh))


def dq_plain(q, k, v, do, lse, delta, causal: bool, scale: float
             ) -> torch.Tensor:
    """dQ like q -- the equations of ``_dq_kernel``."""
    _, ds = _bwd_terms(q, k, v, do, lse, delta, causal, scale)
    dq = torch.einsum(
        "bhgqk,bkhd->bqhgd", ds.to(k.dtype).float(), k.float()
    ) * scale
    return dq.reshape(q.shape).to(q.dtype)


def dkv_plain(q, k, v, do, lse, delta, causal: bool, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK like k, dV like v) -- the equations of ``_dkv_kernel``; the
    contraction over g sums the GQA group."""
    kvh = k.shape[2]
    p, ds = _bwd_terms(q, k, v, do, lse, delta, causal, scale)
    dv = torch.einsum(
        "bhgqk,bqhgd->bkhd", p.to(do.dtype).float(), _grouped(do, kvh)
    )
    dk = torch.einsum(
        "bhgqk,bqhgd->bkhd", ds.to(q.dtype).float(), _grouped(q, kvh)
    ) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers

def shape_error(q_shape, k_shape) -> Optional[str]:
    """Why the kernels do not take q ``[b, s, h, d]`` with k, v ``[b, s,
    kvh, d]``, or None when they do. The one shape gate: the wrappers
    raise ValueError with this message, and ``ops.attention`` reads it to
    choose the plain versions or ``mha_reference`` for CPU tensors."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        return (f"want q [b, s, h, d] and k, v [b, s, kvh, d]; got "
                f"{tuple(q_shape)}, {tuple(k_shape)}")
    b, s, h, d = q_shape
    if (k_shape[0] != b or k_shape[1] != s or k_shape[3] != d
            or h % k_shape[2]):
        return (f"k/v {tuple(k_shape)} do not match q {tuple(q_shape)} "
                f"(kv_len must equal q_len)")
    if d not in KERNEL_HEAD_DIMS or s % KERNEL_SEQ_MULTIPLE:
        return (f"head_dim {d} (want one of {KERNEL_HEAD_DIMS}) or seq {s} "
                f"(want a multiple of {KERNEL_SEQ_MULTIPLE}) not supported "
                f"by the kernels")
    return None


def _check(q, k, v, **extra) -> None:
    """Raise ValueError on anything the kernels do not take."""
    named = {"q": q, "k": k, "v": v, **extra}
    dev = q.device
    for name, t in named.items():
        want = torch.float32 if name in ("lse", "delta") else torch.bfloat16
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != want:
            raise ValueError(f"{name} is {t.dtype}; the kernel takes {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    err = shape_error(q.shape, k.shape)
    if err is not None:
        raise ValueError(err)
    b, s, h, _ = q.shape
    if "do" in extra and extra["do"].shape != q.shape:
        raise ValueError("do must be shaped like q")
    for name in ("lse", "delta"):
        if name in extra and tuple(extra[name].shape) != (b, h, s):
            raise ValueError(f"{name} must be [b, h, s] = {(b, h, s)}")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"flash {kernel} kernel: CUDA error {err}")


def _dims(q, k):
    b, s, h, d = q.shape
    return b, s, h, k.shape[2], d


def _stream(t: torch.Tensor) -> int:
    """The current stream of t's device (launches run under that device
    too, so a tensor on another GPU than the current one works)."""
    return torch.cuda.current_stream(t.device).cuda_stream


def _schedule(kind: str, costs, key: tuple, device: torch.device
              ) -> Tuple[torch.Tensor, int]:
    """(int32 work list on ``device``, CTAs) for ``costs``, built once
    per shape: ``schedule.lpt`` over one CTA per SM."""
    workers = torch.cuda.get_device_properties(device).multi_processor_count
    cache_key = (kind, key, workers, device)
    if cache_key not in _SCHEDULES:
        costs = costs()
        sched = schedule.lpt(costs, workers)
        _SCHEDULES[cache_key] = (
            torch.tensor(sched, dtype=torch.int32, device=device),
            len(sched) - len(costs) - 1)
    return _SCHEDULES[cache_key]


def fwd(q, k, v, causal: bool, scale: float
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): the forward kernel on CUDA tensors, ``fwd_plain`` on the
    CPU."""
    if not q.is_cuda:
        return fwd_plain(q, k, v, causal, scale)
    _check(q, k, v)
    if not scale > 0:  # the kernel takes the row max on unscaled scores
        raise ValueError(f"scale {scale}: the forward kernel takes scale > 0")
    b, s, h, kvh, d = _dims(q, k)
    o = torch.empty_like(q)
    lse = torch.empty(b, h, s, device=q.device, dtype=torch.float32)
    sched, n_ctas = _schedule(
        "fwd", lambda: schedule.fwd_costs(b, s, h, causal),
        (b, s, h, causal), q.device)
    with torch.cuda.device(q.device):
        err = load_library().flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, s, h, kvh, d, float(scale), int(causal),
            sched.data_ptr(), n_ctas, _stream(q),
        )
    _raise_on(err, "fwd")
    _count("fwd", q, k, causal)
    return o, lse


def dq(q, k, v, do, lse, delta, causal: bool, scale: float
       ) -> torch.Tensor:
    """dQ: the dQ kernel on CUDA tensors, ``dq_plain`` on the CPU."""
    if not q.is_cuda:
        return dq_plain(q, k, v, do, lse, delta, causal, scale)
    _check(q, k, v, do=do, lse=lse, delta=delta)
    b, s, h, kvh, d = _dims(q, k)
    out = torch.empty_like(q)
    sched, n_ctas = _schedule(
        "dq", lambda: schedule.dq_costs(b, s, h, causal),
        (b, s, h, causal), q.device)
    with torch.cuda.device(q.device):
        err = load_library().flash_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), out.data_ptr(),
            b, s, h, kvh, d, float(scale), int(causal), sched.data_ptr(),
            n_ctas, _stream(q),
        )
    _raise_on(err, "dq")
    _count("dq", q, k, causal)
    return out


def dkv(q, k, v, do, lse, delta, causal: bool, scale: float
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV): the dK/dV kernel on CUDA tensors, ``dkv_plain`` on the
    CPU."""
    if not q.is_cuda:
        return dkv_plain(q, k, v, do, lse, delta, causal, scale)
    _check(q, k, v, do=do, lse=lse, delta=delta)
    b, s, h, kvh, d = _dims(q, k)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    parts = schedule.dkv_parts(h, kvh)
    sched, n_ctas = _schedule(
        "dkv", lambda: schedule.dkv_costs(b, s, h, kvh, causal, parts),
        (b, s, h, kvh, causal, parts), q.device)
    # fp32 partials of the group's parts, summed by the kernel's second pass
    partial = (torch.empty((2, parts) + tuple(k.shape), device=q.device,
                           dtype=torch.float32) if parts > 1 else None)
    with torch.cuda.device(q.device):
        err = load_library().flash_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, s, h, kvh, d, float(scale), int(causal), sched.data_ptr(),
            n_ctas, parts, 0 if partial is None else partial.data_ptr(),
            _stream(q),
        )
    _raise_on(err, "dkv")
    _count("dkv", q, k, causal)
    return dk, dv


# ---------------------------------------------------------------------------
# autograd

class FlashAttentionFn(torch.autograd.Function):
    """Forward kernel; backward = delta, then the dQ and dK/dV kernels.
    Saves (q, k, v, o, lse), as the JAX package's custom VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = attention_delta(o, do)
        args = (q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        dk, dv = dkv(*args)
        return dq(*args), dk, dv, None, None


def flash_attention_cuda(
    q: torch.Tensor,  # [batch, seq, heads, head_dim]
    k: torch.Tensor,  # [batch, seq, kv_heads, head_dim]
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention in the models' layout through the three kernels
    (their plain versions for CPU tensors); differentiable."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return FlashAttentionFn.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), causal, scale
    )


# ---------------------------------------------------------------------------
# ring attention: the kernels per chunk of a sequence split over ranks

def _chunk_case(q_start: int, k_start: int, s_loc: int, causal: bool
                ) -> str:
    """How ``s_loc`` queries from position ``q_start`` see the ``s_loc``
    keys from ``k_start`` under the global mask: ``"causal"`` (the same
    positions: the causal kernel), ``"full"`` (every key before every
    query, or no mask: the non-causal kernel) or ``"masked"`` (every key
    after every query: no launch, an lse of NEG_INF)."""
    if not causal or k_start + s_loc <= q_start:
        return "full"
    if k_start == q_start:
        return "causal"
    if k_start >= q_start + s_loc:
        return "masked"
    raise ValueError(f"chunks at {q_start} and {k_start} of {s_loc} "
                     "positions overlap in part")


class RingFlashAttentionFn(torch.autograd.Function):
    """Ring attention over ``group`` with the three kernels per chunk,
    the JAX package's ``_ring_local`` (``parallel/context_parallel.py``)
    in one Function, so that every rank issues its ppermutes in the
    same fixed order, whichever chunks it skips.

    The forward holds this rank's queries (positions from ``q_start``)
    and, at ring step r, the K/V chunk whose positions start at
    ``k_starts[r]``: the forward kernel on it (causal on the diagonal,
    non-causal on an earlier chunk, no launch on a later one), each
    chunk's (o, lse) folded into running fp32 accumulators with JAX's
    NEG_INF-safe weights, K/V (kvh-sized, stacked into one message)
    shifted one rank on. It saves the merged output and its lse. The
    backward runs the ring again: per chunk the dQ and dK/dV kernels,
    given the merged lse and delta = rowsum(dO * O) of the merged
    output; each chunk's fp32 dK/dV sum travels with the chunk and is
    shifted home after the last step."""

    @staticmethod
    def forward(ctx, q, k, v, group, q_start: int, k_starts, causal: bool,
                scale: float):
        b, s_loc, h, d = q.shape
        num = torch.zeros(b, s_loc, h, d, device=q.device,
                          dtype=torch.float32)
        den = torch.zeros(b, h, s_loc, device=q.device, dtype=torch.float32)
        m_run = torch.full_like(den, NEG_INF)
        kv = torch.stack([k, v])
        for r, k_start in enumerate(k_starts):
            case = _chunk_case(q_start, k_start, s_loc, causal)
            if case != "masked":
                o_r, lse_r = fwd(q, kv[0], kv[1], case == "causal", scale)
                m_new = torch.maximum(m_run, lse_r)
                alpha = torch.where(m_run <= NEG_INF, 0.0,
                                    torch.exp(m_run - m_new))
                w = torch.where(lse_r <= NEG_INF, 0.0,
                                torch.exp(lse_r - m_new))
                num = (num * alpha.transpose(1, 2)[..., None]
                       + o_r.float() * w.transpose(1, 2)[..., None])
                den = den * alpha + w
                m_run = m_new
            if r + 1 < len(k_starts):
                kv = ppermute(kv, group, 1)
        den = torch.where(den == 0.0, 1.0, den)
        out = (num / den.transpose(1, 2)[..., None]).to(q.dtype)
        lse = (m_run + torch.log(den)).contiguous()
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (group, q_start, tuple(k_starts), causal, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, q_start, k_starts, causal, scale = ctx.ring
        s_loc = q.shape[1]
        do = do.contiguous()
        delta = attention_delta(out, do)
        dq_sum = torch.zeros_like(q, dtype=torch.float32)
        kv = torch.stack([k, v])
        dkv_sum = torch.zeros_like(kv, dtype=torch.float32)
        for r, k_start in enumerate(k_starts):
            case = _chunk_case(q_start, k_start, s_loc, causal)
            if case != "masked":
                args = (q, kv[0], kv[1], do, lse, delta, case == "causal",
                        scale)
                dq_sum += dq(*args).float()
                dk_r, dv_r = dkv(*args)
                dkv_sum[0] += dk_r.float()
                dkv_sum[1] += dv_r.float()
            if r + 1 < len(k_starts):
                kv = ppermute(kv, group, 1)
            dkv_sum = ppermute(dkv_sum, group, 1)
        return (dq_sum.to(q.dtype), dkv_sum[0].to(k.dtype),
                dkv_sum[1].to(v.dtype),
                None, None, None, None, None)


def ring_flash_attention(q, k, v, group, q_start: int, k_starts,
                         causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """:class:`RingFlashAttentionFn` on this rank's q ``[b, s_loc, h, d]``
    and K/V chunk ``[b, s_loc, kvh, d]``: ``k_starts[r]`` is the first
    position of the chunk it holds at ring step r (one step per rank of
    ``group``). The kernels on CUDA tensors, their plain versions on the
    CPU; differentiable."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return RingFlashAttentionFn.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), group, q_start,
        tuple(k_starts), causal, scale)
