"""Bayesian-optimization refinement over the strategy candidate set.

Counterpart of ``dlrover_tpu/auto/bo.py``, copied (it has no JAX): an
exact Gaussian process (numpy Cholesky) over a normalized feature
embedding of the strategy knobs, with expected-improvement acquisition,
so a handful of dryruns stand for the whole candidate set. Observations
are log step-times (multiplicative noise becomes additive); seeding
comes from the analytic ranking (``auto/analyser.py``). Across ranks
every measured time is agreed before it reaches the search
(``auto/accelerate.py``), so every rank's GP sees the same numbers and
picks the same candidates.
"""

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dlrover_tpu_torch.auto.strategy import (
    PRECISIONS,
    REMAT_POLICIES,
    Strategy,
)
from dlrover_tpu_torch.common.log import default_logger as logger


def featurize(s: Strategy) -> np.ndarray:
    """Embed a strategy into R^8 (log-scaled axes + categorical knobs).
    context_parallel is a dimension: ring/ulysses twins of one mesh
    must not embed identically, or the GP treats them as one point
    (duplicate x rows with conflicting y; EI never explores the twin)."""
    cp = {None: 0.0, "ring": 1.0, "ulysses": 2.0}
    return np.array([
        math.log2(max(s.axis("data"), 1)),
        math.log2(max(s.axis("fsdp"), 1)),
        math.log2(max(s.axis("tensor"), 1)),
        math.log2(max(s.axis("seq"), 1) * max(s.axis("expert"), 1)),
        float(REMAT_POLICIES.index(s.remat)),
        float(PRECISIONS.index(s.precision)),
        math.log2(max(s.accum_steps, 1)),
        cp.get(s.context_parallel, 3.0),
    ])


class _GP:
    """Exact GP regression with an RBF kernel on normalized features."""

    def __init__(self, length_scale: float = 1.0, noise: float = 1e-3):
        self._l = length_scale
        self._noise = noise
        self._x: Optional[np.ndarray] = None
        self._alpha: Optional[np.ndarray] = None
        self._chol: Optional[np.ndarray] = None
        self._mean = 0.0

    def _k(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / self._l**2)

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        self._x = x
        self._mean = float(y.mean())
        k = self._k(x, x) + self._noise * np.eye(len(x))
        self._chol = np.linalg.cholesky(k)
        self._alpha = np.linalg.solve(
            self._chol.T, np.linalg.solve(self._chol, y - self._mean)
        )

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        ks = self._k(x, self._x)
        mu = self._mean + ks @ self._alpha
        v = np.linalg.solve(self._chol, ks.T)
        var = np.clip(1.0 - (v**2).sum(0), 1e-12, None)
        return mu, np.sqrt(var)


def _expected_improvement(
    mu: np.ndarray, sigma: np.ndarray, best: float
) -> np.ndarray:
    """EI for MINIMIZATION with the standard-normal closed form."""
    z = (best - mu) / sigma
    phi = np.exp(-0.5 * z**2) / math.sqrt(2 * math.pi)
    big_phi = 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2)))
    return (best - mu) * big_phi + sigma * phi


def bo_search(
    candidates: Sequence[Strategy],
    measure_fn: Callable[[Strategy], float],
    seed_order: Optional[Sequence[Strategy]] = None,
    n_init: int = 3,
    n_iters: int = 5,
) -> Tuple[Strategy, Dict[Strategy, float]]:
    """Find the fastest strategy with few ``measure_fn`` evaluations.

    ``measure_fn(strategy) -> seconds/step`` (may raise: the candidate
    is recorded as infeasible and never retried). ``seed_order`` is the
    analytic ranking used for the initial design (defaults to candidate
    order). Returns (best_strategy, {strategy: measured_seconds}).
    """
    candidates = list(candidates)
    if not candidates:
        raise ValueError("no candidates")
    feats = np.stack([featurize(s) for s in candidates])
    # normalize features to unit scale so one length-scale fits all dims
    span = feats.max(0) - feats.min(0)
    span[span == 0] = 1.0
    feats = (feats - feats.min(0)) / span

    index = {s: i for i, s in enumerate(candidates)}
    measured: Dict[Strategy, float] = {}
    failed: set = set()

    def measure(s: Strategy) -> None:
        if s in measured or s in failed:
            return
        try:
            measured[s] = float(measure_fn(s))
            logger.info(
                "bo measure %s -> %.2f ms", s, measured[s] * 1e3
            )
        except Exception as e:
            failed.add(s)
            logger.warning("bo candidate failed %s: %s", s, e)

    for s in list(seed_order or candidates)[:n_init]:
        if s in index:
            measure(s)
    if not measured:  # every seed failed: walk the rest until one works
        for s in candidates:
            measure(s)
            if measured:
                break
    if not measured:
        raise RuntimeError("all strategy candidates failed to measure")

    for _ in range(n_iters):
        remaining = [
            s for s in candidates
            if s not in measured and s not in failed
        ]
        if not remaining:
            break
        xs = np.stack([feats[index[s]] for s in measured])
        ys = np.log(np.array([measured[s] for s in measured]))
        gp = _GP()
        gp.fit(xs, ys)
        rem_x = np.stack([feats[index[s]] for s in remaining])
        mu, sigma = gp.predict(rem_x)
        ei = _expected_improvement(mu, sigma, float(ys.min()))
        measure(remaining[int(np.argmax(ei))])

    best = min(measured, key=measured.get)
    return best, measured
