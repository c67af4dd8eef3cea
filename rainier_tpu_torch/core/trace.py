"""Posterior trace: storage and convergence diagnostics (port of
rainier_tpu/core/trace.py, counterpart of core/Trace.scala).

rHat and effective sample size follow the Stan manual §30.3/30.4
equations exactly as the reference does (Trace.scala:49-120), vectorized
over all parameters.  This slice ports the float64 host pipeline, which
is numpy/scipy and a verbatim copy (rainier_tpu/core/trace.py:82-165);
the device pipeline and ``predict`` come in a later slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from ..compute import interp
from ..compute import real as R
from ..compute.compiler import bind_lane_columns, find_columns


class Diagnostics(NamedTuple):
    r_hat: float
    effective_sample_size: float


def _variogram(chains: np.ndarray, max_lag: int) -> np.ndarray:
    """(max_lag, k) variogram Var_t(l) = Σ_{m,t} (x_{t+l} − x_t)² /
    (m·(n−l)) — the Stan-manual estimator, computed from lagged cross
    products instead of one full O(m·n·k) pass per lag (identical
    values: Σ(x_{t+l}−x_t)² = head(l) + tail(l) − 2·Σ x_t·x_{t+l}).
    The cross terms for all lags at once are a batched (1, n)·(n, L+1)
    matmul over a zero-padded sliding-window view — BLAS, one data pass.

    The variogram is shift-invariant, so each parameter is centered by
    its pooled mean (in float64) before the cross-product pass and all
    accumulation runs in float64: uncentered, the head+tail−2·cross
    subtraction cancels catastrophically for concentrated posteriors
    (|mean|/sd ≳ 300 gave ≥8% error in f32 — round-3 advisor finding)."""
    from numpy.lib.stride_tricks import sliding_window_view

    m, n, k = chains.shape
    mu = chains.mean(axis=(0, 1), dtype=np.float64)   # (k,)
    ls = np.arange(1, max_lag + 1)
    cross = np.zeros((max_lag, k))
    head = np.zeros((max_lag, k))
    tail = np.zeros((max_lag, k))
    # chunk chains to bound the workspace; time on the last (contiguous)
    # axis
    chunk = max(1, int(16e6) // (n * k))
    for a in range(0, m, chunk):
        x = np.swapaxes(chains[a:a + chunk], 1, 2).astype(np.float64)
        x -= mu[None, :, None]                        # (mc, k, n) centered
        xp = np.concatenate(
            [x, np.zeros(x.shape[:-1] + (max_lag,), x.dtype)], axis=-1)
        xw = sliding_window_view(xp, max_lag + 1, axis=-1)  # (mc,k,n,L+1)
        cp = np.matmul(x[..., None, :], xw)           # (mc, k, 1, L+1)
        cross += cp[..., 0, 1:].sum(axis=0).T         # Σ_t x_t·x_{t+l}
        c = np.cumsum(np.square(x), axis=-1)
        head += c[..., n - ls - 1].sum(axis=0).T      # Σ_{t<n−l} x²_t
        tail += (c[..., -1][..., None] - c[..., ls - 1]).sum(axis=0).T
    return (head + tail - 2.0 * cross) / (m * (n - ls)[:, None])


def _diagnostics_all(chains: np.ndarray, max_lag: int = 100):
    """chains: (m, n, k) → per-parameter (r_hat, ess), Stan manual
    §30.3/30.4 (Trace.scala:61-120)."""
    m, n, k = chains.shape
    means = chains.mean(axis=1)                      # (m, k)
    mean_mean = means.mean(axis=0)                   # (k,)
    b = n / (m - 1) * ((means - mean_mean) ** 2).sum(axis=0)
    variances = ((chains - means[:, None, :]) ** 2).sum(axis=1) / (n - 1)
    w = variances.mean(axis=0)
    v = (n - 1) / n * w + b / n
    r_hat = np.sqrt(v / np.maximum(w, 1e-300))

    max_lag = min(max_lag, n - 1)
    vt = _variogram(chains, max_lag)
    pts = 1.0 - vt / (2.0 * np.maximum(v, 1e-300))
    # accumulate while pt > 0 (reference's early-termination criterion)
    alive = np.cumprod(pts > 0.0, axis=0).astype(bool)
    ac = (pts * alive).sum(axis=0)
    ess = n * m / (1 + 2 * ac)
    return r_hat, ess


def _split_chains(chains: np.ndarray) -> np.ndarray:
    """(m, n, k) → (2m, n//2, k): split each chain in half so r̂ also
    detects within-chain non-stationarity (Vehtari et al. 2021 §3.1)."""
    m, n, k = chains.shape
    half = n // 2
    return np.concatenate([chains[:, :half], chains[:, half:2 * half]],
                          axis=0)


def _rank_normalize(chains: np.ndarray) -> np.ndarray:
    """Pooled fractional ranks → normal scores z = Φ⁻¹((r−3/8)/(S+1/4))
    (Vehtari et al. 2021 eq. 14); makes r̂/ESS robust to heavy tails.

    Ranks are computed in float64 regardless of the chains' dtype (f32
    integer ranks collide past 2^24 draws) with average ranks on ties,
    matching Vehtari et al.'s definition."""
    from scipy.special import ndtri
    from scipy.stats import rankdata

    m, n, k = chains.shape
    flat = chains.reshape(m * n, k)
    ranks = rankdata(flat, method="average", axis=0).astype(np.float64)
    z = ndtri((ranks - 0.375) / (m * n + 0.25))
    return z.reshape(m, n, k).astype(np.float64)



class TraceSummary(NamedTuple):
    """Host-side posterior summary (small arrays; see Trace.summary)."""

    mean: np.ndarray       # (k,)
    sd: np.ndarray         # (k,)
    quantiles: np.ndarray  # (q, k)
    probs: tuple           # the q quantile probabilities
    n_draws: int           # pooled draws the moments were computed over


def _to_numpy(tree):
    """NamedTuple of tensors (or None) → the same NamedTuple of arrays."""
    if tree is None:
        return None
    return type(tree)(*[None if x is None else x.detach().cpu().numpy()
                        for x in tree])


class Trace:
    def __init__(self, chains, model, compiled, config,
                 mass=None, stats=None, warmup_stats=None, step_size=None,
                 collect_idx=None, walltime: Optional[float] = None,
                 final_q=None):
        #: (n_chains, n_iters, n_collect) host draws
        self.chains = np.asarray(chains)
        #: (n_chains, n_vars) every chain's last state, all coordinates
        #: whatever `collect_idx` kept: where a run continues from
        self.final_q = None if final_q is None else np.asarray(final_q)
        self.model = model
        self.compiled = compiled
        self.config = config
        self.mass = mass
        self.stats = stats
        self.warmup_stats = warmup_stats
        self.step_size = None if step_size is None else np.asarray(step_size)
        self.collect_idx = collect_idx
        self.walltime = walltime
        #: per-phase wall-clock breakdown set by the driver:
        #: build_s / compile_s / warmup_s / sample_s / transfer_s
        self.timings: Optional[dict] = None

    @staticmethod
    def from_result(model, compiled, result, config, collect_idx=None,
                    walltime=None) -> "Trace":
        """Copy a driver ChainResult (tensors on any device) to the host."""
        return Trace(
            chains=result.samples.detach().cpu().numpy(),
            model=model, compiled=compiled, config=config,
            mass=_to_numpy(result.mass), stats=_to_numpy(result.stats),
            warmup_stats=_to_numpy(result.warmup_stats),
            step_size=result.step_size.detach().cpu().numpy(),
            collect_idx=collect_idx, walltime=walltime,
            final_q=result.final_q.detach().cpu().numpy())

    # -- basic shape ------------------------------------------------------
    @property
    def n_chains(self) -> int:
        return self.chains.shape[0]

    @property
    def n_iterations(self) -> int:
        return self.chains.shape[1]

    def flat(self) -> np.ndarray:
        """(n_chains*n_iters, n_collect) draws."""
        return self.chains.reshape(-1, self.chains.shape[-1])

    # -- diagnostics ------------------------------------------------------
    def diagnostics(self, split: bool = False,
                    rank_normalized: bool = False) -> list[Diagnostics]:
        """Per-parameter (r̂, ESS) on the float64 host pipeline.

        Defaults match the reference exactly (Stan manual §30.3/30.4,
        Trace.scala:49-120). ``split=True`` computes split-chain r̂;
        ``rank_normalized=True`` (implies split) computes the
        rank-normalized bulk diagnostics of Vehtari et al. 2021."""
        if self.n_chains < 2:
            raise ValueError("diagnostics requires multiple chains")
        chains = self.chains
        if split or rank_normalized:
            chains = _split_chains(chains)
        if rank_normalized:
            chains = _rank_normalize(chains)
        r_hat, ess = _diagnostics_all(chains)
        return [Diagnostics(float(r), float(e))
                for r, e in zip(r_hat, ess)]

    def summary(self, quantiles: tuple = (0.025, 0.25, 0.5, 0.75, 0.975)
                ) -> TraceSummary:
        """Per-parameter pooled posterior mean/sd/quantiles."""
        flat = self.flat().astype(np.float64)
        return TraceSummary(mean=flat.mean(axis=0),
                            sd=flat.std(axis=0, ddof=1),
                            quantiles=np.quantile(flat, quantiles, axis=0),
                            probs=tuple(quantiles), n_draws=flat.shape[0])

    def accept_rate(self) -> np.ndarray:
        return self.stats.accept_sum / np.maximum(self.stats.iterations, 1)

    def bfmi(self) -> np.ndarray:
        return self.stats.energy_trans2 / np.maximum(self.stats.e_raw, 1e-20)

    def divergences(self) -> int:
        return int(np.sum(self.stats.divergences))

    # -- evaluation over draws --------------------------------------------
    def evaluate(self, exprs) -> np.ndarray:
        """Evaluate Real expression(s) at every draw → (n_draws, ...), in
        float64 on the host (the numpy oracle over the chains-last layout
        of interp.evaluate_lanes).  The data columns the expressions read
        are bound whole, whether or not a likelihood reads them: an
        expression over n rows gives (n_draws, n)."""
        if self.collect_idx is not None:
            raise ValueError("evaluate requires the full parameter "
                             "vector; re-run sample with collect_idx=None")
        single = isinstance(exprs, R.Real)
        exprs = [R.to_real(e) for e in ([exprs] if single else exprs)]
        qb = self.flat().astype(np.float64).T          # (n_vars, N)
        env = self.compiled.layout.env_for_lanes(qb)
        columns = find_columns(exprs)
        bind_lane_columns(env, columns, [
            np.asarray(c.values, dtype=np.int32 if isinstance(
                c, R.IntColumn) else np.float64) for c in columns])
        vals = interp.evaluate_lanes(exprs, env, interp.NUMPY_BACKEND,
                                     np.float64)
        n = qb.shape[1]
        out = [np.broadcast_to(np.asarray(v), (1, n))[0] if np.ndim(v) < 2
               or np.shape(v)[0] == 1 else np.asarray(v).T for v in vals]
        return out[0] if single else out

    def mean(self, expr) -> float:
        return float(np.mean(self.evaluate(expr)))

    def std(self, expr) -> float:
        return float(np.std(self.evaluate(expr)))
