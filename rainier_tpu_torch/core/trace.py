"""Posterior trace: storage, thinning, prediction, convergence diagnostics
(port of rainier_tpu/core/trace.py, counterpart of core/Trace.scala).

rHat and effective sample size follow the Stan manual §30.3/30.4
equations exactly as the reference does (Trace.scala:49-120), vectorized
over all parameters.  Two pipelines compute them: the float64 host
pipeline, numpy/scipy and a verbatim copy
(rainier_tpu/core/trace.py:82-165), and the device pipeline
(`_diagnostics_device`), the JAX package's one-program pipeline as torch
ops on the device that holds the draws, so a sample→diagnose workflow
never copies the trace to the host.  The driver keeps the draws on its
device; `Trace.chains` copies them on first access.

`predict` draws from a generator at every posterior draw at once (see
:mod:`.generator`).
"""

from __future__ import annotations

import time
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import config
from ..compute import interp
from ..compute import real as R
from ..compute.compiler import bind_lane_columns, find_columns
from .generator import Env, draws_first, to_generator, tree_map


class Diagnostics(NamedTuple):
    r_hat: float
    effective_sample_size: float


#: pooled-draw bound for the device rank-normalized pipeline: ranks stay
#: exact integers in f32 below 2²⁴.  Traces bigger than this are
#: iteration-thinned for the rank diagnostics only (Trace.diagnostics).
_RANK_DIAG_MAX_DRAWS = 1 << 24

#: device-memory budget (bytes) for the rank step's per-parameter
#: intermediates; parameters beyond it are ranked in sequential chunks
_RANK_LANES_BUDGET = 2e9


def rank_diag_plan(n_chains: int, n_iterations: int):
    """(thin, n_kept) for the rank-normalized device pipeline (a copy of
    rainier_tpu/core/trace.py:46-72).

    Iteration thinning that brings the pooled draw count under
    ``_RANK_DIAG_MAX_DRAWS``, with ``n_kept = ceil(n_iterations / thin)``
    iterations surviving.  Guarantees ``n_chains * n_kept <=
    _RANK_DIAG_MAX_DRAWS`` and ``n_kept >= 2`` (the split-chain halving
    needs at least one column per half); raises ValueError when the
    chain count alone makes that impossible."""
    if n_chains * n_iterations <= _RANK_DIAG_MAX_DRAWS:
        return 1, n_iterations
    max_kept = _RANK_DIAG_MAX_DRAWS // n_chains
    if max_kept < 2:
        raise ValueError(
            f"rank-normalized diagnostics need >= 2 post-thin iterations "
            f"per chain but {n_chains} chains allow at most {max_kept} "
            f"under the {_RANK_DIAG_MAX_DRAWS} pooled-draw bound; use "
            f"diagnostics(device=False) (f64 host path) or fewer chains")
    thin = -(-n_iterations // max_kept)
    n_kept = -(-n_iterations // thin)
    return thin, n_kept


def rank_diag_cap(n_chains: int, n_iterations: int) -> int:
    """The value at which the rank-normalized bulk-ESS estimator
    saturates for a (n_chains, n_iterations) trace — pooled post-thin
    draw count.  An ESS at this cap is a lower bound, never a rate."""
    _, n_kept = rank_diag_plan(n_chains, n_iterations)
    return n_chains * n_kept


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


def twice_ranks(x: torch.Tensor):
    """Twice the average rank (ties averaged, 1-based) of every entry of
    each column of x (S, k), by two formulations from different
    primitives, as int32: (a) one sort, then each tie run's first and
    last position by a forward cummax and a reverse cummin, put back in
    place by a scatter; (b) the number of values below and not above
    each entry, by two searchsorted on the sorted column.  2·rank is an
    integer, so the two agree exactly where both are right, at any
    count of draws (the JAX package compares f32 ranks, which round apart
    past 2²³ draws, ROADMAP C2.2).  Each column is ranked as a
    contiguous row of x.T, the layout the sort and the scans run fastest
    on."""
    cols = x.T.contiguous()                                  # (k, S)
    k, s_total = cols.shape
    sv, perm = torch.sort(cols, dim=1)
    i = torch.arange(s_total, dtype=torch.int64, device=x.device)
    new_run = torch.ones_like(sv, dtype=torch.bool)
    new_run[:, 1:] = sv[:, 1:] != sv[:, :-1]
    run_end = torch.ones_like(new_run)
    run_end[:, :-1] = new_run[:, 1:]
    left = torch.cummax(torch.where(new_run, i, 0), dim=1).values
    right = torch.flip(torch.cummin(torch.flip(
        torch.where(run_end, i, s_total), [1]), dim=1).values, [1])
    rank_a = torch.empty_like(perm).scatter_(1, perm, left + right + 2)
    lo = torch.searchsorted(sv, cols, right=False)
    hi = torch.searchsorted(sv, cols, right=True)
    return rank_a.T.to(torch.int32), (lo + hi + 1).T.to(torch.int32)


def _rank_normal_scores(chains: torch.Tensor):
    """(normal scores of the pooled ranks, shaped like chains (m, n, k);
    whether the two rank formulations of :func:`twice_ranks` agree).
    z = Φ⁻¹((r − 3/8)/(S + 1/4)), evaluated on the smaller tail and
    mirrored, so the top rank's fraction does not round to 1 in f32.
    The scores are computed in f64 from the exact 2·rank and returned
    in the chains' dtype.  Parameters are ranked in chunks that bound the
    intermediates."""
    m, n, k = chains.shape
    s_total = m * n
    flat = chains.reshape(s_total, k)
    chunk = max(1, min(k, int(_RANK_LANES_BUDGET // (48 * s_total))))
    z = torch.empty_like(flat)
    ok = True
    for a in range(0, k, chunk):
        ra, rb = twice_ranks(flat[:, a:a + chunk])
        ok = ok and bool(torch.equal(ra, rb))
        ranks = ra.to(torch.float64) * 0.5
        num_lo = ranks - 0.375
        num_hi = (s_total - ranks) + 0.625
        p_small = torch.minimum(num_lo, num_hi) / (s_total + 0.25)
        zs = torch.special.ndtri(p_small)            # <= 0 by construction
        z[:, a:a + chunk] = torch.where(num_lo <= num_hi, zs, -zs).to(
            chains.dtype)
    return z.reshape(m, n, k), ok


def _diagnostics_device(chains: torch.Tensor, max_lag: int, split: bool,
                        rank_normalized: bool):
    """Device-native r̂/ESS (rainier_tpu/core/trace.py:169-297) as torch
    ops on the device that holds ``chains`` (m, n, k), in their dtype:
    split, rank-normalization, between/within variances and the
    variogram autocorrelation.  Returns (r_hat (k,), ess (k,), whether
    the rank formulations agree).

    Conditioning: f32 chains from concentrated posteriors have
    |mean|/sd up to ~10³, so every moment runs on globally centered
    values (two-pass mean), and the variogram is the direct
    squared-difference estimator, which cancels any residual shift."""
    m, n, k = chains.shape
    if split:
        half = n // 2
        chains = torch.cat([chains[:, :half], chains[:, half:2 * half]],
                           dim=0)
        m, n = 2 * m, half
    ranks_ok = True
    if rank_normalized:
        chains, ranks_ok = _rank_normal_scores(chains)

    mu1 = chains.mean(dim=(0, 1))
    mu = mu1 + (chains - mu1).mean(dim=(0, 1))
    x = chains - mu                                   # (m, n, k)

    means = x.mean(dim=1)                             # (m, k)
    mean_mean = means.mean(dim=0)                     # (k,)
    b = n / (m - 1) * ((means - mean_mean) ** 2).sum(dim=0)
    variances = ((x - means[:, None, :]) ** 2).sum(dim=1) / (n - 1)
    w = variances.mean(dim=0)
    v = (n - 1) / n * w + b / n
    r_hat = torch.sqrt(v / torch.clamp(w, min=1e-30))

    max_lag = min(max_lag, n - 1)
    vt = torch.stack([((x[:, lag:] - x[:, :n - lag]) ** 2).sum(dim=(0, 1))
                      / (m * (n - lag)) for lag in range(1, max_lag + 1)])
    pts = 1.0 - vt / (2.0 * torch.clamp(v, min=1e-30))
    alive = torch.cumprod((pts > 0.0).to(x.dtype), dim=0)
    ac = (pts * alive).sum(dim=0)
    ess = n * m / (1 + 2 * ac)
    return r_hat, ess, ranks_ok


def _summary_device(chains: torch.Tensor, quantiles: tuple, thin: int):
    """Per-parameter pooled mean, sd and quantiles on the device that
    holds ``chains`` (rainier_tpu/core/trace.py:301-330): moments over
    every draw (two-pass centered), linear-interpolation quantiles of
    the draws sorted, every `thin`-th iteration where the pooled count
    passes the rank pipeline's bound."""
    m, n, k = chains.shape
    flat = chains.reshape(m * n, k)
    mu1 = flat.mean(dim=0)
    mu = mu1 + (flat - mu1).mean(dim=0)
    x = flat - mu
    var = (x * x).sum(dim=0) / (m * n - 1)
    s = chains[:, ::thin, :].reshape(-1, k) if thin > 1 else flat
    sv = torch.sort(s, dim=0).values
    qs = torch.as_tensor(quantiles, dtype=chains.dtype, device=chains.device)
    pos = qs * (s.shape[0] - 1)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.clamp(lo + 1, max=s.shape[0] - 1)
    frac = (pos - lo)[:, None]
    qv = sv[lo, :] * (1 - frac) + sv[hi, :] * frac
    return mu, torch.sqrt(var), qv



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
        # (n_chains, n_iters, n_collect) draws: a tensor stays on its
        # device until a host consumer reads `chains`; the diagnostics,
        # summary and predict run where it is
        self._chains_host = (None if isinstance(chains, torch.Tensor)
                             else np.asarray(chains))
        self._chains_src = chains if self._chains_host is None \
            else self._chains_host
        #: wall seconds the host copy of the draws took (set on the first
        #: read of `chains`)
        self.transfer_s: Optional[float] = None
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
        """A Trace of a driver ChainResult: the draws stay on their
        device, the rest is copied to the host."""
        return Trace(
            chains=result.samples.detach(),
            model=model, compiled=compiled, config=config,
            mass=_to_numpy(result.mass), stats=_to_numpy(result.stats),
            warmup_stats=_to_numpy(result.warmup_stats),
            step_size=result.step_size.detach().cpu().numpy(),
            collect_idx=collect_idx, walltime=walltime,
            final_q=result.final_q.detach().cpu().numpy())

    # -- basic shape ------------------------------------------------------
    @property
    def chains(self) -> np.ndarray:
        """Host copy of the draws, made on first access (the device→host
        copy is timed into `transfer_s`)."""
        if self._chains_host is None:
            t0 = time.perf_counter()
            self._chains_host = self._chains_src.cpu().numpy()
            self.transfer_s = time.perf_counter() - t0
        return self._chains_host

    @property
    def n_chains(self) -> int:
        return self._chains_src.shape[0]

    @property
    def n_iterations(self) -> int:
        return self._chains_src.shape[1]

    def thin(self, n: int) -> "Trace":
        """Every n-th iteration of each chain, where the draws are."""
        return Trace(self._chains_src[:, ::n], self.model, self.compiled,
                     self.config, self.mass, self.stats, self.warmup_stats,
                     self.step_size, self.collect_idx, self.walltime,
                     self.final_q)

    def flat(self) -> np.ndarray:
        """(n_chains*n_iters, n_collect) draws."""
        return self.chains.reshape(-1, self.chains.shape[-1])

    def _device_chains(self) -> torch.Tensor:
        """The draws as a tensor: where the driver kept them, else on the
        process's default device."""
        src = self._chains_src
        if isinstance(src, torch.Tensor):
            return src
        return torch.as_tensor(self._chains_host,
                               device=config.resolve_device())

    # -- diagnostics ------------------------------------------------------
    def diagnostics(self, split: bool = False,
                    rank_normalized: bool = False,
                    device: bool = True) -> list[Diagnostics]:
        """Per-parameter (r̂, ESS).

        Defaults match the reference exactly (Stan manual §30.3/30.4,
        Trace.scala:49-120). ``split=True`` computes split-chain r̂;
        ``rank_normalized=True`` (implies split) computes the
        rank-normalized bulk diagnostics of Vehtari et al. 2021.

        ``device=True`` (default) runs :func:`_diagnostics_device` where
        the draws are, in their dtype; ``device=False`` the float64 host
        pipeline.  Past 2²⁴ pooled draws the rank-normalized device
        pipeline diagnoses every ``thin``-th iteration
        (:func:`rank_diag_plan`): its r̂ estimates the same quantity, its
        ESS is a lower bound.  Where the two rank formulations disagree
        it warns and uses the host pipeline on those draws."""
        if self.n_chains < 2:
            raise ValueError("diagnostics requires multiple chains")
        if rank_normalized:
            split = True
        if device:
            chains = self._device_chains()
            if rank_normalized:
                thin, _ = rank_diag_plan(chains.shape[0], chains.shape[1])
                if thin > 1:
                    chains = chains[:, ::thin, :]
            r_hat, ess, ranks_ok = _diagnostics_device(
                chains.contiguous(), 100, split, rank_normalized)
            if ranks_ok:
                r_hat, ess = r_hat.cpu().numpy(), ess.cpu().numpy()
            else:
                warnings.warn(
                    "the device's two rank formulations disagree; using "
                    "the float64 host pipeline", stacklevel=2)
                r_hat, ess = _diagnostics_all(_rank_normalize(
                    _split_chains(chains.cpu().numpy())))
        else:
            chains = self.chains
            if split:
                chains = _split_chains(chains)
            if rank_normalized:
                chains = _rank_normalize(chains)
            r_hat, ess = _diagnostics_all(chains)
        return [Diagnostics(float(r), float(e))
                for r, e in zip(r_hat, ess)]

    def summary(self, quantiles: tuple = (0.025, 0.25, 0.5, 0.75, 0.975)
                ) -> TraceSummary:
        """Per-parameter pooled posterior mean/sd/quantiles, computed
        where the draws are (:func:`_summary_device`): a sample→summarize
        workflow copies (k,) and (q, k) arrays to the host, not the
        trace.  Quantiles sort every ``thin``-th iteration past the rank
        pipeline's bound (:func:`rank_diag_plan`)."""
        src = self._device_chains()
        thin, _ = rank_diag_plan(src.shape[0], src.shape[1])
        mu, sd, qv = _summary_device(src, tuple(quantiles), thin)
        return TraceSummary(mean=mu.cpu().numpy(), sd=sd.cpu().numpy(),
                            quantiles=qv.cpu().numpy(),
                            probs=tuple(quantiles),
                            n_draws=src.shape[0] * src.shape[1])

    def accept_rate(self) -> np.ndarray:
        return self.stats.accept_sum / np.maximum(self.stats.iterations, 1)

    def bfmi(self) -> np.ndarray:
        return self.stats.energy_trans2 / np.maximum(self.stats.e_raw, 1e-20)

    def divergences(self) -> int:
        return int(np.sum(self.stats.divergences))

    # -- evaluation over draws --------------------------------------------
    def _require_full(self, what):
        if self.collect_idx is not None:
            raise ValueError(f"{what} requires the full parameter vector; "
                             f"re-run sample with collect_idx=None")

    def evaluate(self, exprs) -> np.ndarray:
        """Evaluate Real expression(s) at every draw → (n_draws, ...), in
        float64 on the host (the numpy oracle over the chains-last layout
        of interp.evaluate_lanes).  The data columns the expressions read
        are bound whole, whether or not a likelihood reads them: an
        expression over n rows gives (n_draws, n)."""
        self._require_full("evaluate")
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

    def predict(self, t, seed: int = 0):
        """Posterior-predictive draws of `t` (anything ``Generator.of``
        takes) at every draw (Trace.predict, core/Trace.scala:34-41): one
        batched pass of its generator over all the draws, where they
        are, with a ``torch.Generator`` seeded by `seed`.  Returns numpy
        arrays with the draw axis first: (n_draws,) for a number,
        (n_draws, rows) for a Vec, in the structure of `t`."""
        self._require_full("predict")
        gen = to_generator(t)
        draws = self._device_chains()
        qb = draws.reshape(-1, draws.shape[-1]).T.to(config.dtype())
        env = Env(qb.shape[1], self.compiled.layout.env_for_lanes(qb),
                  qb.device)
        rng = torch.Generator(device=qb.device).manual_seed(seed)
        return tree_map(lambda t: t.cpu().numpy(),
                        draws_first(gen.fn(rng, env)))

    def mean(self, expr) -> float:
        return float(np.mean(self.evaluate(expr)))

    def std(self, expr) -> float:
        return float(np.std(self.evaluate(expr)))

