"""Rank-normalised bulk effective sample size, frozen in numpy.

A copy of the float64 host pipeline of ``Trace.diagnostics(
rank_normalized=True, device=False)`` (Stan manual §30.3/30.4 on split,
rank-normalised chains; Vehtari et al. 2021), kept here so that a change
to the program cannot change the yardstick.  Imports numpy and scipy only.
"""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view
from scipy.special import ndtri
from scipy.stats import rankdata

MAX_LAG = 100


def split_chains(chains: np.ndarray) -> np.ndarray:
    """(m, n, k) -> (2m, n // 2, k): each chain cut in half."""
    half = chains.shape[1] // 2
    return np.concatenate([chains[:, :half], chains[:, half:2 * half]],
                          axis=0)


def rank_normalize(chains: np.ndarray) -> np.ndarray:
    """Pooled average ranks -> normal scores z = Φ⁻¹((r − 3/8)/(S + 1/4))."""
    m, n, k = chains.shape
    ranks = rankdata(chains.reshape(m * n, k), method="average", axis=0)
    z = ndtri((ranks.astype(np.float64) - 0.375) / (m * n + 0.25))
    return z.reshape(m, n, k)


def variogram(chains: np.ndarray, max_lag: int) -> np.ndarray:
    """(max_lag, k): Σ_{m,t} (x_{t+l} − x_t)² / (m·(n − l)), in float64 on
    draws centred by their pooled mean."""
    m, n, k = chains.shape
    mu = chains.mean(axis=(0, 1), dtype=np.float64)
    ls = np.arange(1, max_lag + 1)
    cross = np.zeros((max_lag, k))
    head = np.zeros((max_lag, k))
    tail = np.zeros((max_lag, k))
    chunk = max(1, int(16e6) // (n * k))
    for a in range(0, m, chunk):
        x = np.swapaxes(chains[a:a + chunk], 1, 2).astype(np.float64)
        x -= mu[None, :, None]
        xp = np.concatenate(
            [x, np.zeros(x.shape[:-1] + (max_lag,), x.dtype)], axis=-1)
        xw = sliding_window_view(xp, max_lag + 1, axis=-1)
        cross += np.matmul(x[..., None, :], xw)[..., 0, 1:].sum(axis=0).T
        c = np.cumsum(np.square(x), axis=-1)
        head += c[..., n - ls - 1].sum(axis=0).T
        tail += (c[..., -1][..., None] - c[..., ls - 1]).sum(axis=0).T
    return (head + tail - 2.0 * cross) / (m * (n - ls)[:, None])


def ess(chains: np.ndarray, max_lag: int = MAX_LAG) -> np.ndarray:
    """Per-coordinate ESS of (m, n, k) draws, Stan manual §30.4: the
    autocorrelations summed while they stay positive, up to `max_lag`."""
    m, n, k = chains.shape
    means = chains.mean(axis=1)
    b = n / (m - 1) * ((means - means.mean(axis=0)) ** 2).sum(axis=0)
    w = (((chains - means[:, None, :]) ** 2).sum(axis=1) / (n - 1)).mean(
        axis=0)
    v = (n - 1) / n * w + b / n
    vt = variogram(chains, min(max_lag, n - 1))
    pts = 1.0 - vt / (2.0 * np.maximum(v, 1e-300))
    alive = np.cumprod(pts > 0.0, axis=0).astype(bool)
    return n * m / (1 + 2 * (pts * alive).sum(axis=0))


def bulk_ess(chains: np.ndarray) -> np.ndarray:
    """Rank-normalised bulk ESS of (chains, draws, coordinates) draws."""
    return ess(rank_normalize(split_chains(np.asarray(chains))))
