"""Mass matrices + Welford estimators + windowed adaptation schedule
(port of rainier_tpu/sampler/mass.py; counterpart of sampler/MassMatrix.scala
and sampler/MassMatrixEstimator.scala).

Chains are the leading batch dimension: a diagonal mass is a (C, n)
tensor, one Σ̂ diagonal per chain; a dense mass is a (C, n, n) Σ̂ and its
(C, n, n) lower Cholesky factor.

Semantics note (matches reference): `diag` stores the posterior *variance*
estimate Σ̂ (mass matrix M = Σ̂⁻¹); momenta are drawn p ~ N(0, M) and
velocity(p) = Σ̂ p (LeapFrog.scala:202-251).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..compute.cholesky import cholesky_lower, upper_triangular_solve


class MassState(NamedTuple):
    """diag: Σ̂ diagonal (C, n) or None; dense: Σ̂ (C, n, n) and its lower
    Cholesky factor, or None.  Identity mass carries neither."""

    diag: Optional[torch.Tensor] = None
    cov: Optional[torch.Tensor] = None
    chol: Optional[torch.Tensor] = None


def identity_mass() -> MassState:
    return MassState()


def diag_mass(variance) -> MassState:
    return MassState(diag=variance)


def dense_mass(cov) -> MassState:
    return MassState(cov=cov, chol=cholesky_lower(cov))


def velocity(mass: MassState, p):
    """dq/dt = M⁻¹p = Σ̂ p (LeapFrog.velocity)."""
    if mass.diag is not None:
        return p * mass.diag
    if mass.cov is not None:
        return torch.matmul(mass.cov, p[..., None])[..., 0]
    return p


def kinetic(mass: MassState, p):
    return 0.5 * torch.sum(p * velocity(mass, p), dim=-1)


def momentum_from_normal(mass: MassState, z):
    """The map from z ~ N(0, I) to p ~ N(0, M) = N(0, Σ̂⁻¹): z/√Σ̂ for a
    diagonal, L⁻ᵀz for a dense Σ̂ = LLᵀ (cov(p) = (LLᵀ)⁻¹)."""
    if mass.diag is not None:
        return z / torch.sqrt(mass.diag)
    if mass.chol is not None:
        return upper_triangular_solve(mass.chol.transpose(-1, -2), z)
    return z


def sample_momentum(mass: MassState, gen, shape, dtype, device):
    """p ~ N(0, M) = N(0, Σ̂⁻¹) (LeapFrog.initializePs)."""
    z = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return momentum_from_normal(mass, z)


# ---------------------------------------------------------------------------
# Welford estimators (sampler/MassMatrixEstimator.scala)
# ---------------------------------------------------------------------------


class WelfordState(NamedTuple):
    count: float              # same for every chain: the schedule is shared
    mean: torch.Tensor        # (C, n)
    raw: torch.Tensor         # (C, n) sum of oldDiff*newDiff
    cov_raw: Optional[torch.Tensor] = None   # (C, n, n) for dense


def welford_init(shape, dtype, device, dense: bool = False) -> WelfordState:
    z = torch.zeros(shape, dtype=dtype, device=device)
    cov_raw = torch.zeros(tuple(shape) + (shape[-1],), dtype=dtype,
                          device=device) if dense else None
    return WelfordState(0.0, z, z, cov_raw)


def welford_update(w: WelfordState, x) -> WelfordState:
    count = w.count + 1
    old_diff = x - w.mean
    mean = w.mean + old_diff / count
    new_diff = x - mean
    raw = w.raw + old_diff * new_diff
    cov_raw = w.cov_raw
    if cov_raw is not None:
        # CovarianceEstimator.update accumulates newDiff ⊗ oldDiff
        cov_raw = cov_raw + new_diff[..., :, None] * old_diff[..., None, :]
    return WelfordState(count, mean, raw, cov_raw)


def welford_variance(w: WelfordState):
    """VarianceEstimator.variance divides by n (not n−1)."""
    return w.raw / max(w.count, 1)


def welford_covariance(w: WelfordState):
    """CovarianceEstimator.covariance divides by n−1."""
    return w.cov_raw / max(w.count - 1, 1)


def mass_from_welford(w: WelfordState, kind: str,
                      ridge: float = 1e-6) -> MassState:
    if kind == "diag":
        # the reference requires nonzero elements (DiagonalMassMatrix); we
        # floor at `ridge` for the same effect
        return diag_mass(torch.clamp(welford_variance(w), min=ridge))
    if kind == "dense":
        # the JAX package's shrinkage toward a small identity
        # (rainier_tpu/sampler/mass.py:129-145), which bounds Σ̂'s
        # condition number after a short window in f32:
        #   Σ_reg = n/(n+5)·Σ̂ + (1e-3·5/(n+5) + ridge)·I
        cov = welford_covariance(w)
        n = max(w.count, 1.0)
        shrink = n / (n + 5.0)
        eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
        return dense_mass(shrink * cov
                          + (1e-3 * (1.0 - shrink) + ridge) * eye)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Windowed schedule (precomputed masks)
# ---------------------------------------------------------------------------


def window_masks(iterations: int, initial_window: int, expansion: float,
                 skip_first: int, skip_last: int):
    """Per-iteration (update, close) booleans replicating
    WindowedMassMatrixTuner.update's counter logic
    (sampler/MassMatrix.scala:139-163)."""
    update = np.zeros(iterations, dtype=bool)
    close = np.zeros(iterations, dtype=bool)
    window = initial_window
    i = 0
    for it in range(iterations):
        j = it + 1
        if j < skip_first or (iterations - j) < skip_last:
            continue
        update[it] = True
        i += 1
        if i == window:
            i = 0
            window = int(window * expansion)
            close[it] = True
    return update, close
