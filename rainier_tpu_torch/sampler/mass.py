"""Mass matrices + Welford estimators + windowed adaptation schedule
(port of rainier_tpu/sampler/mass.py; counterpart of sampler/MassMatrix.scala
and sampler/MassMatrixEstimator.scala).

Chains are the leading batch dimension: a diagonal mass is a (C, n)
tensor, one Σ̂ diagonal per chain.  Dense mass comes in a later slice.

Semantics note (matches reference): `diag` stores the posterior *variance*
estimate Σ̂ (mass matrix M = Σ̂⁻¹); momenta are drawn p ~ N(0, M) and
velocity(p) = Σ̂ p (LeapFrog.scala:202-251).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class MassState(NamedTuple):
    """diag: Σ̂ diagonal (C, n) or None (identity mass)."""

    diag: Optional[torch.Tensor] = None


def identity_mass() -> MassState:
    return MassState()


def diag_mass(variance) -> MassState:
    return MassState(diag=variance)


def velocity(mass: MassState, p):
    """dq/dt = M⁻¹p = Σ̂ p (LeapFrog.velocity)."""
    return p if mass.diag is None else p * mass.diag


def kinetic(mass: MassState, p):
    return 0.5 * torch.sum(p * velocity(mass, p), dim=-1)


def sample_momentum(mass: MassState, gen, shape, dtype, device):
    """p ~ N(0, M) = N(0, Σ̂⁻¹) (LeapFrog.initializePs)."""
    z = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return z if mass.diag is None else z / torch.sqrt(mass.diag)


# ---------------------------------------------------------------------------
# Welford estimator (VarianceEstimator semantics, /n normalization)
# ---------------------------------------------------------------------------


class WelfordState(NamedTuple):
    count: float              # same for every chain: the schedule is shared
    mean: torch.Tensor        # (C, n)
    raw: torch.Tensor         # (C, n) sum of oldDiff*newDiff


def welford_init(shape, dtype, device) -> WelfordState:
    z = torch.zeros(shape, dtype=dtype, device=device)
    return WelfordState(0.0, z, z)


def welford_update(w: WelfordState, x) -> WelfordState:
    count = w.count + 1
    old_diff = x - w.mean
    mean = w.mean + old_diff / count
    raw = w.raw + old_diff * (x - mean)
    return WelfordState(count, mean, raw)


def welford_variance(w: WelfordState):
    """VarianceEstimator.variance divides by n (not n−1)."""
    return w.raw / max(w.count, 1)


def mass_from_welford(w: WelfordState, kind: str,
                      ridge: float = 1e-6) -> MassState:
    if kind != "diag":
        raise NotImplementedError("dense mass comes in a later slice of "
                                  "the port")
    # the reference requires nonzero elements (DiagonalMassMatrix); we
    # floor at `ridge` for the same effect
    return diag_mass(torch.clamp(welford_variance(w), min=ridge))


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
