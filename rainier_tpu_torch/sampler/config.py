"""Sampler configuration (counterpart of sampler/Sampler.scala:3-27).

Typed config dataclasses, no global flags — same shape as the reference's
SamplerConfig trait + DefaultConfig.  Defaults mirror DefaultConfig:
1000 warmup / 1000 iterations / DualAvg(0.8) /
DiagonalMassMatrixTuner(50, 1.5, 50, 50) / EHMC(1024).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Union


@dataclass(frozen=True)
class HMC:
    """Fixed-length HMC (sampler/HMC.scala)."""

    n_steps: int = 5


@dataclass(frozen=True)
class EHMC:
    """Empirical HMC, Wu et al. 2018 (sampler/EHMC.scala).

    `synchronized` (an extension of the reference, default on): every
    chain replays ONE empirical draw of the trajectory length, the first
    chain's, so a batch pays that draw's steps an iteration and not the
    longest of its chains' draws; and in warmup each counting chain's
    length lands in every chain's ring, at a counting rate scaled so the
    batch adds p_count·buf_size lengths an iteration.  L stays independent
    of every chain's state, so the transition remains a valid MH kernel
    (rainier_tpu/sampler/samplers.py:164-246).  Set False for the
    reference's strictly per-chain counting and replay
    (EHMC.scala:52-63)."""

    max_steps: int = 1024
    min_steps: int = 1
    buf_size: int = 100
    p_count: float = 0.1
    synchronized: bool = True


@dataclass(frozen=True)
class NUTS:
    """Iterative No-U-Turn sampler with multinomial state selection —
    capability the reference lacks (listed in BASELINE configs)."""

    max_depth: int = 10


SamplerKind = Union[HMC, EHMC, NUTS]


@dataclass(frozen=True)
class DualAvgStepSize:
    delta: float = 0.8


@dataclass(frozen=True)
class StaticStepSize:
    step_size: float = 0.1


@dataclass(frozen=True)
class IdentityMassMatrix:
    pass


@dataclass(frozen=True)
class DiagonalMassMatrixTuner:
    initial_window: int = 50
    expansion: float = 1.5
    skip_first: int = 50
    skip_last: int = 50


@dataclass(frozen=True)
class DenseMassMatrixTuner:
    initial_window: int = 50
    expansion: float = 1.5
    skip_first: int = 50
    skip_last: int = 50


@dataclass(frozen=True)
class StaticMassMatrix:
    diag: Optional[Sequence[float]] = None
    cov: Optional[Sequence[Sequence[float]]] = None


MassConfig = Union[IdentityMassMatrix, DiagonalMassMatrixTuner,
                   DenseMassMatrixTuner, StaticMassMatrix]


@dataclass(frozen=True)
class SamplerConfig:
    warmup_iterations: int = 1000
    iterations: int = 1000
    sampler: SamplerKind = field(default_factory=lambda: EHMC())
    step_size: Union[DualAvgStepSize, StaticStepSize] = field(
        default_factory=DualAvgStepSize)
    mass_matrix: MassConfig = field(
        default_factory=DiagonalMassMatrixTuner)
    thin: int = 1
    # 'independent' matches the reference (each chain adapts alone);
    # 'pooled' shares adaptation statistics across all chains — the
    # cross-chain mode enabled by running chains as a device-sharded batch
    pooled_adaptation: bool = False
    # per-chain initial positions are drawn q0 ~ N(0, init_scale²·I)
    # (the reference fills the q slots with rng.standardNormal,
    # LeapFrog.scala:102-110); overdispersed starts are what make
    # split-chain r̂ able to detect non-convergence.  0.0 starts every
    # chain at the origin (NOT recommended: chains then differ only
    # through momentum RNG and multimodal posteriors silently "converge")
    init_scale: float = 1.0


def hmc(warmup: int, it: int, n_steps: int) -> SamplerConfig:
    """HMC(warmIt, it, nSteps) legacy-style constructor (HMC.scala:26-33)."""
    return SamplerConfig(warmup_iterations=warmup, iterations=it,
                         sampler=HMC(n_steps))


def ehmc(warmup: int, it: int, min_steps: int = 1,
         num_lengths: int = 100) -> SamplerConfig:
    """EHMC(warmIt, it, ...) constructor (EHMC.scala:64-74; default
    l0 = 1024 per DefaultConfig's EHMCSampler(1024))."""
    return SamplerConfig(warmup_iterations=warmup, iterations=it,
                         sampler=EHMC(1024, min_steps, num_lengths, 0.1))


def nuts(warmup: int = 1000, it: int = 1000,
         max_depth: int = 10) -> SamplerConfig:
    return SamplerConfig(warmup_iterations=warmup, iterations=it,
                         sampler=NUTS(max_depth))
