"""Carried sampler telemetry (port of rainier_tpu/sampler/stats.py;
counterpart of sampler/Stats.scala).  Every field is a (C,) tensor.
BFMI = Σ(E_t − E_{t−1})² / Σ(E_t − Ē)², exactly Stats.bfmi's
energyTransitions2 / energyVariance.raw.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class StatsState(NamedTuple):
    iterations: torch.Tensor
    divergences: torch.Tensor
    accept_sum: torch.Tensor    # Σ exp(log_accept) → mean acceptance rate
    grad_evals: torch.Tensor
    prev_energy: torch.Tensor
    energy_trans2: torch.Tensor  # Σ (E_t − E_{t−1})²
    e_count: torch.Tensor        # Welford over retained energies
    e_mean: torch.Tensor
    e_raw: torch.Tensor


def stats_init(initial_energy: torch.Tensor) -> StatsState:
    z = torch.zeros_like(initial_energy)
    iz = torch.zeros(initial_energy.shape, dtype=torch.int32,
                     device=initial_energy.device)
    return StatsState(iterations=iz, divergences=iz, accept_sum=z,
                      grad_evals=iz, prev_energy=initial_energy.clone(),
                      energy_trans2=z, e_count=z, e_mean=z, e_raw=z)


def stats_update(st: StatsState, log_accept, divergent, energy,
                 n_grad_evals: int) -> StatsState:
    e_count = st.e_count + 1
    old = energy - st.e_mean
    e_mean = st.e_mean + old / e_count
    e_raw = st.e_raw + old * (energy - e_mean)
    return StatsState(
        iterations=st.iterations + 1,
        divergences=st.divergences + divergent.to(torch.int32),
        accept_sum=st.accept_sum + torch.exp(log_accept),
        grad_evals=st.grad_evals + n_grad_evals,
        prev_energy=energy,
        energy_trans2=st.energy_trans2 + (energy - st.prev_energy) ** 2,
        e_count=e_count, e_mean=e_mean, e_raw=e_raw)


def _floor(x, v):
    return x.clamp(min=v) if isinstance(x, torch.Tensor) else np.maximum(x, v)


def bfmi(st: StatsState):
    """Per-chain E-BFMI, of tensors or of host arrays."""
    return st.energy_trans2 / _floor(st.e_raw, 1e-20)


def accept_rate(st: StatsState):
    """Per-chain mean acceptance rate, of tensors or of host arrays."""
    return st.accept_sum / _floor(st.iterations, 1)


def to_host(st: StatsState) -> StatsState:
    """The same StatsState with every field a numpy array (one device to
    host copy a field)."""
    return StatsState(*[x.detach().cpu().numpy()
                        if isinstance(x, torch.Tensor) else np.asarray(x)
                        for x in st])


class LoopCounts:
    """What the batched loops of EHMC and NUTS paid since `reset()`.
    Chains run in lockstep, so a loop takes a step while any chain still
    needs one; each check of that (``bool(mask.any())``) waits for the
    device.  Host integers cost nothing to keep; the per-chain sums stay
    on the device until read.

    * ``iterations``: EHMC and NUTS transitions;
    * ``steps``: lockstep leapfrog steps (NUTS: leaves), what the batch
      paid, steps of finished chains included;
    * ``syncs``: device→host waits of the loops;
    * ``counting``: EHMC counting lanes, summed over warmup iterations;
    * ``depths``: NUTS tree depths, a histogram over chains and
      iterations (index d counts trees of d doublings)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.iterations = 0
        self.steps = 0
        self.syncs = 0
        self.counting = 0
        self.depths = 0

    def add_depths(self, hist) -> None:
        """Add a depth histogram, padding the shorter of the two (runs of
        another max_depth)."""
        if isinstance(self.depths, torch.Tensor):
            old = self.depths.to(hist.device)
            n = max(len(old), len(hist))
            hist = (torch.nn.functional.pad(hist, (0, n - len(hist)))
                    + torch.nn.functional.pad(old, (0, n - len(old))))
        self.depths = hist


#: the process's counts, reset and read by callers that report them
COUNTS = LoopCounts()
