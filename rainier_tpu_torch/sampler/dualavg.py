"""Nesterov dual-averaging step-size adaptation (port of
rainier_tpu/sampler/dualavg.py; counterpart of sampler/DualAvg.scala:44-90
and the bracketing search findReasonableStepSize, DualAvg.scala:27-41).

Every field is a (C,) tensor: one tuner per chain.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

STEP_SIZE_UPDATE_DENOM = 0.05
ACCEPT_PROB_UPDATE_DENOM = 10.0
DECAY_RATE = 0.75

#: lower bound on the adapted log step size (see the JAX package's note at
#: rainier_tpu/sampler/dualavg.py:20-29): keeps a chain that rejects every
#: proposal from driving exp(log_step) to 0 and log(0) into later updates
MIN_LOG_STEP = -46.0


class DualAvgState(NamedTuple):
    log_step: torch.Tensor
    log_step_bar: torch.Tensor
    avg_error: torch.Tensor
    iteration: torch.Tensor
    shrinkage_target: torch.Tensor


def dual_avg_init(step_size: torch.Tensor) -> DualAvgState:
    z = torch.zeros_like(step_size)
    log_step = torch.clamp(torch.log(step_size), min=MIN_LOG_STEP)
    return DualAvgState(log_step=log_step, log_step_bar=z, avg_error=z,
                        iteration=z,
                        shrinkage_target=log_step + math.log(10.0))


def dual_avg_update(s: DualAvgState, log_accept_prob, delta: float
                    ) -> DualAvgState:
    accept = torch.exp(log_accept_prob)
    it = s.iteration + 1
    avg_mult = 1.0 / (it + ACCEPT_PROB_UPDATE_DENOM)
    step_mult = it ** (-DECAY_RATE)
    avg_error = (1.0 - avg_mult) * s.avg_error + avg_mult * (delta - accept)
    log_step = torch.clamp(
        s.shrinkage_target
        - avg_error * torch.sqrt(it) / STEP_SIZE_UPDATE_DENOM,
        min=MIN_LOG_STEP)
    log_step_bar = step_mult * log_step + (1.0 - step_mult) * s.log_step_bar
    return DualAvgState(log_step, log_step_bar, avg_error, it,
                        s.shrinkage_target)


def dual_avg_reset(s: DualAvgState) -> DualAvgState:
    """On mass-matrix window close the tuner restarts from the current
    averaged step size (DualAvgTuner.reset)."""
    return dual_avg_init(torch.exp(s.log_step_bar))


def current_step_size(s: DualAvgState):
    return torch.exp(s.log_step)


def final_step_size(s: DualAvgState):
    return torch.exp(s.log_step_bar)


def find_reasonable_step_size(try_step_fn, step0: torch.Tensor,
                              max_doublings: int = 60):
    """Double/halve each chain's step until its one-step log-accept-prob
    crosses log(1/2) (DualAvgTuner.findReasonableStepSize).  The JAX
    package's vmapped while_loop becomes a batched loop with a per-chain
    done mask; `try_step_fn(step (C,)) -> log_accept_prob (C,)` must be
    pure.  `step0` is the all-ones starting step (C,)."""
    log2 = math.log(2.0)
    step = step0
    la = try_step_fn(step)
    exponent = torch.where(la > -log2, 1.0, -1.0).to(step.dtype)
    factor = torch.exp2(exponent)

    def active_of(step, la):
        return (step != 0.0) & (exponent * la > -exponent * log2)

    active = active_of(step, la)
    for _ in range(max_doublings):
        if not bool(active.any()):
            break
        step = torch.where(active, step * factor, step)
        la = torch.where(active, try_step_fn(step), la)
        active = active & active_of(step, la)
    return step
