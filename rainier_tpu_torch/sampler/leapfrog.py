"""Symplectic leapfrog integrator + Metropolis step (port of
rainier_tpu/sampler/leapfrog.py; counterpart of sampler/LeapFrog.scala).

Chains are the leading batch dimension: q and grad are (C, n), potential
and step sizes (C,).  `ChainState` carries the cached gradient alongside
q, so each leapfrog step costs exactly one density+gradient evaluation.

Conventions: `potential` = −logp; `grad` = ∇logp (so dp/dt = +grad);
`lpg(q (C, n)) -> (logp (C,), grad (C, n))`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .mass import MassState, kinetic, sample_momentum, velocity


class ChainState(NamedTuple):
    q: torch.Tensor          # (C, n) position
    potential: torch.Tensor  # (C,), −logp(q)
    grad: torch.Tensor       # (C, n), ∇logp(q)


def chain_state(q, lpg) -> ChainState:
    lp, g = lpg(q)
    return ChainState(q=q, potential=-lp, grad=g)


def _col(step_size):
    """(C,) per-chain step → (C, 1) so it broadcasts over coordinates."""
    return step_size[:, None] if torch.is_tensor(step_size) and \
        step_size.dim() == 1 else step_size


def leapfrog(state: ChainState, p, step_size, n_steps: int,
             mass: MassState, lpg: Callable):
    """Integrate n_steps of Hamiltonian dynamics; returns (state', p')."""
    eps = _col(step_size)
    p = p + 0.5 * eps * state.grad
    q = state.q + eps * velocity(mass, p)
    lp, grad = lpg(q)
    for _ in range(n_steps - 1):
        p = p + eps * grad
        q = q + eps * velocity(mass, p)
        lp, grad = lpg(q)
    p = p + 0.5 * eps * grad
    return ChainState(q=q, potential=-lp, grad=grad), p


def log_accept_prob(h0, h1):
    """min(0, −ΔH) with non-finite energy on either side ⇒ −∞.

    Stricter than the reference's NaN-only rule
    (LeapFrog.logAcceptanceProb:138-142): h0=+inf with a finite h1 would
    otherwise accept with probability 1 (rainier_tpu
    sampler/leapfrog.py:63-76)."""
    la = torch.clamp(-(h1 - h0), max=0.0)
    bad = ~torch.isfinite(h0) | ~torch.isfinite(h1)
    return torch.where(bad, torch.full_like(la, -float("inf")), la)


class TransitionResult(NamedTuple):
    state: ChainState
    log_accept: torch.Tensor
    accepted: torch.Tensor
    divergent: torch.Tensor
    energy: torch.Tensor     # H of the retained state (for E-BFMI)


def _select(mask, a, b):
    """a where mask (C,), else b, field by field: tuples of (C,) and
    (C, n) tensors such as ChainState."""
    vals = (torch.where(mask if x.dim() == 1 else mask[:, None], x, y)
            for x, y in zip(a, b))
    return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)


def kdk_step(q, p, grad, step_size, mass: MassState, lpg: Callable):
    """One fused kick-drift-kick leapfrog step, one gradient evaluation:
    (q', p', logp', grad').  Chained, these are exactly an L-step
    leapfrog; EHMC and NUTS take them one at a time."""
    eps = _col(step_size)
    p = p + 0.5 * eps * grad
    q = q + eps * velocity(mass, p)
    lp, grad = lpg(q)
    p = p + 0.5 * eps * grad
    return q, p, lp, grad


def hmc_transition(gen, state: ChainState, step_size, n_steps: int,
                   mass: MassState, lpg: Callable) -> TransitionResult:
    """One momentum refresh + trajectory + Metropolis accept for every
    chain (HMCSampler.warmup/run → LeapFrog start/takeSteps/
    finishIteration)."""
    q = state.q
    p0 = sample_momentum(mass, gen, q.shape, q.dtype, q.device)
    h0 = state.potential + kinetic(mass, p0)
    new_state, p1 = leapfrog(state, p0, step_size, n_steps, mass, lpg)
    h1 = new_state.potential + kinetic(mass, p1)
    la = log_accept_prob(h0, h1)
    u = torch.rand(q.shape[:1], generator=gen, dtype=q.dtype,
                   device=q.device)
    accept = torch.log(u) < la
    out = _select(accept, new_state, state)
    divergent = torch.isinf(la) | torch.isnan(la)
    energy = torch.where(accept, h1, h0)
    return TransitionResult(out, la, accept, divergent, energy)


def try_stepping(state: ChainState, p, step_size, mass: MassState,
                 lpg: Callable):
    """Log-accept-prob of a single step from (state, p) — used by the
    initial step-size bracketing (LeapFrog.tryStepping)."""
    h0 = state.potential + kinetic(mass, p)
    s1, p1 = leapfrog(state, p, step_size, 1, mass, lpg)
    h1 = s1.potential + kinetic(mass, p1)
    return log_accept_prob(h0, h1)


def is_uturn(q_start, q_new, p_new):
    """(q′−q)·p < 0 per chain, NaN ⇒ True (LeapFrog.isUTurn:35-47)."""
    d = torch.sum((q_new - q_start) * p_new, dim=-1)
    return torch.isnan(d) | (d < 0)
