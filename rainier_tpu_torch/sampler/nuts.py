"""Iterative No-U-Turn sampler, multinomial variant (port of
rainier_tpu/sampler/nuts.py; the reference, stripe/rainier, ships HMC and
EHMC only).

The recursive tree of Hoffman & Gelman is a bounded iterative doubling
loop:

* each doubling builds its subtree leaf by leaf (one fused KDK leapfrog
  step, one gradient evaluation, a leaf);
* sub-U-turn checks use an O(max_depth) checkpoint stack: leaf i of a
  2^d-leaf subtree starts the level-l block when i ≡ 0 (mod 2^l) and ends
  it when i ≡ 2^l−1 (mod 2^l);
* within a subtree the proposal is a multinomial (logsumexp-weighted)
  take; across doublings, biased progressive sampling toward the new
  subtree (Betancourt 2017, as in Stan);
* U-turn criteria use velocities (M⁻¹p), so the mass metric is respected;
* a leaf diverges at ΔH > 1000 or a non-finite H (Stan's
  max_delta_energy);
* dual averaging reads the log of the mean leaf acceptance statistic.

Chains are the leading batch dimension and run in lockstep, as a vmapped
``while_loop`` runs them: a loop goes on while any chain is active, and a
finished chain's carry is held with ``torch.where``.  Every active chain
is at the same doubling and the same leaf, so depth, leaf index and the
checkpoint levels are host integers.  No reduction across chains reads a
masked lane (a discarded lane may hold NaN): the only ones are the
``any`` of the loop conditions, over masks that already exclude them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import config as C
from .leapfrog import ChainState, TransitionResult, _select, kdk_step
from .mass import MassState, kinetic, sample_momentum, velocity
from .stats import COUNTS

MAX_DELTA_ENERGY = 1000.0


class _Point(NamedTuple):
    q: torch.Tensor      # (C, n)
    p: torch.Tensor      # (C, n)
    lp: torch.Tensor     # (C,)
    grad: torch.Tensor   # (C, n)


def _leaf(pt: _Point, eps, mass, lpg):
    """One leapfrog step from pt, and the new momentum's velocity
    (kinetic energy and U-turn checks both read it)."""
    pt = _Point(*kdk_step(pt.q, pt.p, pt.grad, eps, mass, lpg))
    return pt, velocity(mass, pt.p)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _turning(mass, q_minus, p_minus, q_plus, p_plus):
    dq = q_plus - q_minus
    return (_dot(dq, velocity(mass, p_minus)) < 0) | \
           (_dot(dq, velocity(mass, p_plus)) < 0)


class _SubtreeResult(NamedTuple):
    z_end: _Point
    prop: _Point
    log_w: torch.Tensor      # (C,)
    turning: torch.Tensor    # (C,) bool
    divergent: torch.Tensor  # (C,) bool
    sum_alpha: torch.Tensor  # (C,)
    leaves: torch.Tensor     # (C,) int32


def _low_bits(i: int, bit: int) -> int:
    """How many of i's lowest bits equal `bit`."""
    k = 0
    while (i >> k) & 1 == bit:
        k += 1
    return k


def _build_subtree(gen, z0: _Point, depth: int, eps_signed, mass, lpg, h0,
                   max_depth: int, active) -> _SubtreeResult:
    """A subtree of up to 2**depth leaves from z0 for the chains in
    `active` (C,); the others' results are not read.  The loop runs while
    any chain is still building, one host sync a leaf.  The checkpoint
    stack holds each block start's position and velocity: the JAX package
    keeps momenta and maps the whole (max_depth + 1, n) stack to
    velocities at every leaf (its ``_vel_rows``); a start's velocity is
    computed once here, at its own leaf."""
    n_chains, n = z0.q.shape
    dtype, dev = z0.q.dtype, z0.q.device
    neg_inf = torch.full((n_chains,), -float("inf"), dtype=dtype, device=dev)
    false = torch.zeros(n_chains, dtype=torch.bool, device=dev)
    z, prop, log_w = z0, z0, neg_inf
    turning, div = false, false
    s_alpha = torch.zeros(n_chains, dtype=dtype, device=dev)
    leaves = torch.zeros(n_chains, dtype=torch.int32, device=dev)
    ckq = z0.q.new_zeros((n_chains, max_depth + 1, n))
    ckv = z0.q.new_zeros((n_chains, max_depth + 1, n))
    running = active
    for i in range(2 ** depth):
        if i:
            COUNTS.syncs += 1
            if not bool(running.any()):
                break
        COUNTS.steps += 1
        zn, v = _leaf(z, eps_signed, mass, lpg)
        h = -zn.lp + 0.5 * _dot(zn.p, v)
        delta = h - h0
        dn = ~torch.isfinite(h) | (delta > MAX_DELTA_ENERGY)
        w = torch.where(dn, neg_inf, -delta)
        alpha = torch.where(dn, 0.0, torch.clamp(torch.exp(-delta),
                                                 max=1.0))
        new_log_w = torch.logaddexp(log_w, w)
        u = torch.rand(n_chains, generator=gen, dtype=dtype, device=dev)
        take = torch.log(u) < (w - new_log_w)
        # the levels 1..depth whose block leaf i starts, and those it
        # ends: both are runs of levels from 1 (i's low zero bits, its low
        # one bits); a finished chain's stack is never read again
        starts = min(depth, _low_bits(i, 0) if i else depth)
        ends = min(depth, _low_bits(i, 1))
        if starts:
            ckq[:, 1:starts + 1] = zn.q[:, None, :]
            ckv[:, 1:starts + 1] = v[:, None, :]
        tn = false
        if ends:
            dq = zn.q[:, None, :] - ckq[:, 1:ends + 1]          # (C, k, n)
            tn = ((_dot(dq, ckv[:, 1:ends + 1]) < 0)
                  | (_dot(dq, v[:, None, :]) < 0)).any(dim=1)
        z = _select(running, zn, z)
        prop = _select(running & take, zn, prop)
        log_w = torch.where(running, new_log_w, log_w)
        s_alpha = torch.where(running, s_alpha + alpha, s_alpha)
        turning = torch.where(running, tn, turning)
        div = torch.where(running, dn, div)
        leaves = leaves + running.to(torch.int32)
        running = running & ~tn & ~dn
    return _SubtreeResult(z_end=z, prop=prop, log_w=log_w, turning=turning,
                          divergent=div, sum_alpha=s_alpha, leaves=leaves)


def nuts_step(cfg: C.NUTS, gen, chain: ChainState, eps, mass: MassState,
              extra, lpg):
    """One NUTS transition for every chain: (TransitionResult, extra,
    gradient evaluations (C,) int32)."""
    q = chain.q
    n_chains = q.shape[0]
    dtype, dev = q.dtype, q.device
    COUNTS.iterations += 1
    p0 = sample_momentum(mass, gen, q.shape, dtype, dev)
    h0 = chain.potential + kinetic(mass, p0)
    z0 = _Point(q, p0, -chain.potential, chain.grad)
    z_left = z_right = prop = z0
    log_w = torch.zeros(n_chains, dtype=dtype, device=dev)
    div = torch.zeros(n_chains, dtype=torch.bool, device=dev)
    s_alpha = torch.zeros(n_chains, dtype=dtype, device=dev)
    n_grads = torch.zeros(n_chains, dtype=torch.int32, device=dev)
    depths = torch.zeros(n_chains, dtype=torch.int64, device=dev)
    active = torch.ones(n_chains, dtype=torch.bool, device=dev)
    for depth in range(cfg.max_depth):
        if depth:
            COUNTS.syncs += 1
            if not bool(active.any()):
                break
        go_right = torch.rand(n_chains, generator=gen, dtype=dtype,
                              device=dev) < 0.5
        start = _select(go_right, z_right, z_left)
        eps_signed = torch.where(go_right, eps, -eps)
        sub = _build_subtree(gen, start, depth, eps_signed, mass, lpg, h0,
                             cfg.max_depth, active)
        n_grads = n_grads + torch.where(active, sub.leaves, 0)
        s_alpha = s_alpha + torch.where(active, sub.sum_alpha, 0.0)
        valid = ~sub.turning & ~sub.divergent
        u = torch.rand(n_chains, generator=gen, dtype=dtype, device=dev)
        # biased progressive sampling toward the new subtree
        take = active & valid & (torch.log(u) < (sub.log_w - log_w))
        prop = _select(take, sub.prop, prop)
        grow = active & valid
        log_w = torch.where(grow, torch.logaddexp(log_w, sub.log_w), log_w)
        z_right = _select(grow & go_right, sub.z_end, z_right)
        z_left = _select(grow & ~go_right, sub.z_end, z_left)
        stop = ~valid | _turning(mass, z_left.q, z_left.p, z_right.q,
                                 z_right.p)
        div = div | (active & sub.divergent)
        depths = depths + active.to(torch.int64)
        active = active & ~stop
    # a scatter, not torch.bincount, which waits for the device to size
    # its output
    COUNTS.add_depths(torch.zeros(
        cfg.max_depth + 1, dtype=torch.int64, device=dev).scatter_add_(
            0, depths, torch.ones_like(depths)))

    new_chain = ChainState(q=prop.q, potential=-prop.lp, grad=prop.grad)
    accepted = torch.any(prop.q != q, dim=-1)
    # every leaf an active chain built counts (the JAX package's n_alpha)
    mean_alpha = s_alpha / torch.clamp(n_grads, min=1)
    log_accept = torch.log(torch.clamp(mean_alpha, min=1e-30))
    energy = -prop.lp + kinetic(mass, prop.p)
    return TransitionResult(new_chain, log_accept, accepted, div,
                            energy), extra, n_grads
