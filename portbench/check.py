"""The comparison that decides `correct`: the fits' outputs judged by the
plain reference of their configuration.  Imports torch only.

Four numbers follow the program from its own state:

* ``warm_lp``, ``warm_grad``: the log density and gradient that warmup
  evaluated (recorded at a few of its evaluations, on chains drawn over
  the whole batch) against the reference's in float64 at the same
  points: the largest |Δlp| / (1 + |lp|), and the largest |Δg| over the
  point's max |g|.
* ``miss``: replayed transitions of the sampling kernel.  From the state
  the kernel started an iteration from (its start state, or the draw
  before) the reference makes the kernel's HMC transition in float64,
  with the kernel's step size, mass diagonal and Philox noise
  (portbench/philox.py), and compares the collected coordinates of the
  draw the Trace handed back, in units of the chain's step scale
  √(mass diagonal).  A transition misses when they differ by more than
  MISS_TOL there; ``miss`` is the share that miss.  Where the draws hold
  every coordinate each transition starts from the program's draw; where
  they do not, the reference runs its first `replay_iters` iterations from
  the kernel's start state on its own.
* ``accept_gap``, where the draws hold every coordinate: the kernel's
  acceptance (the mean of min(1, e^{−ΔH}) over its whole run, per chain)
  averaged over the replayed chains, against the mean of the reference's
  min(1, e^{−ΔH}) at the replayed transitions, drawn over the whole run.
  Where the replay covers only a run's first iterations it is not
  compared: the whole run's acceptance differs from its start's.

Three numbers hold warmup's product (the kernel's start state, step size
and mass diagonal) to the posterior by the reference alone:

* ``warm_q0``: the start state lies in the posterior's typical set.  For
  any smooth posterior E[gᵢ²] = E[Hᵢᵢ] (g the gradient of lp, H the
  diagonal of −∇²lp: the Fisher identity), so at draws from it the mean
  over coordinates of gᵢ²/Hᵢᵢ is about 1; at a start that warmup never
  moved it is thousands.  The mean over the replayed chains, the largest
  over the fits.
* ``warm_mass``: the mass diagonal estimates the posterior's variance of
  each coordinate, which 1/E[Hᵢᵢ] bounds from below and, for a posterior
  close to a Gaussian with weak correlations, nears.  The median over the
  replayed chains and coordinates of |log(Σ̂ᵢᵢ·H̄ᵢᵢ)|, H̄ the mean of Hᵢᵢ
  over the replayed chains' start states; the largest over the fits.
* ``warm_alpha``: the step size meets dual averaging's target.  The
  reference's mean acceptance min(1, e^{−ΔH}) over the replayed
  transitions (with the kernel's step size, mass and noise) against the
  target that the configuration states.

The control puts the reference with the density in bfloat16 (`low`) in the
program's place: its readings are the same numbers with its outputs where
the program's were.  Warmup's product is the program's alone, so the
three numbers above are the program's and have no control: the fault of
a warmup left unchanged is what they are held against.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from portbench import philox

#: a replayed transition misses past this distance in step scales: a
#: transition the two sides accept alike differs by rounding (~1e-4), one
#: accepted on one side only by a whole move (~1)
MISS_TOL = 0.05

#: warmup's evaluations are compared where the reference's |lp| stays
#: below this.  Early warmup's wild steps reach lp ~ −1e27 to −1e42 (sd =
#: e^-28 and less), where float32's intermediates overflow by right; the
#: posterior's points lie at |lp| < 1e7
LP_RANGE = 1e12

#: chains in a block of the reference's evaluations
BLOCK = 128


def _blocked(fn, n):
    def run(*xs):
        outs = [fn(*(x[a:a + BLOCK] for x in xs))
                for a in range(0, n, BLOCK)]
        return tuple(torch.cat(o) for o in zip(*outs))
    return run


def transition(lpg, x, sc, eps, p0, u, n_steps):
    """One HMC iteration of the sampling kernel, in the kernel's order:
    x, sc, p0 (n, dim), eps, u (n,) float64 -> (next state, α)."""
    q = x / sc

    def lp_grad(qs):
        lp, g = lpg(qs * sc)
        return lp, g * sc

    e = eps[:, None]
    lp, g = lp_grad(q)
    h0 = -lp + 0.5 * (p0 * p0).sum(1)
    p = p0 + 0.5 * e * g
    qn = q + e * p
    lpn, gn = lp_grad(qn)
    for _ in range(n_steps - 1):
        p = p + e * gn
        qn = qn + e * p
        lpn, gn = lp_grad(qn)
    p = p + 0.5 * e * gn
    h1 = -lpn + 0.5 * (p * p).sum(1)
    la = torch.clamp(h0 - h1, max=0.0)
    la = torch.where(torch.isfinite(h0) & torch.isfinite(h1), la,
                     torch.full_like(la, -math.inf))
    take = torch.log(u) < la
    return torch.where(take[:, None], qn * sc, q * sc), torch.exp(la)


class FitRecord(NamedTuple):
    """What one fit hands the check, on the reference's device, for its
    replayed chains: their indices, start state (n, dim), step size (n,),
    scale √Σ̂ (n, dim), collected draws (n, iters, k) and whole-run
    acceptance (n,); the kernel's seed and steps; warmup's recorded
    evaluations [(q (m, dim), lp (m,), g (m, dim))]; each chain's first
    replayed iteration (n,) (0 where the draws do not hold every
    coordinate)."""

    chains: torch.Tensor
    q0: torch.Tensor
    eps: torch.Tensor
    scale: torch.Tensor
    draws: torch.Tensor
    accept: torch.Tensor
    seed: int
    n_steps: int
    warm: list
    starts: torch.Tensor


def replay(rec: FitRecord, lpg, collect, full: bool, iters: int,
           low_lpg=None):
    """The replayed transitions of one fit: {side: [misses, transitions,
    Σα]} for the program (Σα its whole-run acceptance, once a
    transition) and, where `low_lpg` is given, the control; and the
    reference's Σα."""
    n, dim = rec.q0.shape
    dev = rec.q0.device
    rows = torch.arange(n, device=dev)
    ci = None if collect is None else torch.as_tensor(collect, device=dev)
    sc_c = rec.scale if ci is None else rec.scale[:, ci]
    tallies = {"program": [0, 0, 0.0]}
    if low_lpg is not None:
        tallies["control"] = [0, 0, 0.0]
    ref_alpha = 0.0
    ref_state = ctl_state = None
    for k in range(iters):
        its = rec.starts + k
        p0, u = philox.noise(rec.seed, its, dim, rec.chains)
        if full:
            prev = rec.draws[rows, (its - 1).clamp(min=0)]
            x = torch.where((its == 0)[:, None], rec.q0, prev)
        else:
            x = rec.q0 if ref_state is None else ref_state
        xr, ar = _blocked(lambda *a: transition(lpg, *a, rec.n_steps), n)(
            x, rec.scale, rec.eps, p0, u)
        ref_state = xr
        ref_alpha += float(ar.sum())
        outs = {"program": (rec.draws[rows, its], rec.accept)}
        if low_lpg is not None:
            xs = x if full or ctl_state is None else ctl_state
            ctl_state, ac = _blocked(
                lambda *a: transition(low_lpg, *a, rec.n_steps), n)(
                xs, rec.scale, rec.eps, p0, u)
            outs["control"] = (ctl_state if ci is None
                               else ctl_state[:, ci], ac)
        ref_c = xr if ci is None else xr[:, ci]
        for side, (out, alpha) in outs.items():
            d = ((out.double() - ref_c).abs() / sc_c).amax(1)
            t = tallies[side]
            t[0] += int((~(d <= MISS_TOL)).sum())
            t[1] += n
            t[2] += float(alpha.double().sum())
    return tallies, ref_alpha


def warm_gaps(rec: FitRecord, lpg, low_lpg=None):
    """{side: [lp gap, gradient gap]} over warmup's recorded evaluations
    whose reference |lp| is under LP_RANGE."""
    out = {"program": [0.0, 0.0]}
    if low_lpg is not None:
        out["control"] = [0.0, 0.0]
    for q, lp, g in rec.warm:
        lr, gr = lpg(q)
        held = lr.abs() < LP_RANGE
        if not bool(held.any()):
            continue
        q, lp, g, lr, gr = (x[held] for x in (q, lp, g, lr, gr))
        gmax = gr.abs().amax(1).clamp(min=1e-300)
        sides = {"program": (lp, g)}
        if low_lpg is not None:
            sides["control"] = low_lpg(q)
        for side, (a, b) in sides.items():
            dlp = (a.double() - lr).abs() / (1.0 + lr.abs())
            dg = (b.double() - gr).abs().amax(1) / gmax
            o = out[side]
            o[0] = max(o[0], float(dlp.nan_to_num(math.inf).max()))
            o[1] = max(o[1], float(dg.nan_to_num(math.inf).max()))
    return out


def warm_product(rec: FitRecord, lpg, hdiag):
    """(warm_q0, warm_mass) of one fit's replayed chains."""
    n, dim = rec.q0.shape
    score = 0.0
    hsum = torch.zeros(dim, dtype=rec.q0.dtype, device=rec.q0.device)
    for a in range(0, n, BLOCK):
        q = rec.q0[a:a + BLOCK]
        _, g = lpg(q)
        h = hdiag(q).clamp(min=1e-300)
        score += float((g * g / h).sum()) / dim
        hsum += h.sum(0)
    ratio = rec.scale * rec.scale * (hsum / n)
    return score / n, float(ratio.log().abs().median())


def readings(records, lpg, hdiag, target, collect, full, iters,
             low_lpg=None):
    """The numbers compared, over every fit's record: {side: {name:
    value}} for the program and, with `low_lpg`, the control.  `hdiag` is
    the reference's diagonal of −∇²lp and `target` dual averaging's
    acceptance target, which the program's numbers of warmup's product
    need."""
    sides = ["program"] + (["control"] if low_lpg is not None else [])
    tally = {s: [0, 0, 0.0] for s in sides}
    ref_alpha = 0.0
    warm = {s: [0.0, 0.0] for s in sides}
    n_warm = 0
    product = [0.0, 0.0]
    for rec in records:
        product = [max(a, b) for a, b in
                   zip(product, warm_product(rec, lpg, hdiag))]
        t, ra = replay(rec, lpg, collect, full, iters, low_lpg)
        for s in sides:
            tally[s] = [a + b for a, b in zip(tally[s], t[s])]
        ref_alpha += ra
        if rec.warm:
            n_warm += len(rec.warm)
            w = warm_gaps(rec, lpg, low_lpg)
            for s in sides:
                warm[s] = [max(a, b) for a, b in zip(warm[s], w[s])]
    out = {}
    for s in sides:
        misses, count, alpha = tally[s]
        r = {"miss": misses / max(count, 1)}
        if full:
            r["accept_gap"] = abs(alpha - ref_alpha) / max(count, 1)
        if n_warm:
            r["warm_lp"], r["warm_grad"] = warm[s]
        if s == "program":
            r["warm_q0"], r["warm_mass"] = product
            r["warm_alpha"] = abs(ref_alpha / max(count, 1) - target)
        out[s] = r
    return out
