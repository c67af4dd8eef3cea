"""L-BFGS with a strong-Wolfe line search (port of
rainier_tpu/optimizer/lbfgs.py; counterpart of optimizer/LBFGS.java and
optimizer/Optimizer.scala's MAP loop).

Several starts run at once along a leading batch axis, as the JAX
package's ``vmap`` of ``minimize`` runs them: every loop goes on while
any start needs it, each start carries its own ``done`` mask, and a
start that has stopped keeps its state.  So one call of the batched
density evaluates every start at each trial point.  The loops are host
loops: each test of their condition waits for the device once
(``COUNTS.syncs``).

One behaviour of the JAX package is not copied (ROADMAP C2.5): where the
zoom runs out of steps it falls back to the point ``lo`` but returns the
gradient at the start of the search (lbfgs.py:143-147).  Here the search
returns the gradient at the point it returns, at the cost of one more
evaluation when that happens.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import config as global_config

C1 = 1e-4   # Armijo (ftol in LBFGS.java)
C2 = 0.9    # curvature (gtol)


class LBFGSState(NamedTuple):
    """One row a start: x, g (B, n); f, k, converged, failed (B,); the
    history ring s_hist, y_hist (B, m, n) and rho (B, m)."""

    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    s_hist: torch.Tensor
    y_hist: torch.Tensor
    rho: torch.Tensor
    k: torch.Tensor
    converged: torch.Tensor
    failed: torch.Tensor


class SearchCounts:
    """What the runs paid since `reset()`: density evaluations (one
    batched call each), host syncs (tests of a loop's condition), line
    searches that fell back to ``lo`` without a Wolfe point (a start
    each), and ``last``, the final LBFGSState of every start of the last
    :func:`lbfgs_map`."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.evaluations = 0
        self.syncs = 0
        self.fallbacks = 0
        self.last = None


#: the process's counts, reset and read by callers that report them
COUNTS = SearchCounts()


def _any(mask) -> bool:
    COUNTS.syncs += 1
    return bool(mask.any())


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _pick(hist, idx):
    """hist[b, idx[b]] for every start b."""
    return hist[torch.arange(hist.shape[0], device=hist.device), idx]


def _two_loop(state: LBFGSState):
    """Two-loop recursion over each start's history ring → descent
    directions (B, n)."""
    m = state.s_hist.shape[1]
    q = state.g
    kmin = torch.clamp(state.k, max=m)
    alphas = []
    for i in range(m):
        idx = (state.k - 1 - i) % m
        valid = i < kmin
        alpha = torch.where(valid, _pick(state.rho, idx)
                            * _dot(_pick(state.s_hist, idx), q),
                            torch.zeros_like(state.f))
        q = q - alpha[:, None] * _pick(state.y_hist, idx)
        alphas.append(alpha)
    # initial Hessian scaling γ = sᵀy / yᵀy of the most recent pair
    last = (state.k - 1) % m
    s_l, y_l = _pick(state.s_hist, last), _pick(state.y_hist, last)
    ys, yy = _dot(s_l, y_l), _dot(y_l, y_l)
    gamma = torch.where((state.k > 0) & (yy > 0), ys / yy,
                        torch.ones_like(ys))
    r = gamma[:, None] * q
    for j in range(m):
        i = m - 1 - j
        idx = (state.k - 1 - i) % m
        valid = i < kmin
        beta = torch.where(valid, _pick(state.rho, idx)
                           * _dot(_pick(state.y_hist, idx), r),
                           torch.zeros_like(state.f))
        r = r + (alphas[i] - beta)[:, None] * _pick(state.s_hist, idx)
    return -r


def _wolfe_line_search(fg: Callable, x, f0, g0, direction, live=None,
                       max_steps: int = 25):
    """Strong-Wolfe search along `direction` for every start where `live`
    (B,) holds: bracket by doubling, then bisection zoom.  Returns
    (alpha, f, g, ok), each start's.  A start that is not live, or whose
    loop has ended, keeps its values."""
    live = torch.ones_like(f0, dtype=torch.bool) if live is None else live
    dg0 = _dot(g0, direction)

    def phi(alpha):
        COUNTS.evaluations += 1
        f, g = fg(x + alpha[:, None] * direction)
        return f, g, _dot(g, direction)

    def sel(mask, a, b):
        return torch.where(mask[:, None] if a.dim() == 2 else mask, a, b)

    # -- bracketing phase ------------------------------------------------
    z = torch.zeros_like(f0)
    alpha = torch.ones_like(f0)
    lo, hi = z, torch.full_like(f0, float("inf"))
    f_lo, dg_lo = f0, dg0
    done = torch.zeros_like(live)
    best_a, best_f, best_g = z, f0, g0
    for _ in range(max_steps):
        run = live & ~done
        if not _any(run):
            break
        f, g, dg = phi(alpha)
        armijo_fail = (f > f0 + C1 * alpha * dg0) | torch.isnan(f)
        curv_ok = torch.abs(dg) <= -C2 * dg0
        success = run & ~armijo_fail & curv_ok
        # found a bracket: [lo, alpha] if Armijo fails or dg >= 0
        bracket = run & (armijo_fail | (dg >= 0))
        hi = torch.where(bracket, alpha, hi)
        moved = run & ~bracket
        lo = torch.where(moved, alpha, lo)
        f_lo = torch.where(moved, f, f_lo)
        dg_lo = torch.where(moved, dg, dg_lo)
        best_a = torch.where(success, alpha, best_a)
        best_f = torch.where(success, f, best_f)
        best_g = sel(success, g, best_g)
        done = done | success | bracket
        alpha = torch.where(run & ~done, alpha * 2.0, alpha)

    # -- zoom phase (bisection) ------------------------------------------
    a, f, g = best_a, best_f, best_g
    ok = best_a > 0
    for _ in range(max_steps):
        run = live & ~ok & torch.isfinite(hi)
        if not _any(run):
            break
        mid = 0.5 * (lo + hi)
        fm, gm, dgm = phi(mid)
        armijo_fail = (fm > f0 + C1 * mid * dg0) | (fm >= f_lo) | \
            torch.isnan(fm)
        curv_ok = torch.abs(dgm) <= -C2 * dg0
        success = run & ~armijo_fail & curv_ok
        hi2 = torch.where(armijo_fail, mid, torch.where(
            dgm * (hi - lo) >= 0, lo, hi))
        hi = torch.where(run, hi2, hi)
        moved = run & ~armijo_fail
        lo = torch.where(moved, mid, lo)
        f_lo = torch.where(moved, fm, f_lo)
        dg_lo = torch.where(moved, dgm, dg_lo)
        a = torch.where(success, mid, a)
        f = torch.where(success, fm, f)
        g = sel(success, gm, g)
        ok = ok | success
    # no Wolfe point: fall back to the best Armijo point, lo, with the
    # gradient there (the JAX package returns g0, the start's: C2.5)
    fall = live & ~ok & (lo > 0)
    g_lo = g0
    if _any(fall):
        COUNTS.evaluations += 1
        COUNTS.fallbacks += int(fall.sum())
        _, g_at = fg(x + lo[:, None] * direction)
        g_lo = sel(fall, g_at, g0)
    a = torch.where(ok, a, lo)
    f = torch.where(ok, f, f_lo)
    g = sel(ok, g, g_lo)
    return a, f, g, (a > 0) & torch.isfinite(f)


def minimize(fg: Callable, x0, m: int = 5, max_iters: int = 500,
             grad_tol: float = 1e-5) -> LBFGSState:
    """Minimize f from each row of x0 (B, n); ``fg(x (B, n)) -> (f (B,),
    grad (B, n))``.  Returns the LBFGSState of every start."""
    B, n = x0.shape
    dtype, dev = x0.dtype, x0.device
    COUNTS.evaluations += 1
    f0, g0 = fg(x0)
    st = LBFGSState(
        x=x0, f=f0, g=g0,
        s_hist=torch.zeros((B, m, n), dtype=dtype, device=dev),
        y_hist=torch.zeros((B, m, n), dtype=dtype, device=dev),
        rho=torch.zeros((B, m), dtype=dtype, device=dev),
        k=torch.zeros(B, dtype=torch.int64, device=dev),
        converged=torch.zeros(B, dtype=torch.bool, device=dev),
        failed=torch.zeros(B, dtype=torch.bool, device=dev))
    rows = torch.arange(B, device=dev)
    for _ in range(max_iters):
        run = (st.k < max_iters) & ~st.converged & ~st.failed
        if not _any(run):
            break
        direction = _two_loop(st)
        # safeguard: if not a descent direction, restart with -g
        dg = _dot(st.g, direction)
        direction = torch.where((dg < 0)[:, None], direction, -st.g)
        alpha, f_new, g_new, ok = _wolfe_line_search(
            fg, st.x, st.f, st.g, direction, run)
        s = alpha[:, None] * direction
        x_new = st.x + s
        y = g_new - st.g
        sy = _dot(s, y)
        slot = st.k % m
        good = (sy > 1e-10)[:, None]
        s_hist, y_hist, rho = (st.s_hist.clone(), st.y_hist.clone(),
                               st.rho.clone())
        s_hist[rows, slot] = torch.where(good, s, torch.zeros_like(s))
        y_hist[rows, slot] = torch.where(good, y, torch.zeros_like(y))
        rho[rows, slot] = torch.where(good[:, 0], 1.0 / sy,
                                      torch.zeros_like(sy))
        gnorm = torch.linalg.vector_norm(g_new, dim=-1)
        converged = gnorm < grad_tol * torch.clamp(
            torch.linalg.vector_norm(x_new, dim=-1), min=1.0)
        new = LBFGSState(x=x_new, f=f_new, g=g_new, s_hist=s_hist,
                         y_hist=y_hist, rho=rho, k=st.k + 1,
                         converged=converged, failed=~ok)
        # a start that has stopped keeps its state
        st = LBFGSState(*[
            torch.where(run.view((B,) + (1,) * (a.dim() - 1)), a, b)
            for a, b in zip(new, st)])
    return st


def lbfgs_map(model, t=None, seed: int = 0, m: int = 5,
              max_iters: int = 500, grad_tol: float = 1e-5,
              n_starts: int = 1, init_scale: float = 1.0, device=None,
              dtype=None):
    """MAP estimate (Model.optimize, core/Model.scala:26-30): maximize the
    joint density with L-BFGS, then evaluate `t` at the optimum.

    ``n_starts > 1`` runs the starts at once: the first is the origin, the
    rest x0 ~ N(0, init_scale²·I) drawn from a ``torch.Generator`` seeded
    by `seed` (so they differ from the JAX package's), and the start with
    the best objective wins.  Returns the flat parameter vector (a tensor
    on the run's device) when `t` is None, else `t`'s value at the
    optimum as numpy arrays, in `t`'s structure."""
    from ..core.generator import Env, draws_first, to_generator, tree_map

    dev = global_config.resolve_device(device)
    dtype = dtype or global_config.dtype()
    cd = model.density()
    cols = cd.column_values(dtype, dev)
    lpg = cd.batched_logp_and_grad_fn()

    def fg(x):
        lp, g = lpg(x, cols)
        return -lp, -g

    n_starts = max(n_starts, 1)
    x0 = torch.zeros((n_starts, cd.n_vars), dtype=dtype, device=dev)
    if n_starts > 1:
        gen = torch.Generator(device=dev).manual_seed(seed)
        x0[1:] = init_scale * torch.randn((n_starts - 1, cd.n_vars),
                                          generator=gen, dtype=dtype,
                                          device=dev)
    sts = minimize(fg, x0, m=m, max_iters=max_iters, grad_tol=grad_tol)
    COUNTS.last = sts
    x = sts.x[torch.argmin(sts.f)]
    if t is None:
        return x
    gen = torch.Generator(device=dev).manual_seed(seed)
    env = Env(1, cd.layout.env_for_lanes(x[:, None]), dev, dtype)
    return tree_map(lambda v: v[0].cpu().numpy(),
                    draws_first(to_generator(t).fn(gen, env)))
