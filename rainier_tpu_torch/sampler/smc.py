"""Tempered Sequential Monte Carlo with systematic resampling (port of
rainier_tpu/sampler/smc.py).

Algorithm (Del Moral, Doucet & Jasra 2006; adaptive tempering as in
Jasra et al. 2011):

* geometric path  log π_β(q) = (1−β)·log r(q) + β·log p(q)  from a
  reference r = N(0, s²·I) on the unconstrained space to the posterior
  log p (its transforms' jacobians are inside log p already);
* each stage picks Δβ by bisection so the incremental-weight effective
  sample size stays at ``ess_target``·N;
* systematic resampling (one uniform, a stratified comb, searchsorted on
  the weights' cumulative sum);
* mutation by ``mutation_steps`` HMC transitions targeting π_β, with a
  diagonal mass estimated from the resampled cloud and one step size for
  every particle, adapted across stages by Robbins–Monro toward 0.65;
* the incremental normalizing constants add up to a log-evidence
  estimate.  It is right only where log p carries every constant.

The particles are the leading batch axis of every tensor.  The stage loop
is a host loop that reads β once a stage (one host sync); the bisection
and everything else stay on the device.  The mutation is the scan path's
``hmc_transition``: no kernel runs here.

On a mesh the particles are split over the ``chains`` axis and the
density over ``data`` (parallel/data.py).  A stage's global steps run on
every rank alike: the log ratios are all-gathered (N floats), so Δβ's
bisection, the ESS and the evidence see every particle; the comb's
uniform is the first chain group's; the resampled cloud is gathered and
each rank keeps its block; the acceptance rate is a mean over every
particle.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .. import config as global_config
from ..parallel import mesh as M
from .leapfrog import ChainState, hmc_transition
from .mass import MassState


class SMCConfig(NamedTuple):
    n_particles: int = 4096
    mutation_steps: int = 3      # HMC transitions per tempering stage
    leapfrog_steps: int = 10     # leapfrog steps per HMC transition
    ess_target: float = 0.5      # keep ESS ≥ ess_target · N each stage
    initial_step_size: float = 0.25
    target_accept: float = 0.65  # Robbins–Monro step-size target
    max_stages: int = 100        # bound on tempering stages
    init_scale: float = 1.0      # std-dev of the N(0, s²I) reference
    bisect_iters: int = 30


class SMCResult(NamedTuple):
    particles: torch.Tensor     # (N, d) equally-weighted posterior draws
    log_evidence: torch.Tensor  # scalar log Ẑ = log ∫ prior·like dq
    n_stages: torch.Tensor      # scalar int, tempering stages used
    betas: torch.Tensor         # (max_stages,) β after each stage (0-padded)
    ess: torch.Tensor           # (max_stages,) pre-resampling ESS per stage
    accept_rates: torch.Tensor  # (max_stages,) mean mutation accept rate
    step_sizes: torch.Tensor    # (max_stages,) mutation step size used


def _log_ess(log_w):
    """log ESS of unnormalized log-weights: 2·lse(w) − lse(2w)."""
    return (2.0 * torch.logsumexp(log_w, dim=-1)
            - torch.logsumexp(2.0 * log_w, dim=-1))


def systematic_comb(log_w, u0, n: int):
    """Systematic resampling given its one uniform `u0`: the comb
    (i + u0)/n searched (left side) in the normalized weights' cumulative
    sum, indices clipped at n − 1."""
    cum = torch.cumsum(torch.softmax(log_w, dim=-1), dim=-1)
    comb = (torch.arange(n, dtype=log_w.dtype, device=log_w.device)
            + u0) / n
    return torch.clamp(torch.searchsorted(cum, comb), 0, n - 1)


def systematic_resample(gen, log_w, n: int):
    """Systematic (stratified-comb) resampling: indices into the particle
    axis, its uniform drawn from the torch.Generator `gen`."""
    u0 = torch.rand((), generator=gen, dtype=log_w.dtype,
                    device=log_w.device)
    return systematic_comb(log_w, u0, n)


def _choose_delta(log_ratio, beta, ess_target, n, iters):
    """Largest Δβ ∈ (0, 1−β] with ESS(exp(Δβ·log_ratio)) ≥ ess_target·N,
    by `iters` bisection steps on the device.  log_ratio is
    log p(q) − log r(q) per particle."""
    target = math.log(ess_target * n)
    hi = 1.0 - beta

    def ess_ok(delta):
        return _log_ess(delta * log_ratio) >= target

    lo, hi_ = torch.zeros_like(hi), hi
    for _ in range(iters):
        mid = 0.5 * (lo + hi_)
        ok = ess_ok(mid)
        lo, hi_ = torch.where(ok, mid, lo), torch.where(ok, hi_, mid)
    # if even the full remaining jump keeps ESS healthy, finish the path
    delta = torch.where(ess_ok(hi), hi, lo)
    # never stall: bisection can return 0 when ESS is already below target
    return torch.maximum(delta, 1e-4 * (1.0 - beta) + 1e-7)


def run_smc(logp_fn, n_vars: int, cfg: SMCConfig = SMCConfig(),
            seed: int = 0, dtype=None, device=None, lpg_fn=None,
            mesh=None) -> SMCResult:
    """Run adaptive tempered SMC against ``logp_fn: (N, d) -> (N,)``, the
    full unconstrained posterior log-density of every particle at once,
    differentiable by autograd unless `lpg_fn` (q -> (logp, gradient))
    gives the gradient.  Draws come from a ``torch.Generator`` seeded by
    `seed` (and the chain group, on a `mesh`, whose ``chains`` axis
    splits the particles; `particles` holds all of them on every rank)."""
    dtype = dtype or global_config.dtype()
    dev = global_config.resolve_device(device)
    n, d = cfg.n_particles, n_vars
    groups = M.axis_size(mesh, M.CHAINS)
    if n % groups:
        raise ValueError(f"{n} particles do not split over {groups} chain "
                         "shards")
    lo, hi = M.chain_sharding(mesh).block(n)
    s2 = cfg.init_scale ** 2
    log_norm_r = 0.5 * d * math.log(2 * math.pi * s2)

    def logr_fn(q):
        return -0.5 * torch.sum(q * q, dim=-1) / s2 - log_norm_r

    def lpg_autograd(q):
        with torch.enable_grad():
            x = q.detach().requires_grad_(True)
            lp = logp_fn(x)
            (g,) = torch.autograd.grad(lp.sum(), x)
        return lp.detach(), g

    lpg = lpg_fn or lpg_autograd

    def every(x):
        return M.all_gather(x, mesh, M.CHAINS)

    def tempered(beta):
        def lpg_t(q):
            lp, g = lpg(q)
            return ((1.0 - beta) * logr_fn(q) + beta * lp,
                    (1.0 - beta) * (-q / s2) + beta * g)
        return lpg_t

    def logp(q):
        with torch.no_grad():
            return logp_fn(q)

    gen = torch.Generator(device=dev).manual_seed(
        M.group_seed(seed, M.axis_rank(mesh, M.CHAINS)))
    q = cfg.init_scale * torch.randn((hi - lo, d), generator=gen,
                                     dtype=dtype, device=dev)
    lp_q, lr_q = logp(q), logr_fn(q)
    zero = torch.zeros((), dtype=dtype, device=dev)
    beta, log_z = zero, zero
    step_size = torch.full((), cfg.initial_step_size, dtype=dtype,
                           device=dev)
    betas, ess, accepts, steps = (torch.zeros(cfg.max_stages, dtype=dtype,
                                              device=dev) for _ in range(4))
    stage = 0
    while stage < cfg.max_stages and float(beta) < 1.0:
        # -- reweight: pick Δβ adaptively, accumulate evidence ----------
        log_ratio = every(lp_q - lr_q)
        delta = _choose_delta(log_ratio, beta, cfg.ess_target, n,
                              cfg.bisect_iters)
        log_w = delta * log_ratio
        log_z = log_z + torch.logsumexp(log_w, dim=-1) - math.log(n)
        beta = beta + delta
        ess[stage] = torch.exp(_log_ess(log_w))

        # -- resample: the comb over every particle ---------------------
        u0 = M.broadcast(torch.rand((), generator=gen, dtype=log_w.dtype,
                                    device=log_w.device), mesh, M.CHAINS)
        q = every(q)[systematic_comb(log_w, u0, n)]

        # -- mutate: HMC targeting π_β with the cloud's diagonal mass ----
        var = torch.clamp(torch.var(q, dim=0, unbiased=False), min=1e-10)
        q = q[lo:hi]
        mass = MassState(diag=var.expand(hi - lo, d))
        lpg_t = tempered(beta)
        lp_t, g_t = lpg_t(q)
        state = ChainState(q=q, potential=-lp_t, grad=g_t)
        acc_sum = zero
        for _ in range(cfg.mutation_steps):
            res = hmc_transition(gen, state, step_size, cfg.leapfrog_steps,
                                 mass, lpg_t)
            state = res.state
            acc_sum = acc_sum + M.chain_mean(torch.exp(res.log_accept),
                                             mesh)
        accept = acc_sum / cfg.mutation_steps

        # -- Robbins–Monro step-size update toward target accept ---------
        steps[stage] = step_size
        step_size = step_size * torch.exp(
            (accept - cfg.target_accept) / math.sqrt(1.0 + stage))
        q = state.q
        lp_q, lr_q = logp(q), logr_fn(q)
        betas[stage] = beta
        accepts[stage] = accept
        stage += 1
    return SMCResult(particles=every(q), log_evidence=log_z,
                     n_stages=torch.tensor(stage, device=dev), betas=betas,
                     ess=ess, accept_rates=accepts, step_sizes=steps)


def smc(model, cfg: Optional[SMCConfig] = None, seed: int = 0,
        dtype=None, device=None, mesh=None):
    """Model-level entry point: returns (Trace, SMCResult).

    The Trace holds the N equally-weighted particles as 4 pseudo-chains
    (particles are exchangeable, so r̂/ESS diagnostics and `predict` work
    unchanged), on the run's device; ``SMCResult.log_evidence`` is the
    model evidence estimate.  `mesh` (parallel.make_mesh, passed by every
    rank) splits the particles over ``chains`` and the rows over
    ``data``; every rank returns every particle."""
    from ..core.trace import Trace
    from ..parallel.data import ShardedDensity

    if mesh is not None:
        M.check_mesh(mesh)
    cfg = cfg or SMCConfig()
    dtype = dtype or global_config.dtype()
    dev = global_config.resolve_device(device)
    cd = model.density()
    density = ShardedDensity(cd, mesh, M.DATA, dtype, dev)
    result = run_smc(density.logp, cd.n_vars, cfg, seed=seed, dtype=dtype,
                     device=dev, lpg_fn=density.lpg, mesh=mesh)
    n_pseudo = 4 if cfg.n_particles % 4 == 0 else 1
    chains = result.particles.reshape(n_pseudo, cfg.n_particles // n_pseudo,
                                      cd.n_vars)
    trace = Trace(chains=chains, model=model, compiled=cd, config=cfg)
    return trace, result
