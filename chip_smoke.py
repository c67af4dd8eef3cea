#!/usr/bin/env python3
"""On-card smoke test of rainier_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the fused HMC kernel for eight models from the checkout's
sources (one nvcc each, all started together), and then, each phase
printing one line:

* the model-built Neal's funnel (column-free): the kernel against its
  plain PyTorch version in both RNG modes, ``Model.sample(kernel="fused!")``
  at 1024 chains with its posterior checked, the kernel's time at the
  main path's shapes and at bench.py's throughput configuration;
* the 100k-row, 10-feature logistic regression of
  ``benchmarks/models.py::logistic_regression`` (its data regenerated
  here from the same seed): the MAP and Laplace covariance by Newton's
  method in numpy f64, the kernel's density and gradient at full width
  against autograd on the plain version and against f64, the kernel
  against its plain version over 100 iterations;
* the README regression (200 rows) through ``Model.sample(kernel="fused!")``,
  checked against the numpy least-squares fit, and the kernel's time;
* the logistic regression through ``Model.sample(kernel="fused!")``,
  checked against the Laplace reference, the kernel's time, and the same
  run on the scan path for its ``sample_s``;
* the same data under a correlated prior, betas ~ ``MVNormal`` (AR(1)
  at the prior's scale, built with the Vec API), whose rows read a
  Cholesky factor that the kernel reads whole: its Laplace reference on
  its design in the sampler's coordinates, the kernel's density at full
  width against the plain version and f64, ``Model.sample(kernel="fused!")``
  with pooled adaptation held to the Laplace reference, the betas it
  draws against L·z, and the kernel against its plain version at the
  main path's shapes;
* the same logistic regression observed as two merged blocks of 60,000
  and 40,000 rows (two row spaces): its density at full width against
  the plain version, f64 and the one-block model's kernel, and its kernel
  streamed against synchronous bit for bit;
* GLMMPoisson2 of ``benchmarks/models.py::glmm_poisson`` (100 sites × 40
  years, 146 parameters, two integer index columns; its data regenerated
  here from the same seed): a scan-path run, the kernel's density and
  gradient at its last draws and at inits against autograd on the plain
  version and against f64, the kernel against its plain version over 100
  iterations from those draws, ``Model.sample(kernel="fused!")`` held to
  the scan-path run by a two-sample test of per-chain moments, and the
  kernel's time;
* ``benchmarks/models.py::glmm_large`` (10,000 group effects × 5 rows,
  10,002 parameters, centred VIP; its data regenerated here from the same
  seed), whose chain state lives in the kernel's workspace: a scan-path
  run keeping mu, sd and every 100th effect, the kernel's density and
  gradient at that run's last full-width states and at inits against
  autograd on the plain version and against f64 (bounds widened to each
  point's f32 conditioning from three Hessian-vector products), the
  kernel against its plain version over 100 iterations from those
  states at 1001 chains, a ragged last block (the chains compared on
  every coordinate after 20 iterations, the law of all the draws),
  ``Model.sample(kernel="fused!", collect_idx=...)`` held to the
  scan-path run by per-chain moments, and the kernel against its plain
  version at the main path's shapes, compared the same way;
* the 2M-row logistic regression of ``benchmarks/data_scale.py:35-50``
  (the 100k model at n = 2,000,000, 512 chains, 100 + 100 iterations of
  HMC(8)), whose 88 MB of columns exceed the card's L2, so its launches
  stream their row tiles: a scan-path run, the streamed density at full
  width at its last draws and at inits against the plain version and
  f64, the kernel streamed against synchronous bit for bit (on the 100k
  logistic too) and, at the main path's 512 chains, against its plain
  version, and ``Model.sample(kernel="fused!")`` held to the scan-path
  run by per-chain moments.  Its phases print their seconds and the card's peak
  memory.

Any failed check raises and exits nonzero.  The third line from the end
is a JSON object with each kernel's launches on its main path, error
against the plain version, times and bound; then the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``.  Without
a CUDA card it exits nonzero and prints no result.  It imports nothing
of JAX.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks at the full 700 W limit (NVIDIA data sheet): f32 outside
# the tensor cores, and device memory bandwidth
PEAK_F32_OPS = 67e12
PEAK_HBM_BYTES = 3.35e12

N_WARMUP, N_DRAWS, MAIN_CHAINS, N_STEPS = 1000, 1000, 1024, 5
THROUGHPUT_CHAINS, THROUGHPUT_ITERS, THROUGHPUT_EPS = 524288, 500, 0.18
PARITY_CHAINS, PARITY_ITERS = 1000, 200
REL_TOL = 1e-4   # |kernel - plain| <= REL_TOL * max(1, |plain|), per chain
DEVICE = "cuda"

# README regression (benchmarks/models.py:30-41)
README_ROWS, README_SEED = 200, 0
# 100k logistic regression (benchmarks/models.py:145-159) and its run on
# the main path: fixed-step HMC with the sampler's defaults otherwise
LOGIT_ROWS, LOGIT_FEATURES, LOGIT_SEED, LOGIT_PRIOR_SD = 100_000, 10, 5, 5.0
# draws cut from 1000 to 200 to make room for the 2M-row path
LOGIT_WARMUP, LOGIT_DRAWS, LOGIT_STEPS = 1000, 200, 5
LOGIT_PARITY_ITERS = 100
# its kernel streamed against synchronous: bit for bit
# (iterations cut from 100 to 50 to make room for the untiled density)
STREAM_AB_CHAINS, STREAM_AB_ITERS = 1000, 50
# the logistic's kernel timed again at the main path's width over this
# many iterations (its main path's sample_s is the 1000-iteration time)
LOGIT_TIME_ITERS = 100
LOGIT_CHECK_MAP, LOGIT_CHECK_INIT = 1024, 64
# GLMMPoisson2 (benchmarks/models.py:111-142) and its runs: the main path
# at 1024 chains, and a scan-path run of the same configuration
GLMM_SITES, GLMM_YEARS, GLMM_SEED = 100, 40, 4
# draws cut from 1000 to 500 to make room for the untiled density
GLMM_WARMUP, GLMM_DRAWS, GLMM_STEPS = 1000, 500, 5
GLMM_PARITY_ITERS, GLMM_CHECK_INIT = 100, 64
GLMM_MOMENT_Z = 5.0   # two-sample bound on each per-chain moment's mean
# glmm_large (benchmarks/models.py:162-202, BASELINE config 5) and its
# runs, collecting mu, sd and every 100th group effect (layout slots 0, 1,
# 2, 102, ..., 9902)
LARGE_GROUPS, LARGE_OBS, LARGE_SEED, LARGE_LAM = 10_000, 5, 6, 1.0
# draws cut from 1000 to 200 to make room for the 2M-row path
LARGE_WARMUP, LARGE_DRAWS, LARGE_STEPS = 1000, 200, 5
# parity iterations cut from 100 to 50 to make room for the untiled density
LARGE_PARITY_ITERS, LARGE_CHECK_INIT = 50, 64
# its kernel runs blocks of 4 chains, a warp each: 1001 chains leave a
# last block of one chain and three copies of it, each in its own slot of
# the workspace
LARGE_PARITY_CHAINS = 1001
# at |lp| ~ 1e5 an f32 ulp is 0.008 nats, so accepts flip and the
# trajectories part within 100 iterations: the chains are compared after
# this many, and the law of all the draws
LARGE_AGREE_AT = 20
LARGE_COLLECT_EVERY = 100
# the 100k logistic's data under a correlated prior on the coefficients,
# betas = MVNormal(0, Σ).latent_vec() with Σᵢⱼ = 25 · 0.5^|i−j| (an AR(1)
# correlation at the original prior's scale), built with the Vec API; its
# run on the main path is the 100k logistic's
MV_RHO = 0.5
# the 100k logistic observed as two merged blocks of these rows: two row
# spaces, the one-block model's density; its kernel streamed against
# synchronous over this many iterations
SPLIT_ROWS, SPLIT_AB_ITERS = 60_000, 20
# the 2M-row logistic regression of benchmarks/data_scale.py:35-50 (the
# 100k model's graph at n = 2,000,000; docs/performance.md:60-82): 88 MB
# of columns, past the card's L2, so its launches stream their tiles
LOGIT2M_ROWS, LOGIT2M_CHAINS = 2_000_000, 512
# draws cut from 100 to 50 to make room for the untiled density
LOGIT2M_WARMUP, LOGIT2M_DRAWS, LOGIT2M_STEPS = 100, 50, 8
# the density check at this many of the scan-path run's last draws and
# inits (the f64 truth holds several (rows, points) arrays)
LOGIT2M_CHECK_DRAWS, LOGIT2M_CHECK_INIT = 128, 32
# streamed against synchronous and against the plain version, at the main
# path's width over this many iterations
LOGIT2M_AB_ITERS = 2


def funnel(rt):
    """Neal's funnel, 10 dims, built through the model API
    (__graft_entry__.py:9-14)."""
    y = rt.Normal(0.0, 3.0).latent()
    xv = rt.Normal(0.0, (y / 2).exp()).latent_vec(9)
    return rt.Model.track_({y} | set(xv.to_list())), y


def readme_regression(rt):
    """benchmarks/models.py:30-41: (model, xs, ys, (sigma, alpha, betas))."""
    rng = np.random.default_rng(README_SEED)
    xs = [tuple(r) for r in rng.normal(size=(README_ROWS, 3))]
    ys = [float(np.dot(x, [1.0, -2.0, 0.5]) + 0.7 + 0.3 * rng.normal())
          for x in xs]
    sigma = rt.Exponential(1).latent()
    alpha = rt.Normal(0, 1).latent()
    betas = rt.Normal(0, 1).latent_vec(3)
    model = rt.Model.observe(ys, rt.Vec.from_(xs).map(
        lambda t: rt.Normal(alpha + rt.Vec.of(*t).dot(betas), sigma)))
    return model, np.asarray(xs), np.asarray(ys), (sigma, alpha, betas)


def logistic_regression(rt, n=None):
    """benchmarks/models.py:145-159 at n rows (default LOGIT_ROWS), data
    regenerated from its seed: (model, x (n, p), ys (n,)); the parameters
    are alpha, then betas."""
    from rainier_tpu_torch.compute import real as R

    rng = np.random.default_rng(LOGIT_SEED)
    n, p = n or LOGIT_ROWS, LOGIT_FEATURES
    x = rng.normal(size=(n, p)).astype(np.float64)
    true_b = rng.normal(size=p)
    logits = x @ true_b - 0.5
    ys = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(float)
    alpha = rt.Normal(0, LOGIT_PRIOR_SD).latent()
    betas = rt.Normal(0, LOGIT_PRIOR_SD).latent_vec(p)
    lin = alpha + R.MatVec(R.MatColumn(x), betas.element)
    lh = R.RowSum(rt.Bernoulli(lin.logistic()).log_density_at(
        R.Column(ys)), n)
    return rt.Model.likelihood(lh), x, ys


def mv_cov():
    """The coefficients' prior covariance: AR(1) at the prior's scale."""
    i = np.arange(LOGIT_FEATURES)
    return LOGIT_PRIOR_SD ** 2 * MV_RHO ** np.abs(i[:, None] - i[None, :])


def mvnormal_logistic(rt, x, ys):
    """The logistic regression of `x`, `ys` with betas ~ MVNormal(0,
    mv_cov()), built with the documented Vec API (docs/model.md:23-30):
    each element of betas reads the Cholesky factor, a (10, 10) column
    that the kernel reads whole.  Returns (model, alpha, betas)."""
    alpha = rt.Normal(0, LOGIT_PRIOR_SD).latent()
    betas = rt.MVNormal([0.0] * x.shape[1], mv_cov()).latent_vec()
    model = rt.Model.observe(list(ys), rt.Vec.from_(
        [tuple(r) for r in x]).map(lambda t: rt.Bernoulli(
            (alpha + rt.Vec.of(*t).dot(betas)).logistic())))
    return model, alpha, betas


def split_logistic(rt, x, ys):
    """The logistic regression of `x`, `ys` (the 100k model's graph)
    observed as two merged blocks, rows [0, SPLIT_ROWS) and the rest,
    under one set of parameters: two row spaces, one density."""
    from rainier_tpu_torch.compute import real as R

    alpha = rt.Normal(0, LOGIT_PRIOR_SD).latent()
    betas = rt.Normal(0, LOGIT_PRIOR_SD).latent_vec(x.shape[1])
    cut, n = SPLIT_ROWS, len(ys)
    return rt.Model.likelihoods([R.RowSum(rt.Bernoulli(
        (alpha + R.MatVec(R.MatColumn(x[a:b]), betas.element)).logistic())
        .log_density_at(R.Column(ys[a:b])), b - a)
        for a, b in ((0, cut), (cut, n))])


def glmm_poisson(rt):
    """benchmarks/models.py:111-142, data regenerated from its seed: year
    polynomial + per-year eps + per-site alphas, counts indexed by (year,
    site) through two IntColumn gathers."""
    from rainier_tpu_torch.compute import real as R

    rng = np.random.default_rng(GLMM_SEED)
    n_sites, n_years = GLMM_SITES, GLMM_YEARS
    years = np.linspace(-0.95, 0.95, n_years)
    mu = rt.Normal(0, 10).latent()
    sd_alpha = rt.Uniform(0, 2).latent()
    alphas = rt.Normal(mu, sd_alpha).latent_vec(n_sites)
    sd_year = rt.Uniform(0, 1).latent()
    betas = rt.Normal(0, 10).latent_vec(3)
    eps = rt.Normal(0.0, sd_year).latent_vec(n_years)
    year_col = R.Column(np.repeat(years, n_sites))
    year_idx = R.IntColumn(np.repeat(np.arange(n_years), n_sites))
    site_idx = R.IntColumn(np.tile(np.arange(n_sites), n_years))
    year_effect = (year_col * betas[0] + year_col * year_col * betas[1]
                   + year_col * year_col * year_col * betas[2]
                   + R.Gather(eps.element, year_idx))
    log_lam = year_effect + R.Gather(alphas.element, site_idx)
    true_sites = rng.normal(np.log(20.0), 0.4, size=n_sites)
    true_eps = rng.normal(0.0, 0.2, size=n_years)
    true_log_lam = (np.repeat(true_eps - 0.1 * years, n_sites)
                    + np.tile(true_sites, n_years))
    counts = rng.poisson(np.exp(true_log_lam)).astype(float)
    lh = R.RowSum(rt.Poisson(log_lam.exp()).log_density_at(
        R.Column(counts)), n_years * n_sites)
    return rt.Model.likelihood(lh)


def glmm_large(rt):
    """benchmarks/models.py:162-202, data regenerated from its seed: one
    VectorParameter of group effects (VIP weight LARGE_LAM) gathered by
    an IntColumn into a Poisson likelihood."""
    from rainier_tpu_torch.compute import real as R

    rng = np.random.default_rng(LARGE_SEED)
    n = LARGE_GROUPS * LARGE_OBS
    mu = rt.Normal(0, 1).latent()
    sd = rt.Exponential(1.0).latent()
    effects = rt.vip_latent_vec(mu, sd, LARGE_GROUPS, lam=LARGE_LAM)
    group_idx = R.IntColumn(np.repeat(np.arange(LARGE_GROUPS), LARGE_OBS))
    true_effects = rng.normal(np.log(5.0), 0.3, size=LARGE_GROUPS)
    counts = rng.poisson(
        np.exp(np.repeat(true_effects, LARGE_OBS))).astype(float)
    log_lam = R.Gather(effects.element, group_idx)
    lh = R.RowSum(rt.Poisson(log_lam.exp()).log_density_at(
        R.Column(counts)), n)
    return rt.Model.likelihood(lh)


def large_collect():
    """mu, sd and every LARGE_COLLECT_EVERY-th group effect."""
    return np.r_[0, 1, np.arange(2, 2 + LARGE_GROUPS, LARGE_COLLECT_EVERY)]


def logistic_design(x):
    """The 100k logistic's design in the sampler's coordinates: the latent
    of Normal(0, s) is s·z with z standard (the Scale injection of
    core/continuous.py), so lin = [s·1, s·x] · (z_alpha, z_betas)."""
    s = LOGIT_PRIOR_SD
    return np.hstack([np.full((x.shape[0], 1), s), s * x])


def mv_design(cd, x, alpha, betas):
    """The MVNormal logistic's design in the sampler's coordinates, its
    columns in the layout's order: alpha = s·z_alpha and betas = L·z, so
    lin = [s·1, x·L] · (z_alpha, z)."""
    from rainier_tpu_torch.compute.compiler import find_parameters

    (pa,) = find_parameters([alpha])
    (pz,) = find_parameters(betas.to_list())
    block = {pa.id: np.full((x.shape[0], 1), LOGIT_PRIOR_SD),
             pz.id: x @ np.linalg.cholesky(mv_cov())}
    d = np.empty((x.shape[0], cd.n_vars))
    for p, (a, b) in zip(cd.layout.parameters, cd.layout.slices):
        d[:, a:b] = block[p.id]
    return d


def laplace_design(design, ys):
    """MAP and inverse negative Hessian by Newton's method in numpy f64 of
    a logistic regression with this design and a standard-normal prior,
    in the sampler's coordinates: (map (d,), cov)."""
    w = np.zeros(design.shape[1])
    eye = np.eye(design.shape[1])
    for _ in range(100):
        mu = 1.0 / (1.0 + np.exp(-(design @ w)))
        g = design.T @ (ys - mu) - w
        h = (design.T * (mu * (1 - mu))) @ design + eye
        step = np.linalg.solve(h, g)
        w = w + step
        if np.max(np.abs(step)) < 1e-13:
            break
    mu = 1.0 / (1.0 + np.exp(-(design @ w)))
    h = (design.T * (mu * (1 - mu))) @ design + eye
    return w, np.linalg.inv(h)


def laplace_reference(x, ys):
    """MAP and inverse negative Hessian of the 100k logistic posterior
    (prior included) in the sampler's coordinates (`laplace_design`)."""
    return laplace_design(logistic_design(x), ys)


def design_truth(design, ys, qs, device):
    """lp and gradient at every column of qs (d, m), in float64 on the
    card, of a logistic regression with this design (n, d) and a
    standard-normal prior in the sampler's coordinates: the reference
    both f32 versions are held to."""
    import torch

    xa = torch.as_tensor(design, dtype=torch.float64, device=device)
    y = torch.as_tensor(ys, dtype=torch.float64, device=device)[:, None]
    b = qs.to(device=device, dtype=torch.float64)
    lin = xa @ b
    ll = y * lin - torch.nn.functional.softplus(lin)
    lp = ll.sum(0) - 0.5 * (b * b).sum(0) - b.shape[0] * 0.5 * np.log(
        2 * np.pi)
    return lp, xa.T @ (y - torch.sigmoid(lin)) - b


def logistic_truth(x, ys, qs, device):
    """`design_truth` of the 100k logistic (`logistic_design`)."""
    return design_truth(logistic_design(x), ys, qs, device)


def whole_bytes(cd):
    """Bytes of the columns that no row space reads row by row: the
    kernel reads them whole, outside the rows."""
    rows = {j for sp in cd.row_split().spaces for j in sp.columns}
    return sum(4 * c.values.size for j, c in enumerate(cd.columns)
               if j not in rows)


def check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def timed(fn, device, reps: int = 1, warm: bool = True):
    """(result of the last call, mean ms per call): CUDA events on the
    card, the host clock elsewhere."""
    import torch

    if device.type == "cuda":
        if warm:
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return out, (time.perf_counter() - t0) * 1e3 / reps


def agreement(a, b, tol=REL_TOL):
    """(fraction of chains whose final q agrees within `tol`, max |Δq|,
    mean |Δacc|, equal divergences) between kernel output a and plain
    output b."""
    rel = ((a[0] - b[0]).abs() / b[0].abs().clamp(min=1.0)).amax(dim=0)
    return (float((rel <= tol).float().mean()),
            float((a[0] - b[0]).abs().max()),
            float((a[2] - b[2]).abs().mean()),
            bool((a[3] == b[3]).all()))


def chaotic(F, cd, q0, kw, ker, plain, agree_at, tol, device):
    """Where the trajectories are chaotic, f32 differences grow until the
    chains part, and the law of the draws is what stays: the two runs'
    draws of every iteration (outputs `ker` and `plain` of `fused_hmc`
    and its plain version on q0 and `kw`) held to each other by
    `moment_z`, and the chains compared after `agree_at` iterations, at
    that iteration's draw.  Where `kw` collects some coordinates only,
    every coordinate is compared there instead: the final q of both
    versions run again for `agree_at` iterations.  Returns (the outputs
    with the state after `agree_at` iterations in place of the final q,
    the text to print, the largest z)."""
    z, stat, param = moment_z(ker[1].permute(2, 0, 1),
                              plain[1].permute(2, 0, 1), device)
    end = agreement(ker, plain, tol)[0]
    law = (f"; draws of all {ker[1].shape[0]} iterations max {z:.3f} "
           f"standard errors apart (chain {stat}s of collected coordinate "
           f"{param}; bound {GLMM_MOMENT_Z}); at the end {end:.4f} of "
           f"chains within {tol} rel")
    if kw.get("collect_idx") is None:
        at = [out[1][agree_at - 1] for out in (ker, plain)]
    else:
        short = dict(kw, n_iterations=agree_at, collect_every=0,
                     collect_idx=None)
        if kw.get("noise") is not None:
            short["noise"] = tuple(x[:agree_at] for x in kw["noise"])
        at = [F.fused_hmc(cd, q0, **short)[0],
              F.fused_hmc_reference(cd, q0, **short)[0]]
        law += f"; compared after {agree_at} it on all {cd.n_vars} " \
            f"coordinates"
    ker, plain = ((x,) + out[1:] for x, out in zip(at, (ker, plain)))
    return ker, plain, law, z


def agree_frac(n_iters, dlp_mean):
    """The least fraction of chains that must agree after `n_iters`
    iterations.  An accept flips where log u falls between the two
    versions' log α, which differ by at most |Δlp| at two points, and
    log u - log α has a density of at most 1: so a chain flips with
    probability at most 2·E|Δlp| per iteration, with E|Δlp| `dlp_mean`
    from a density check near the states run.  Over many iterations the
    bound falls below one half, where it says little: half the chains is
    the floor."""
    return max(0.5, 1.0 - 2.0 * n_iters * dlp_mean)


def parity_inputs(cd, device, n_chains, n_iters, explicit_noise: bool,
                  center=None, var=None, start=None, n_steps=N_STEPS,
                  collect_every=1, collect_idx=None):
    """(q0, keywords of `fused_hmc`) for a comparison run: per-chain ε and
    Σ̂, every `collect_every`-th draw collected (of `collect_idx`'s
    coordinates).  q0 ~ N(center, var) and Σ̂ = var times a per-chain
    factor in [0.5, 2] (standard normal without them); or, with `start`
    = (q0 (dim, n), ε (n,), Σ̂ (n, dim)), those.  The explicit noise is
    drawn on the card."""
    import torch

    rng = np.random.default_rng(1 if explicit_noise else 2)
    dim = cd.n_vars
    center = np.zeros(dim) if center is None else center
    var = np.ones(dim) if var is None else var

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    if start is None:
        q0 = t(center[:, None] + np.sqrt(var)[:, None]
               * rng.normal(size=(dim, n_chains)))
        eps = t(rng.uniform(0.3, 0.9, n_chains))
        imd = t(var * rng.uniform(0.5, 2.0, (n_chains, dim)))
    else:
        q0, eps, imd = (t(x) for x in start)
    kw = dict(step_size=eps, n_steps=n_steps, n_iterations=n_iters, seed=11,
              inv_mass_diag=imd, collect_every=collect_every,
              collect_idx=collect_idx)
    if explicit_noise:
        gen = torch.Generator(device=device).manual_seed(1)
        kw["noise"] = (
            torch.randn((n_iters, dim, n_chains), generator=gen,
                        device=device),
            torch.rand((n_iters, n_chains), generator=gen, device=device)
            .clamp(min=1.1920929e-7))
    return q0, kw


def parity_phase(F, cd, device, n_chains, n_iters, explicit_noise: bool,
                 center=None, var=None, min_frac=0.99, tol=REL_TOL,
                 max_dacc=0.01, start=None, collect_idx=None,
                 agree_at=None, n_steps=N_STEPS):
    """Kernel vs plain version on the inputs of `parity_inputs`, a ragged
    chain count and every draw collected.  With `agree_at`, the
    comparison of `chaotic`.  Returns (max |Δq|, the kernel's ms, the
    plain version's ms), each timed once, cold."""
    q0, kw = parity_inputs(cd, device, n_chains, n_iters, explicit_noise,
                           center, var, start, n_steps,
                           collect_idx=collect_idx)
    a, ker_ms = timed(lambda: F.fused_hmc(cd, q0, **kw), device, 1, False)
    b, plain_ms = timed(lambda: F.fused_hmc_reference(cd, q0, **kw),
                        device, 1, False)
    law, z = "", 0.0
    if agree_at is not None:
        a, b, law, z = chaotic(F, cd, q0, kw, a, b, agree_at, tol, device)
    frac, max_err, dacc, div_eq = agreement(a, b, tol)
    mode = "explicit noise" if explicit_noise else "on-device Philox"
    print(f"phase kernel-vs-plain ({mode}): {n_chains} chains x {n_iters} "
          f"it x {n_steps} steps: {frac:.4f} of chains within {tol} rel "
          f"after {agree_at or n_iters} it (need {min_frac:.4f}), max |dq| "
          f"{max_err:.3g}, mean |d accept| {dacc:.3g}, divergences equal "
          f"{div_eq}{law}; kernel {ker_ms:.1f} ms, plain {plain_ms:.1f} ms",
          flush=True)
    check(frac >= min_frac and dacc < max_dacc and div_eq
          and z <= GLMM_MOMENT_Z, (frac, dacc, div_eq, z))
    return max_err, ker_ms, plain_ms


def workspace_call_bytes(em):
    """Bytes one density call must move through a chain's workspace slot
    (0 for a model whose state stays in the thread): x read, g written,
    and the row-invariant values and their adjoints each written and
    read."""
    return 4 * (2 * em.n_vars + 4 * em.n_inv) if em.workspace else 0


def kernel_bound_ms(em, n_chains, n_iters, n_steps, collect_every, F,
                    col_bytes=0, n_collect=None, past_l2=False,
                    noise=False, whole=0):
    """Least time the card could take for one fused_hmc call: the larger
    of its bytes over the memory rate and its operations over the f32
    rate (Philox integer operations counted at the f32 rate).  For a
    model with its state in the workspace, each density call's workspace
    bytes and each leapfrog step's momentum and position (read and
    written) count too.  Columns past the card's L2 (`past_l2`) come from
    device memory in every density call, so their bytes count once a
    call.  With explicit `noise` the kernel reads every iteration's
    momenta and uniform and runs no RNG.  The `whole` bytes of columns
    read whole, outside the rows, count once a density call."""
    ops = n_chains * n_iters * F.op_count(em, n_steps, rng=not noise)
    n_out = n_iters // collect_every if collect_every else 0
    dim = em.n_vars
    n_collect = dim if n_collect is None else n_collect
    calls = n_iters * n_steps + 1
    # columns, q0, ε, Σ̂ read; final q, accept, divergences, draws written
    nbytes = col_bytes * (calls if past_l2 else 1) + whole * calls + 4 * (
        n_chains * (dim + 1 + dim) + n_chains * (dim + 2)
        + n_out * n_collect * n_chains)
    if noise:
        nbytes += 4 * n_iters * n_chains * (dim + 1)
    if em.workspace:
        nbytes += n_chains * (calls * workspace_call_bytes(em)
                              + n_iters * n_steps * 4 * 4 * dim)
    return _bound(ops, nbytes)


def _bound(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


@contextlib.contextmanager
def phase(name, device):
    """Prints the seconds the block took and, on the card, its peak
    device memory."""
    import torch

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    yield
    peak = (f", peak device memory "
            f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
            if cuda else "")
    print(f"phase time, {name}: {time.perf_counter() - t0:.1f} s{peak}",
          flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def layout(F, em, n_chains):
    """How a launch over n_chains lays out the chains: lanes a chain and
    chains a block."""
    return (f"{F.lanes_per_chain(em)} lanes a chain, "
            f"{F.chains_per_block(em, n_chains)} chains a block of "
            f"{F.threads_per_block(em, n_chains)} threads")


def build_all(F, models):
    """Build every model's kernel, one nvcc each, all started together;
    print each build's sizes and what ptxas reports."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(models)) as pool:
        built = dict(zip(models, pool.map(F.build, models.values())))
    print(f"phase build: {len(models)} kernels in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    ems = {}
    for name, (kernels, secs, em) in built.items():
        ptxas = " | ".join(
            line.split("ptxas info    : ")[-1].strip()
            for line in kernels.log.splitlines()
            if "registers" in line or "spill" in line)
        spaces = "; ".join(f"{sp.n_rows} rows of {sp.row_width} floats, "
                           f"{sp.row_ops} ops a row, tile {sp.tile_rows} "
                           f"rows" for sp in em.spaces) or "no rows"
        print(f"phase build: {name}: {layout(F, em, MAIN_CHAINS)}; "
              f"{em.n_vars} dims, {em.ops} ops per "
              f"logp+grad apart from rows, row spaces: {spaces}, "
              f"{whole_bytes(models[name])} bytes of columns read whole, "
              f"{em.n_inv} row-invariant values, "
              f"workspace {em.workspace} floats a chain; "
              f"{len(em.source.splitlines())} lines emitted; {secs:.2f} s; "
              f"ptxas: {ptxas}", flush=True)
        ems[name] = em
    return ems


def time_kernel(F, cd, em, tr, n_steps, device, col_bytes, what, reps=1,
                min_frac=0.99, tol=REL_TOL, max_dacc=0.01, agree_at=None,
                n_iters=None, collect_idx=None, explicit_noise=False,
                whole=0):
    """The kernel at a main path's shapes, on its warmup product's inputs:
    per-chain ε and Σ̂, every draw collected (of `collect_idx`'s
    coordinates), q0 the main path's last full-width states, with
    `explicit_noise` drawn on the card in place of Philox; held to its
    plain version as the parity phases are (at least `min_frac` of
    chains within `tol`, mean |Δaccept| < `max_dacc`, divergences
    equal), with `agree_at` by `chaotic`.
    `n_iters` cuts the run's depth (default: the main path's)."""
    import torch

    n_chains, n_iters = tr.chains.shape[0], n_iters or tr.chains.shape[1]
    q0, kw = parity_inputs(
        cd, device, n_chains, n_iters, explicit_noise,
        start=(tr.final_q.T, tr.step_size, tr.mass.diag), n_steps=n_steps,
        collect_idx=collect_idx)
    kw["seed"] = 1
    ker, ker_ms = timed(lambda: F.fused_hmc(cd, q0, **kw), device, reps,
                        reps > 1)
    plain, plain_ms = timed(lambda: F.fused_hmc_reference(cd, q0, **kw),
                            device, 1, False)
    law, z = "", 0.0
    if agree_at is not None:
        ker, plain, law, z = chaotic(F, cd, q0, kw, ker, plain, agree_at,
                                     tol, device)
    frac, max_err, dacc, div_eq = agreement(ker, plain, tol)
    n_collect = cd.n_vars if collect_idx is None else len(collect_idx)
    bound_ms, bound_by = kernel_bound_ms(em, n_chains, n_iters, n_steps, 1,
                                         F, col_bytes, n_collect,
                                         noise=explicit_noise, whole=whole)
    print(f"phase kernel at main-path shapes, {what} ({n_chains} chains x "
          f"{n_iters} it x {n_steps} steps, {layout(F, em, n_chains)}, "
          f"{'explicit noise' if explicit_noise else 'on-device Philox'}, "
          f"{n_collect} coordinates of each draw collected, workspace "
          f"{F.workspace_bytes(em, n_chains)} bytes): kernel "
          f"{ker_ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.4f} "
          f"ms ({bound_by}), {frac:.4f} of chains agree within {tol} rel "
          f"after {agree_at or n_iters} it (need {min_frac:.4f}), "
          f"max |dq| {max_err:.3g}, mean |d accept| {dacc:.3g}, "
          f"divergences equal {div_eq}{law}", flush=True)
    check(frac >= min_frac and dacc < max_dacc and div_eq
          and z <= GLMM_MOMENT_Z, (what, frac, dacc, div_eq, z))
    return dict(max_abs_err=max_err, ms=ker_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def rank_rhat(tr, device):
    """Max over the parameters of the rank-normalized split r̂ (Vehtari et
    al. 2021), the statistic of Trace.diagnostics(rank_normalized=True),
    computed in f64 on the card: pooled ranks with ties averaged, normal
    scores, then split-chain r̂.  The host pipeline takes minutes for the
    GLMM's 146 parameters × 1024 chains × 1000 draws."""
    import torch

    x = torch.as_tensor(tr.chains, dtype=torch.float64, device=device)
    h = x.shape[1] // 2
    x = torch.cat([x[:, :h], x[:, h:2 * h]], dim=0)        # (2m, h, k)
    m, k = x.shape[0], x.shape[2]
    n = m * h
    v, order = torch.sort(x.reshape(n, k), dim=0)
    new = torch.ones_like(v, dtype=torch.bool)
    new[1:] = v[1:] != v[:-1]
    group = torch.cumsum(new, dim=0) - 1                   # tie groups
    pos = torch.arange(1, n + 1, dtype=torch.float64,
                       device=device)[:, None].expand(n, k)
    total = torch.zeros_like(v).scatter_add_(0, group, pos)
    count = torch.zeros_like(v).scatter_add_(0, group, torch.ones_like(v))
    ranks = torch.empty_like(v).scatter_(
        0, order, (total / count.clamp(min=1.0)).gather(0, group))
    z = torch.special.ndtri((ranks - 0.375) / (n + 0.25)).reshape(m, h, k)
    means = z.mean(dim=1)
    b = h / (m - 1) * ((means - means.mean(dim=0)) ** 2).sum(dim=0)
    w = (((z - means[:, None]) ** 2).sum(dim=1) / (h - 1)).mean(dim=0)
    var = (h - 1) / h * w + b / h
    return float(torch.sqrt(var / w.clamp(min=1e-300)).max())


def moment_z(a, b, device):
    """Two-sample test of two runs' chains (m, n, k): for each parameter,
    every chain's mean and variance over its draws; the runs' averages
    over chains differ by z standard errors, SE² = var_a/m_a + var_b/m_b
    with the variances over chains.  Returns (max z, which statistic,
    which parameter)."""
    import torch

    stats = []
    for x in (a, b):
        t = torch.as_tensor(x, dtype=torch.float64, device=device)
        stats.append((t.mean(dim=1), t.var(dim=1)))
    z = torch.stack([
        (sa.mean(0) - sb.mean(0)).abs()
        / torch.sqrt(sa.var(0) / sa.shape[0] + sb.var(0) / sb.shape[0])
        for sa, sb in zip(*stats)])                        # (2, k)
    i = int(torch.argmax(z))
    return float(z.max()), ("mean", "variance")[i // z.shape[1]], \
        i % z.shape[1]


def funnel_phases(F, cd, model, y, em, device, smi):
    """The column-free funnel's phases; returns its JSON entry."""
    import torch

    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    parity_phase(F, cd, device, PARITY_CHAINS, PARITY_ITERS, True)
    parity_phase(F, cd, device, PARITY_CHAINS, PARITY_ITERS, False)

    cfg = SamplerConfig(N_WARMUP, N_DRAWS, sampler=HMC(N_STEPS))
    F.fused_hmc.launches = 0
    tr = model.sample(cfg, n_chains=MAIN_CHAINS, seed=0, kernel="fused!",
                      device=device)
    launches = F.fused_hmc.launches
    ys = tr.evaluate(y)
    mean_y, var_y = float(np.mean(ys)), float(np.var(ys))
    rhat = rank_rhat(tr, device)
    rhat_host = max(d.r_hat for d in tr.diagnostics(rank_normalized=True))
    check(abs(rhat - rhat_host) < 1e-9, ("rank r_hat card vs host", rhat,
                                         rhat_host))
    print(f"phase main path, funnel: Model.sample(kernel='fused!') "
          f"{MAIN_CHAINS} chains x ({N_WARMUP} warmup + {N_DRAWS} draws), "
          f"HMC({N_STEPS}): fused_hmc launches {launches}, mean(y) "
          f"{mean_y:.4f}, var(y) {var_y:.4f}, rank-r_hat max {rhat:.5f}, "
          f"accept {float(np.mean(tr.accept_rate())):.3f}, divergences "
          f"{tr.divergences()}, timings {tr.timings}", flush=True)
    check(launches >= 1, f"fused_hmc launches {launches}")
    check(np.all(np.isfinite(tr.chains)) and tr.chains.shape == (
        MAIN_CHAINS, N_DRAWS, cd.n_vars), tr.chains.shape)
    check(abs(mean_y) < 0.3 and abs(var_y / 9.0 - 1.0) < 0.15,
          (mean_y, var_y))
    check(rhat < 1.01, rhat)

    # 2 ms a call: twenty calls, so that a host stall in one of them
    # (an allocation right after the main path) does not set the mean
    entry = time_kernel(F, cd, em, tr, N_STEPS, device, 0, "funnel",
                        reps=20)
    # the same with explicit noise (the host_rng counterpart)
    noise_entry = time_kernel(F, cd, em, tr, N_STEPS, device, 0,
                              "funnel", reps=20, explicit_noise=True)

    # throughput: bench.py's configuration on the model-built funnel
    qz = torch.zeros((cd.n_vars, THROUGHPUT_CHAINS), device=device)
    tp_kw = dict(step_size=THROUGHPUT_EPS, n_steps=N_STEPS, seed=0,
                 collect_every=0)
    _, tp_ms = timed(lambda: F.fused_hmc(
        cd, qz, n_iterations=THROUGHPUT_ITERS, **tp_kw), device, 3)
    _, tp_plain_ms = timed(lambda: F.fused_hmc_reference(
        cd, qz, n_iterations=50, **tp_kw), device, 1, False)
    evals = THROUGHPUT_CHAINS * THROUGHPUT_ITERS * N_STEPS
    tp_bound_ms, tp_bound_by = kernel_bound_ms(
        em, THROUGHPUT_CHAINS, THROUGHPUT_ITERS, N_STEPS, 0, F)
    print(f"phase throughput: {THROUGHPUT_CHAINS} chains x "
          f"{THROUGHPUT_ITERS} it x {N_STEPS} steps, eps {THROUGHPUT_EPS}: "
          f"kernel {tp_ms:.3f} ms = {evals / tp_ms * 1e3:.4g} grad evals/s "
          f"(bound {tp_bound_ms:.3f} ms, {tp_bound_by}); plain version "
          f"{tp_plain_ms * THROUGHPUT_ITERS / 50:.1f} ms (50 it timed, "
          f"scaled) on {smi}", flush=True)
    return [{"name": "fused_hmc", "route": "cuda",
             "source": "rainier_tpu_torch/csrc/fused_hmc.cu",
             "replaces": "rainier_tpu/ops/hmc_pallas.py:506",
             "launches": launches, **entry, "library_ms": None},
            {"name": "fused_hmc (funnel, explicit noise)", "route": "cuda",
             "source": "rainier_tpu_torch/csrc/fused_hmc.cu",
             "replaces": "rainier_tpu/ops/hmc_pallas.py:244",
             "launches": 0, **noise_entry, "library_ms": None}]


def density_phase(F, cd, em, x, ys, w_map, cov, device):
    """The logistic's density check (`density_check`) at LOGIT_CHECK_MAP
    q drawn from the Laplace approximation and LOGIT_CHECK_INIT
    overdispersed inits, where the gradient is large, against the f64
    truth of `logistic_truth`."""
    q = check_points(w_map, cov, device)
    return density_check(F, cd, em, q, logistic_truth(x, ys, q, device),
                         LOGIT_CHECK_MAP, "near the MAP", device,
                         "rainier_tpu/ops/hmc_pallas.py:302")


def check_points(w_map, cov, device):
    """LOGIT_CHECK_MAP q drawn from the Laplace approximation (w_map, cov)
    and LOGIT_CHECK_INIT overdispersed inits, as (d, m) f32 on `device`."""
    import torch

    from rainier_tpu_torch.sampler import SamplerConfig

    rng = np.random.default_rng(7)
    near = w_map[:, None] + np.linalg.cholesky(cov) @ rng.normal(
        size=(w_map.size, LOGIT_CHECK_MAP))
    inits = SamplerConfig().init_scale * rng.normal(
        size=(w_map.size, LOGIT_CHECK_INIT))
    return torch.as_tensor(np.hstack([near, inits]), dtype=torch.float32,
                           device=device)


def density_check(F, cd, em, q, truth, n_near, near_name, device,
                  replaces, cond=None):
    """rt_logp_grad_launch against autograd on the plain version and
    against the f64 `truth` (lp, g), at full width, at every column of q:
    the first `n_near` columns are `near_name`, the rest inits.
    Tolerances per point: |Δlp| within 0.01 nats or two f32 ulps of lp,
    whichever is larger (two f32 results of the same sum differ by
    rounding alone up to an ulp); |Δg| within 1e-4 of the point's max
    |g|.  `cond` = (lp (n,), g (dim, n)) from `conditioning` widens each
    bound to what the value moves when the inputs move by two f32
    rounding units, where that is larger.  Returns (mean |Δlp| kernel vs
    plain over the near points, the JSON entry)."""
    import torch

    before = F.logp_grad.launches, F.logp_grad.streamed
    # one warm-up launch, then the mean of three
    (lp_k, g_k), ms = timed(lambda: F.logp_grad(cd, q), device, 3)
    (lp_p, g_p), plain_ms = timed(lambda: F.logp_grad_reference(cd, q),
                                  device, 1, False)
    lp_t, g_t = truth
    check(F.logp_grad.launches == before[0] + 4, "logp_grad did not launch")
    streamed = F.logp_grad.streamed - before[1]
    tol_lp, tol_g, gmax = density_bars(lp_t, g_t)
    if cond is not None:
        tol_lp = torch.maximum(tol_lp, cond[0].float())
        tol_g = torch.maximum(tol_g, cond[1].float())
    groups = {near_name: slice(0, n_near), "inits": slice(n_near, None)}
    worst, lines = {}, []
    for name, (lp, g) in (("kernel-vs-plain", (lp_k - lp_p, g_k - g_p)),
                          ("kernel-vs-f64", (lp_k - lp_t.float(),
                                             g_k - g_t.float())),
                          ("plain-vs-f64", (lp_p - lp_t.float(),
                                            g_p - g_t.float()))):
        dlp, dg = lp.abs(), (g.abs().amax(0) / gmax)
        rel, rel_g = dlp / tol_lp, (g.abs() / tol_g).amax(0)
        worst[name] = (float(dlp.max()), float(rel.max()),
                       float(rel_g.max()))
        lines.append(f"{name}: " + ", ".join(
            f"{k} max |dlp| {float(dlp[sl].max()):.3g} (mean "
            f"{float(dlp[sl].mean()):.3g}, {float(rel[sl].max()):.3f} of "
            f"the tolerance), max |dg|/max|g| {float(dg[sl].max()):.3g} "
            f"({float(rel_g[sl].max()):.3f} of the tolerance)"
            for k, sl in groups.items()))
    n = q.shape[1]
    ops = n * em.density_ops()
    nbytes = em.row_bytes() + whole_bytes(cd) + 4 * 2 * n * (
        cd.n_vars + 1) + n * workspace_call_bytes(em)
    bound_ms, bound_by = _bound(ops, nbytes)
    print(f"phase density at full width: rt_logp_grad_launch at {n} q, "
          f"{streamed} of 4 launches streamed "
          f"({n_near} {near_name}, {n - n_near} inits; "
          f"max |g| {float(gmax[groups[near_name]].max()):.4g} and "
          f"{float(gmax[groups['inits']].max()):.4g}, |lp| up to "
          f"{float(lp_t.abs().max()):.4g}); " + "; ".join(lines)
          + f"; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    for k in ("kernel-vs-plain", "kernel-vs-f64"):
        check(worst[k][1] <= 1.0 and worst[k][2] <= 1.0, (k, worst[k]))
    near_dlp = float((lp_k - lp_p).abs()[groups[near_name]].mean())
    return near_dlp, dict(
        name="rt_logp_grad_launch", route="cuda",
        source="rainier_tpu_torch/csrc/fused_hmc.cu", replaces=replaces,
        max_abs_err=worst["kernel-vs-plain"][0], ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def density_bars(lp_t, g_t):
    """`density_check`'s tolerances at the truth (lp (n,), g (dim, n)):
    (|Δlp| bound (n,), |Δg| bound (dim, n), max |g| (n,))."""
    import torch

    tol_lp = torch.clamp(2 * torch.finfo(torch.float32).eps
                         * lp_t.abs().float(), min=0.01)
    gmax = g_t.abs().amax(0).float()
    return tol_lp, 1e-4 * gmax.expand_as(g_t), gmax


def conditioning(lp_grad64, q):
    """What lp and g move, to first order, when each input q_d moves by
    two f32 rounding units (2·eps·|q_d|), the moves of all inputs added
    in absolute value: (lp (n,), g (dim, n)), by finite differences of
    `lp_grad64` (q (dim, n) f64 -> (lp, g)) in f64, one input at a time.
    Two f32 evaluations of a density differ by this much where its
    intermediates round: GLMMPoisson2's log-rate is mu + sd·z, and at a
    draw far out in its non-centred ridge the two terms are large and
    nearly cancel, so their rounding reaches exp(log-rate) magnified."""
    import torch

    x0 = q.double()
    lp0, g0 = lp_grad64(x0)
    step = 2 * torch.finfo(torch.float32).eps * x0.abs()
    cond_g = torch.zeros_like(g0)
    for d in range(x0.shape[0]):
        x = x0.clone()
        x[d] += step[d]
        cond_g += (lp_grad64(x)[1] - g0).abs()
    return (g0 * step).abs().sum(0), cond_g


def readme_phases(F, readme, em, device):
    """The README regression through Model.sample(kernel="fused!"),
    against the numpy least-squares fit; returns its JSON entry."""
    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    model, xs, ys, (sigma, alpha, betas) = readme
    cd = model.density()
    xa = np.hstack([np.ones((xs.shape[0], 1)), xs])
    coef = np.linalg.lstsq(xa, ys, rcond=None)[0]
    resid_sd = float(np.sqrt(np.sum((ys - xa @ coef) ** 2)
                             / (xs.shape[0] - xa.shape[1])))
    cfg = SamplerConfig(N_WARMUP, N_DRAWS, sampler=HMC(N_STEPS))
    F.fused_hmc.launches = 0
    tr = model.sample(cfg, n_chains=MAIN_CHAINS, seed=0, kernel="fused!",
                      device=device)
    launches = F.fused_hmc.launches
    draws = np.hstack([tr.evaluate(alpha)[:, None],
                       tr.evaluate(betas.element)])
    sig = tr.evaluate(sigma)
    mean, sd = draws.mean(0), draws.std(0)
    z = np.abs(mean - coef) / sd
    rhat = rank_rhat(tr, device)
    print(f"phase main path, README regression: Model.sample(kernel="
          f"'fused!') {MAIN_CHAINS} chains x ({N_WARMUP} warmup + {N_DRAWS}"
          f" draws), HMC({N_STEPS}): fused_hmc launches {launches}, "
          f"rank-r_hat max {rhat:.5f}, (alpha, betas) means "
          f"{np.round(mean, 5).tolist()} vs least squares "
          f"{np.round(coef, 5).tolist()}: max {float(z.max()):.4f} "
          f"posterior SD apart, sigma mean {float(sig.mean()):.5f} vs "
          f"residual SD {resid_sd:.5f}, accept "
          f"{float(np.mean(tr.accept_rate())):.3f}, divergences "
          f"{tr.divergences()}, timings {tr.timings}", flush=True)
    check(launches >= 1, f"fused_hmc launches {launches}")
    check(np.all(np.isfinite(tr.chains)), "non-finite draws")
    check(rhat < 1.01, rhat)
    check(float(z.max()) < 0.2, z)
    check(abs(float(sig.mean()) / resid_sd - 1.0) < 0.05,
          (float(sig.mean()), resid_sd))
    entry = time_kernel(F, cd, em, tr, N_STEPS, device,
                        em.row_bytes(), "README regression",
                        reps=3)
    return {"name": "fused_hmc (README regression, one tile)",
            "route": "cuda", "source": "rainier_tpu_torch/csrc/fused_hmc.cu",
            "replaces": "rainier_tpu/ops/hmc_pallas.py:280",
            "launches": launches, **entry, "library_ms": None}


def logistic_main(F, model, cd, em, w_map, cov, device, min_frac,
                  what="logistic regression", pooled=False):
    """A logistic regression through Model.sample(kernel="fused!"),
    against its Laplace reference, then timed against its plain version
    over LOGIT_TIME_ITERS iterations with the logistic parity phases' bar
    (`min_frac` within 1e-3 rel); `pooled` adapts ε and Σ̂ pooled over the
    chains.  Returns (its JSON entry's numbers and launches, the
    trace)."""
    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    cfg = SamplerConfig(LOGIT_WARMUP, LOGIT_DRAWS, sampler=HMC(LOGIT_STEPS),
                        pooled_adaptation=pooled)
    F.fused_hmc.launches = 0
    tr = model.sample(cfg, n_chains=MAIN_CHAINS, seed=0, kernel="fused!",
                      device=device)
    launches = F.fused_hmc.launches
    flat = tr.flat().astype(np.float64)
    sd_ref = np.sqrt(np.diag(cov))
    dmean = np.abs(flat.mean(0) - w_map) / sd_ref
    dsd = np.abs(flat.std(0) / sd_ref - 1.0)
    rhat = rank_rhat(tr, device)
    print(f"phase main path, {what}: Model.sample(kernel="
          f"'fused!') {MAIN_CHAINS} chains x ({LOGIT_WARMUP} warmup + "
          f"{LOGIT_DRAWS} draws), HMC({LOGIT_STEPS}), "
          f"{'pooled' if pooled else 'per-chain'} adaptation, "
          f"{em.n_rows} rows x "
          f"{LOGIT_FEATURES} features: fused_hmc launches {launches}, "
          f"rank-r_hat max {rhat:.5f}, means max {float(dmean.max()):.4f} "
          f"Laplace SD from the MAP, SDs max {float(dsd.max()):.4f} off the "
          f"Laplace SDs, accept {float(np.mean(tr.accept_rate())):.3f}, "
          f"divergences {tr.divergences()}, step size median "
          f"{float(np.median(tr.step_size)):.4g}, timings {tr.timings}",
          flush=True)
    check(launches >= 1, f"fused_hmc launches {launches}")
    check(np.all(np.isfinite(tr.chains)), "non-finite draws")
    check(rhat < 1.01, rhat)
    check(float(dmean.max()) < 0.1, dmean)
    check(float(dsd.max()) < 0.1, dsd)
    entry = time_kernel(F, cd, em, tr, LOGIT_STEPS, device, em.row_bytes(),
                        what, min_frac=min_frac, tol=1e-3, max_dacc=0.02,
                        n_iters=LOGIT_TIME_ITERS, whole=whole_bytes(cd))
    return {"route": "cuda", "source": "rainier_tpu_torch/csrc/fused_hmc.cu",
            "launches": launches, **entry, "library_ms": None}, tr


def scan_timing(model, tr, device, what):
    """The logistic's main path on the scan path (seed 1, the same
    configuration): its sample_s beside the kernel's `tr`, the
    comparison of ROADMAP C1."""
    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    cfg = SamplerConfig(LOGIT_WARMUP, LOGIT_DRAWS, sampler=HMC(LOGIT_STEPS))
    tr_scan = model.sample(cfg, n_chains=MAIN_CHAINS, seed=1, kernel="scan",
                           device=device)
    print(f"phase scan path, {what}: Model.sample(kernel='scan') "
          f"{MAIN_CHAINS} chains x ({LOGIT_WARMUP} warmup + {LOGIT_DRAWS} "
          f"draws), HMC({LOGIT_STEPS}): accept "
          f"{float(np.mean(tr_scan.accept_rate())):.3f}, timings "
          f"{tr_scan.timings}; the kernel's sample_s "
          f"{tr.timings['sample_s']} s against the scan path's "
          f"{tr_scan.timings['sample_s']} s", flush=True)
    check(np.all(np.isfinite(tr_scan.chains)), "non-finite scan-path draws")


def mvnormal_phases(F, mv, cd, em, x, ys, device):
    """The 100k logistic under the MVNormal prior: its Laplace reference
    (on its design, `mv_design`), the density at full width near the MAP
    and at inits, the main path held to the Laplace reference as the
    logistic's is, the betas it draws (Trace.evaluate) against L·z in
    numpy, and the kernel against its plain version at the main path's
    shapes.  Returns its JSON entries."""
    from rainier_tpu_torch.compute.compiler import find_parameters

    model, alpha, betas = mv
    design = mv_design(cd, x, alpha, betas)
    t0 = time.perf_counter()
    w_map, cov = laplace_design(design, ys)
    print(f"phase Laplace reference, MVNormal logistic: Newton in f64 on "
          f"the design [5, x L] in the sampler's coordinates, MAP "
          f"{np.round(w_map, 5).tolist()}, Laplace SDs "
          f"{np.round(np.sqrt(np.diag(cov)), 6).tolist()} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    q = check_points(w_map, cov, device)
    dlp_mean, density_entry = density_check(
        F, cd, em, q, design_truth(design, ys, q, device), LOGIT_CHECK_MAP,
        "near the MAP", device, "rainier_tpu/ops/hmc_pallas.py:300")
    del q, design

    # pooled adaptation: adapted per chain, the chains' ε and Σ̂ differ
    # along the posterior's correlated directions (the AR(1) prior
    # whitened), and rank-r̂ stays at 1.016 over 200 draws (1.017 on the
    # scan path) and 1.011 over 600; pooled, 1.002 over 200
    entry, tr = logistic_main(F, model, cd, em, w_map, cov, device,
                              agree_frac(LOGIT_TIME_ITERS, dlp_mean),
                              "MVNormal logistic", pooled=True)
    # betas on the model's scale: L·z from the draws of z, in numpy f64
    (pz,) = find_parameters(betas.to_list())
    a, b = cd.layout.slices[cd.layout.parameters.index(pz)]
    want = tr.flat()[:, a:b].astype(np.float64) @ np.linalg.cholesky(
        mv_cov()).T
    got = np.stack(tr.evaluate(betas.to_list()), axis=1)
    err = float(np.abs(got - want).max())
    print(f"phase Trace.evaluate, MVNormal logistic: betas at "
          f"{got.shape[0]} draws against L z in numpy: max |d| {err:.3g}, "
          f"posterior means {np.round(got.mean(0), 4).tolist()}",
          flush=True)
    check(got.shape == want.shape and err <= 1e-9 * max(
        1.0, float(np.abs(want).max())), ("betas", got.shape, err))
    return [{"name": "fused_hmc (MVNormal logistic, columns read whole)",
             "replaces": "rainier_tpu/ops/hmc_pallas.py:282", **entry},
            {**density_entry, "name": "rt_logp_grad_launch (MVNormal "
                                      "logistic, columns read whole)",
             "launches": 0}]


def split_phases(F, cd, em, lcd, x, ys, w_map, cov, device):
    """The 100k logistic as two row spaces (`split_logistic`):
    rt_logp_grad_launch at the one-block density phase's points held to
    the plain version, to the f64 truth and to the one-block model's
    kernel (`lcd`) with the same bars, and its kernel streamed against
    synchronous bit for bit in both RNG modes.  Returns its density's
    JSON entry."""
    import torch

    q = check_points(w_map, cov, device)
    truth = logistic_truth(x, ys, q, device)
    _, entry = density_check(F, cd, em, q, truth, LOGIT_CHECK_MAP,
                             "near the MAP", device,
                             "rainier_tpu/ops/hmc_pallas.py:300")
    (lp2, g2), (lp1, g1) = F.logp_grad(cd, q), F.logp_grad(lcd, q)
    tol_lp, tol_g, _ = density_bars(*truth)
    rel_lp = float(((lp2 - lp1).abs() / tol_lp).max())
    rel_g = float(((g2 - g1).abs() / tol_g).max())
    print(f"phase two row spaces, logistic {SPLIT_ROWS} + "
          f"{em.n_rows - SPLIT_ROWS} rows: rt_logp_grad_launch at "
          f"{q.shape[1]} q against the one-block model's kernel: max |dlp| "
          f"{float((lp2 - lp1).abs().max()):.3g} ({rel_lp:.3f} of the "
          f"tolerance), max |dg| {float((g2 - g1).abs().max()):.3g} "
          f"({rel_g:.3f} of the tolerance)", flush=True)
    check(rel_lp <= 1.0 and rel_g <= 1.0, ("two spaces", rel_lp, rel_g))
    del q, truth, lp1, g1, lp2, g2
    torch.cuda.empty_cache()
    stream_phase(F, cd, device, STREAM_AB_CHAINS, SPLIT_AB_ITERS,
                 LOGIT_STEPS, f"logistic {SPLIT_ROWS} + "
                 f"{em.n_rows - SPLIT_ROWS}", center=w_map,
                 var=np.diag(cov))
    return {**entry, "name": "rt_logp_grad_launch (logistic regression "
                             "in two row spaces)", "launches": 0}


def glmm_phases(F, model, cd, em, device):
    """GLMMPoisson2: the scan-path run, the density at full width at its
    last draws and at inits, kernel vs plain from those draws, the main
    path held to the scan-path run, and the kernel at the main path's
    shapes.  Returns its JSON entries."""
    import torch

    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    cfg = SamplerConfig(GLMM_WARMUP, GLMM_DRAWS, sampler=HMC(GLMM_STEPS))

    def summary(tr):
        return (f"rank-r_hat max {rank_rhat(tr, device):.5f}, accept "
                f"{float(np.mean(tr.accept_rate())):.3f}, divergences "
                f"{tr.divergences()}, step size median "
                f"{float(np.median(tr.step_size)):.4g}, timings "
                f"{tr.timings}")

    # the scan path is held against the JAX package by the CPU tests: it
    # is this main path's reference
    tr_scan = model.sample(cfg, n_chains=MAIN_CHAINS, seed=1, kernel="scan",
                           device=device)
    print(f"phase scan path, GLMMPoisson2: Model.sample(kernel='scan') "
          f"{MAIN_CHAINS} chains x ({GLMM_WARMUP} warmup + {GLMM_DRAWS} "
          f"draws), HMC({GLMM_STEPS}), {GLMM_SITES} sites x {GLMM_YEARS} "
          f"years, {cd.n_vars} parameters: {summary(tr_scan)}", flush=True)

    # density at the scan-path run's last draws (one a chain) and at
    # inits, against f32 autograd and f64 on the card
    last = tr_scan.chains[:, -1, :].T
    inits = cfg.init_scale * np.random.default_rng(8).normal(
        size=(cd.n_vars, GLMM_CHECK_INIT))
    q = torch.as_tensor(np.hstack([last, inits]), dtype=torch.float32,
                        device=device)
    cols64 = tuple(c.double() if c.is_floating_point() else c
                   for c in cd.column_values(torch.float32, device))
    lanes64 = F.density_lanes(cd, cols64)

    def lp_grad64(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            lp = lanes64(x)
            return lp.detach(), torch.autograd.grad(lp.sum(), x)[0]

    dlp_mean, density_entry = density_check(
        F, cd, em, q, lp_grad64(q.double()), MAIN_CHAINS, "scan-path draws",
        device, "rainier_tpu/ops/hmc_pallas.py:157",
        cond=conditioning(lp_grad64, q))

    # kernel vs plain from the scan-path run's last draws, with its
    # per-chain ε and Σ̂; the bar of the logistic's parity phases
    start = (last[:, :PARITY_CHAINS], tr_scan.step_size[:PARITY_CHAINS],
             tr_scan.mass.diag[:PARITY_CHAINS])
    for explicit in (True, False):
        parity_phase(F, cd, device, PARITY_CHAINS, GLMM_PARITY_ITERS,
                     explicit,
                     min_frac=agree_frac(GLMM_PARITY_ITERS, dlp_mean),
                     tol=1e-3, max_dacc=0.02, start=start)

    # the main path: chains start i.i.d. and adapt per chain, so each
    # run's chains are i.i.d. draws of one law whether or not they have
    # converged, and the two runs' per-chain moments must agree
    F.fused_hmc.launches = 0
    tr = model.sample(cfg, n_chains=MAIN_CHAINS, seed=0, kernel="fused!",
                      device=device)
    launches = F.fused_hmc.launches
    z, stat, param = moment_z(tr.chains, tr_scan.chains, device)
    print(f"phase main path, GLMMPoisson2: Model.sample(kernel='fused!') "
          f"{MAIN_CHAINS} chains x ({GLMM_WARMUP} warmup + {GLMM_DRAWS} "
          f"draws), HMC({GLMM_STEPS}): fused_hmc launches {launches}, "
          f"{summary(tr)}; per-chain means and variances against the "
          f"scan-path run: max {z:.3f} standard errors apart (chain "
          f"{stat}s of parameter {param}; bound {GLMM_MOMENT_Z})",
          flush=True)
    check(launches >= 1, f"fused_hmc launches {launches}")
    check(np.all(np.isfinite(tr.chains)) and tr.chains.shape == (
        MAIN_CHAINS, GLMM_DRAWS, cd.n_vars), tr.chains.shape)
    check(z <= GLMM_MOMENT_Z, (z, stat, param))
    entry = time_kernel(F, cd, em, tr, GLMM_STEPS, device,
                        em.row_bytes(), "GLMMPoisson2",
                        min_frac=agree_frac(GLMM_PARITY_ITERS, dlp_mean),
                        tol=1e-3, max_dacc=0.02, agree_at=GLMM_PARITY_ITERS)
    return [{"name": "fused_hmc (GLMMPoisson2, integer index columns)",
             "route": "cuda",
             "source": "rainier_tpu_torch/csrc/fused_hmc.cu",
             "replaces": "rainier_tpu/ops/hmc_pallas.py:157",
             "launches": launches, **entry, "library_ms": None},
            {**density_entry, "name": "rt_logp_grad_launch (GLMMPoisson2)",
             "launches": 0}]


def large_conditioning(lanes64, q):
    """`conditioning` for glmm_large from three Hessian-vector products in
    f64, not one density call per input: the density is a sum of terms
    in (mu, sd, z_i), so each group effect z_i couples only to itself, mu
    and sd, and H's columns for mu and sd (H e_mu, H e_sd) and its
    diagonal over the effects (H · 1 over the effects) give every entry
    (H is symmetric).  Returns (lp (n,), g (dim, n)) as `conditioning`
    does, each input moved by two f32 rounding units."""
    import torch

    x = q.double().detach().requires_grad_(True)
    with torch.enable_grad():
        lp = lanes64(x)
        (g,) = torch.autograd.grad(lp.sum(), x, create_graph=True)

        def hvp(rows):
            v = torch.zeros_like(x)
            v[rows] = 1.0
            return torch.autograd.grad((g * v).sum(), x,
                                       retain_graph=True)[0].abs()

        h_mu, h_sd, h_z = hvp(slice(0, 1)), hvp(slice(1, 2)), \
            hvp(slice(2, None))
    step = 2 * torch.finfo(torch.float32).eps * x.detach().abs()
    cond_g = h_mu * step[0] + h_sd * step[1]
    cond_g[2:] += h_z[2:] * step[2:]
    cond_g[0] += (h_mu[2:] * step[2:]).sum(0)
    cond_g[1] += (h_sd[2:] * step[2:]).sum(0)
    return (g.detach() * step).abs().sum(0), cond_g


def large_phases(F, model, cd, em, device):
    """glmm_large: the scan-path run, the density at full width at its
    last states and at inits, kernel vs plain from those states, the main
    path held to the scan-path run, and the kernel at the main path's
    shapes.  Every run keeps only the collected coordinates of each draw;
    the full-width states come from the scan-path run's `final_q`.
    Returns its JSON entries."""
    import torch

    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    cfg = SamplerConfig(LARGE_WARMUP, LARGE_DRAWS, sampler=HMC(LARGE_STEPS))
    idx = large_collect()

    def summary(tr):
        return (f"rank-r_hat max {rank_rhat(tr, device):.5f}, accept "
                f"{float(np.mean(tr.accept_rate())):.3f}, divergences "
                f"{tr.divergences()}, step size median "
                f"{float(np.median(tr.step_size)):.4g}, timings "
                f"{tr.timings}")

    tr_scan = model.sample(cfg, n_chains=MAIN_CHAINS, seed=1, kernel="scan",
                           device=device, collect_idx=idx)
    print(f"phase scan path, glmm_large: Model.sample(kernel='scan', "
          f"collect_idx={len(idx)} coordinates) {MAIN_CHAINS} chains x "
          f"({LARGE_WARMUP} warmup + {LARGE_DRAWS} draws), HMC({LARGE_STEPS})"
          f", {LARGE_GROUPS} groups x {LARGE_OBS} rows, {cd.n_vars} "
          f"parameters: {summary(tr_scan)}", flush=True)

    # density at the scan-path run's last states (one a chain, full
    # width) and at inits, against f32 autograd and f64 on the card
    last = tr_scan.final_q.T
    inits = cfg.init_scale * np.random.default_rng(8).normal(
        size=(cd.n_vars, LARGE_CHECK_INIT))
    q = torch.as_tensor(np.hstack([last, inits]), dtype=torch.float32,
                        device=device)
    cols64 = tuple(c.double() if c.is_floating_point() else c
                   for c in cd.column_values(torch.float32, device))
    lanes64 = F.density_lanes(cd, cols64)
    cond = large_conditioning(lanes64, q)
    with torch.enable_grad():
        x = q.double().requires_grad_(True)
        lp64 = lanes64(x)
        truth = (lp64.detach(), torch.autograd.grad(lp64.sum(), x)[0])
    dlp_mean, density_entry = density_check(
        F, cd, em, q, truth, MAIN_CHAINS, "scan-path states", device,
        "rainier_tpu/ops/hmc_pallas.py:282", cond=cond)
    del cond, truth, x, lp64

    # kernel vs plain from those states, with the run's per-chain ε and
    # Σ̂: the bar of the other models' parity phases
    n_par = LARGE_PARITY_CHAINS
    start = (last[:, :n_par], tr_scan.step_size[:n_par],
             tr_scan.mass.diag[:n_par])
    for explicit in (True, False):
        parity_phase(F, cd, device, n_par, LARGE_PARITY_ITERS, explicit,
                     min_frac=agree_frac(LARGE_AGREE_AT, dlp_mean),
                     tol=1e-3, max_dacc=0.02, start=start, collect_idx=idx,
                     agree_at=LARGE_AGREE_AT)

    # the main path, held to the scan-path run as GLMMPoisson2's is
    F.fused_hmc.launches = 0
    tr = model.sample(cfg, n_chains=MAIN_CHAINS, seed=0, kernel="fused!",
                      device=device, collect_idx=idx)
    launches = F.fused_hmc.launches
    z, stat, param = moment_z(tr.chains, tr_scan.chains, device)
    print(f"phase main path, glmm_large: Model.sample(kernel='fused!', "
          f"collect_idx={len(idx)} coordinates) {MAIN_CHAINS} chains x "
          f"({LARGE_WARMUP} warmup + {LARGE_DRAWS} draws), HMC({LARGE_STEPS})"
          f": fused_hmc launches {launches}, {summary(tr)}; per-chain means "
          f"and variances against the scan-path run: max {z:.3f} standard "
          f"errors apart (chain {stat}s of collected coordinate {param}; "
          f"bound {GLMM_MOMENT_Z})", flush=True)
    check(launches >= 1, f"fused_hmc launches {launches}")
    check(np.all(np.isfinite(tr.chains)) and tr.chains.shape == (
        MAIN_CHAINS, LARGE_DRAWS, len(idx)), tr.chains.shape)
    check(z <= GLMM_MOMENT_Z, (z, stat, param))

    # the kernel and its plain version at the main path's shapes, from
    # its last states with its ε and Σ̂, keeping the collected coordinates
    entry = time_kernel(F, cd, em, tr, LARGE_STEPS, device,
                        em.row_bytes(), "glmm_large",
                        min_frac=agree_frac(LARGE_AGREE_AT, dlp_mean),
                        tol=1e-3, max_dacc=0.02, agree_at=LARGE_AGREE_AT,
                        collect_idx=idx)
    return [{"name": "fused_hmc (glmm_large, state in the workspace)",
             "route": "cuda",
             "source": "rainier_tpu_torch/csrc/fused_hmc.cu",
             "replaces": "rainier_tpu/ops/hmc_pallas.py:282",
             "launches": launches, **entry, "library_ms": None},
            {**density_entry, "name": "rt_logp_grad_launch (glmm_large)",
             "launches": 0}]


def stream_phase(F, cd, device, n_chains, n_iters, n_steps, what,
                 plain=None, **inputs):
    """The kernel with its column tiles streamed and synchronous
    (``stream_columns`` True and False) on the inputs of `parity_inputs`,
    in both RNG modes: bit for bit the same final q, draws, accept rates
    and divergences (``torch.equal``), one streamed launch each.  With
    `plain` = (min_frac, tol, max_dacc), the plain version runs on the
    same inputs too and the streamed kernel is held to it as the parity
    phases hold theirs.  Returns ({(explicit noise, True, False or
    "plain"): ms}, each run timed once, and the largest |Δq| against the
    plain version)."""
    import torch

    times, max_err = {}, 0.0
    for explicit in (True, False):
        q0, kw = parity_inputs(cd, device, n_chains, n_iters, explicit,
                               n_steps=n_steps, **inputs)
        before = F.fused_hmc.streamed
        outs = {}
        for flag in (True, False):
            outs[flag], times[explicit, flag] = timed(
                lambda: F.fused_hmc(cd, q0, stream_columns=flag, **kw),
                device, 1, False)
        same = all(torch.equal(a, b) for a, b in zip(outs[True],
                                                     outs[False]))
        streamed = F.fused_hmc.streamed - before
        mode = "explicit noise" if explicit else "on-device Philox"
        vs_plain, ok = "", True
        if plain is not None:
            min_frac, tol, max_dacc = plain
            ref, times[explicit, "plain"] = timed(
                lambda: F.fused_hmc_reference(cd, q0, **kw), device, 1,
                False)
            frac, err, dacc, div_eq = agreement(outs[True], ref, tol)
            max_err = max(max_err, err)
            ok = frac >= min_frac and dacc < max_dacc and div_eq
            plain_ms = times[explicit, "plain"]
            vs_plain = (f"; against the plain version ({plain_ms:.1f} "
                        f"ms) {frac:.4f} of chains within "
                        f"{tol} rel (need {min_frac:.4f}), max |dq| "
                        f"{err:.3g}, mean |d accept| {dacc:.3g}, "
                        f"divergences equal {div_eq}")
        print(f"phase streamed-vs-synchronous, {what} ({mode}): {n_chains} "
              f"chains x {n_iters} it x {n_steps} steps: final q, draws, "
              f"accept rates and divergences identical {same}; streamed "
              f"{times[explicit, True]:.1f} ms, synchronous "
              f"{times[explicit, False]:.1f} ms; {streamed} launch streamed"
              f"{vs_plain}", flush=True)
        check(same and streamed == 1 and ok, (what, mode, same, streamed,
                                              vs_plain))
    return times, max_err


def logit2m_phases(F, model, cd, em, x, ys, lcd, w_map, cov, device):
    """The 2M-row logistic regression, whose columns stream: a scan-path
    run, the density at full width at its last draws and at inits, the
    kernel streamed against synchronous (on the 100k logistic `lcd` too,
    around its Laplace mode `w_map`, `cov`) and against its plain version
    from the scan-path draws, and the main path held to the scan-path run by
    per-chain moments (the reference does not converge it at this
    budget either: rank-r̂ 10.6 on its scan path,
    benchmarks/data_scale_tpu_r5.jsonl).  Returns its JSON entries."""
    import torch

    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    cfg = SamplerConfig(LOGIT2M_WARMUP, LOGIT2M_DRAWS,
                        sampler=HMC(LOGIT2M_STEPS))
    n, n_steps = LOGIT2M_CHAINS, LOGIT2M_STEPS
    col_bytes = em.row_bytes()
    l2 = (torch.cuda.get_device_properties(device).L2_cache_size
          if device.type == "cuda" else 0)

    def summary(tr):
        return (f"rank-r_hat max {rank_rhat(tr, device):.5f}, accept "
                f"{float(np.mean(tr.accept_rate())):.3f}, divergences "
                f"{tr.divergences()}, step size median "
                f"{float(np.median(tr.step_size)):.4g}, timings "
                f"{tr.timings}")

    head = (f"{n} chains x ({LOGIT2M_WARMUP} warmup + {LOGIT2M_DRAWS} "
            f"draws), HMC({n_steps})")
    with phase("scan path, logistic 2M", device):
        tr_scan = model.sample(cfg, n_chains=n, seed=1, kernel="scan",
                               device=device)
        print(f"phase scan path, logistic 2M: Model.sample(kernel='scan') "
              f"{head}, {em.n_rows} rows x {LOGIT_FEATURES} features, "
              f"{col_bytes} bytes of columns against an L2 of {l2}: "
              f"{summary(tr_scan)}", flush=True)

    # the density at the scan-path run's last draws and at inits, the
    # launches streamed, against f32 autograd and f64 on the card
    last = tr_scan.chains[:, -1, :].T
    with phase("density at full width, logistic 2M", device):
        inits = cfg.init_scale * np.random.default_rng(9).normal(
            size=(cd.n_vars, LOGIT2M_CHECK_INIT))
        q = torch.as_tensor(np.hstack([last[:, :LOGIT2M_CHECK_DRAWS],
                                       inits]), dtype=torch.float32,
                            device=device)
        before = F.logp_grad.streamed
        dlp_mean, density_entry = density_check(
            F, cd, em, q, logistic_truth(x, ys, q, device),
            LOGIT2M_CHECK_DRAWS, "scan-path draws", device,
            "rainier_tpu/ops/hmc_pallas.py:305")
        check(F.logp_grad.streamed - before == 4,
              "the 2M-row density launches did not stream")
        del q

    with phase("streamed vs synchronous, logistic 100k", device):
        stream_phase(F, lcd, device, STREAM_AB_CHAINS, STREAM_AB_ITERS,
                     LOGIT_STEPS, "logistic 100k", center=w_map,
                     var=np.diag(cov))
    # at the main path's width from the scan-path run's last draws, with
    # its per-chain ε and Σ̂, the plain version on the same inputs too,
    # held to the streamed kernel with the bar of the logistic's parity
    # phases
    with phase("streamed vs synchronous vs plain, logistic 2M", device):
        times, max_err = stream_phase(
            F, cd, device, n, LOGIT2M_AB_ITERS, n_steps, "logistic 2M",
            plain=(agree_frac(LOGIT2M_AB_ITERS, dlp_mean), 1e-3, 0.02),
            start=(last, tr_scan.step_size, tr_scan.mass.diag))

    with phase("main path, logistic 2M", device):
        F.fused_hmc.launches = F.fused_hmc.streamed = 0
        tr = model.sample(cfg, n_chains=n, seed=0, kernel="fused!",
                          device=device)
        launches, streamed = F.fused_hmc.launches, F.fused_hmc.streamed
        z, stat, param = moment_z(tr.chains, tr_scan.chains, device)
        print(f"phase main path, logistic 2M: Model.sample(kernel='fused!') "
              f"{head}: fused_hmc launches {launches}, streamed {streamed}, "
              f"{summary(tr)}; per-chain means and variances against the "
              f"scan-path run: max {z:.3f} standard errors apart (chain "
              f"{stat}s of parameter {param}; bound {GLMM_MOMENT_Z}); the "
              f"kernel's sample_s {tr.timings['sample_s']} s against the "
              f"scan path's {tr_scan.timings['sample_s']} s", flush=True)
        check(launches == 1 and streamed == 1, (launches, streamed))
        check(np.all(np.isfinite(tr.chains)) and tr.chains.shape == (
            n, LOGIT2M_DRAWS, cd.n_vars), tr.chains.shape)
        check(z <= GLMM_MOMENT_Z, (z, stat, param))

    # ms, plain_ms and bound_ms all of the Philox run of the 2M stream
    # phase: the main path's width and inputs, its depth cut
    bound_ms, bound_by = kernel_bound_ms(em, n, LOGIT2M_AB_ITERS, n_steps,
                                         1, F, col_bytes, past_l2=True)
    return [{"name": "fused_hmc (logistic regression 2M rows, streamed "
                     "columns)", "route": "cuda",
             "source": "rainier_tpu_torch/csrc/fused_hmc.cu",
             "replaces": "rainier_tpu/ops/hmc_pallas.py:305",
             "launches": launches, "max_abs_err": max_err,
             "ms": times[False, True], "plain_ms": times[False, "plain"],
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
             "ms_of": f"{n} chains x {LOGIT2M_AB_ITERS} it x {n_steps} "
                      f"steps, on-device Philox, from the scan-path run's "
                      f"last draws; the plain version on the same inputs",
             "main_path_ms": tr.timings["sample_s"] * 1e3,
             "main_path_ms_of": f"the main path's sample_s, {n} chains x "
                                f"{LOGIT2M_DRAWS} it x {n_steps} steps"},
            {**density_entry,
             "name": "rt_logp_grad_launch (logistic regression 2M rows, "
                     "streamed)", "launches": 0}]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.ops import fused_hmc as F

    t_start = time.perf_counter()
    device = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"phase card: {name} ({torch.cuda.device_count()} visible), "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- build: every model's kernel at once --------------------------------
    fmodel, y = funnel(rt)
    lmodel, x, ys = logistic_regression(rt)
    readme = readme_regression(rt)
    gmodel = glmm_poisson(rt)
    large = glmm_large(rt)
    l2model, x2, ys2 = logistic_regression(rt, LOGIT2M_ROWS)
    mv = mvnormal_logistic(rt, x, ys)
    smodel = split_logistic(rt, x, ys)
    cds = {"funnel": fmodel.density(),
           "README regression": readme[0].density(),
           "logistic regression": lmodel.density(),
           "MVNormal logistic": mv[0].density(),
           "logistic regression, two row spaces": smodel.density(),
           "GLMMPoisson2": gmodel.density(),
           "glmm_large": large.density(),
           "logistic regression 2M": l2model.density()}
    with phase("build", device):
        ems = build_all(F, cds)

    # -- the funnel: the column-free phases ----------------------------------
    with phase("funnel", device):
        kernels = funnel_phases(F, cds["funnel"], fmodel, y, ems["funnel"],
                                device, smi)

    # -- the logistic regression at full width ------------------------------
    lcd, lem = cds["logistic regression"], ems["logistic regression"]
    with phase("logistic regression: density, parity", device):
        t0 = time.perf_counter()
        w_map, cov = laplace_reference(x, ys)
        print(f"phase Laplace reference: Newton in f64, MAP "
              f"{np.round(w_map, 5).tolist()}, Laplace SDs "
              f"{np.round(np.sqrt(np.diag(cov)), 6).tolist()} "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
        dlp_mean, density_entry = density_phase(F, lcd, lem, x, ys, w_map,
                                                cov, device)
        # E|Δlp| near the MAP from the density phase; 1e-3 rel allows the
        # f32 gradient differences to compound over the iterations
        for explicit in (True, False):
            parity_phase(F, lcd, device, PARITY_CHAINS, LOGIT_PARITY_ITERS,
                         explicit, center=w_map, var=np.diag(cov),
                         min_frac=agree_frac(LOGIT_PARITY_ITERS, dlp_mean),
                         tol=1e-3, max_dacc=0.02)

    # -- main paths with data -----------------------------------------------
    with phase("README regression", device):
        kernels.append(readme_phases(F, readme, ems["README regression"],
                                     device))
    with phase("logistic regression: main path", device):
        entry, tr = logistic_main(F, lmodel, lcd, lem, w_map, cov, device,
                                  agree_frac(LOGIT_TIME_ITERS, dlp_mean))
        scan_timing(lmodel, tr, device, "logistic regression")
    kernels.append({"name": "fused_hmc (logistic regression, row-tiled)",
                    "replaces": "rainier_tpu/ops/hmc_pallas.py:302",
                    **entry})
    kernels.append({**density_entry, "launches": 0})

    # -- the untiled density: columns read whole, several row spaces ---------
    with phase("MVNormal logistic", device):
        kernels += mvnormal_phases(F, mv, cds["MVNormal logistic"],
                                   ems["MVNormal logistic"], x, ys, device)
    with phase("logistic regression, two row spaces", device):
        kernels.append(split_phases(
            F, cds["logistic regression, two row spaces"],
            ems["logistic regression, two row spaces"], lcd, x, ys, w_map,
            cov, device))

    # -- GLMMPoisson2: integer index columns ---------------------------------
    with phase("GLMMPoisson2", device):
        kernels += glmm_phases(F, gmodel, cds["GLMMPoisson2"],
                               ems["GLMMPoisson2"], device)

    # -- glmm_large: the chain state in the kernel's workspace ---------------
    with phase("glmm_large", device):
        kernels += large_phases(F, large, cds["glmm_large"],
                                ems["glmm_large"], device)

    # -- the 2M-row logistic regression: streamed columns ---------------------
    kernels += logit2m_phases(F, l2model, cds["logistic regression 2M"],
                              ems["logistic regression 2M"], x2, ys2, lcd,
                              w_map, cov, device)
    print(f"phase total: {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
