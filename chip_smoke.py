#!/usr/bin/env python3
"""On-card smoke test of rainier_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the fused HMC kernel for three models from the checkout's
sources (one nvcc each), and then, each phase printing one line:

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
  checked against the Laplace reference, and the kernel's time.

Any failed check raises and exits nonzero.  The third line from the end
is a JSON object with each kernel's launches on its main path, error
against the plain version, times and bound; then the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``.  Without
a CUDA card it exits nonzero and prints no result.  It imports nothing
of JAX.
"""

from __future__ import annotations

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
LOGIT_WARMUP, LOGIT_DRAWS, LOGIT_STEPS = 1000, 1000, 5
LOGIT_PARITY_ITERS = 100
LOGIT_CHECK_MAP, LOGIT_CHECK_INIT = 1024, 64


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


def logistic_regression(rt):
    """benchmarks/models.py:145-159, data regenerated from its seed:
    (model, x (n, p), ys (n,)); the parameters are alpha, then betas."""
    from rainier_tpu_torch.compute import real as R

    rng = np.random.default_rng(LOGIT_SEED)
    n, p = LOGIT_ROWS, LOGIT_FEATURES
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


def laplace_reference(x, ys):
    """MAP and inverse negative Hessian of the logistic posterior (prior
    included) by Newton's method in numpy f64, in the sampler's
    coordinates: (map (p+1,), cov).  The latent of Normal(0, s) is s·z
    with z standard (the Scale injection of core/continuous.py), so the
    sampler's parameters are (alpha, betas) / s."""
    xa = np.hstack([np.ones((x.shape[0], 1)), x])
    prec = 1.0 / LOGIT_PRIOR_SD ** 2
    w = np.zeros(xa.shape[1])
    for _ in range(100):
        mu = 1.0 / (1.0 + np.exp(-(xa @ w)))
        g = xa.T @ (ys - mu) - prec * w
        h = (xa.T * (mu * (1 - mu))) @ xa + prec * np.eye(xa.shape[1])
        step = np.linalg.solve(h, g)
        w = w + step
        if np.max(np.abs(step)) < 1e-13:
            break
    mu = 1.0 / (1.0 + np.exp(-(xa @ w)))
    h = (xa.T * (mu * (1 - mu))) @ xa + prec * np.eye(xa.shape[1])
    s = LOGIT_PRIOR_SD
    return w / s, np.linalg.inv(h) / s ** 2


def logistic_truth(x, ys, qs, device):
    """lp and gradient of the logistic posterior at every column of qs
    (p+1, m) in the sampler's coordinates (alpha, betas) / s, in float64
    on the card: the reference both f32 versions are held to.  The change
    of coordinates adds log s per parameter to lp and scales g by s."""
    import torch

    xa = torch.cat([torch.ones((x.shape[0], 1), dtype=torch.float64),
                    torch.as_tensor(x)], dim=1).to(device)
    y = torch.as_tensor(ys, dtype=torch.float64, device=device)[:, None]
    s = LOGIT_PRIOR_SD
    b = s * qs.to(device=device, dtype=torch.float64)
    lin = xa @ b
    ll = y * lin - torch.nn.functional.softplus(lin)
    lp = (ll.sum(0) - 0.5 * (b * b).sum(0) / s ** 2
          - b.shape[0] * 0.5 * np.log(2 * np.pi))
    g = s * (xa.T @ (y - torch.sigmoid(lin)) - b / s ** 2)
    return lp, g


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


def parity_phase(F, cd, device, n_chains, n_iters, explicit_noise: bool,
                 center=None, var=None, min_frac=0.99, tol=REL_TOL,
                 max_dacc=0.01):
    """Kernel vs plain version on one input: per-chain ε and Σ̂, a ragged
    chain count, every draw collected.  q0 ~ N(center, var) and Σ̂ = var
    times a per-chain factor in [0.5, 2] (standard normal without them)."""
    import torch

    rng = np.random.default_rng(1 if explicit_noise else 2)
    dim = cd.n_vars
    center = np.zeros(dim) if center is None else center
    var = np.ones(dim) if var is None else var

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    q0 = t(center[:, None] + np.sqrt(var)[:, None]
           * rng.normal(size=(dim, n_chains)))
    kw = dict(step_size=t(rng.uniform(0.3, 0.9, n_chains)),
              n_steps=N_STEPS, n_iterations=n_iters, seed=11,
              inv_mass_diag=t(var * rng.uniform(0.5, 2.0, (n_chains, dim))),
              collect_every=1)
    if explicit_noise:
        kw["noise"] = (t(rng.normal(size=(n_iters, dim, n_chains))),
                       t(rng.uniform(1.1920929e-7, 1.0, (n_iters, n_chains))))
    a = F.fused_hmc(cd, q0, **kw)
    b = F.fused_hmc_reference(cd, q0, **kw)
    frac, max_err, dacc, div_eq = agreement(a, b, tol)
    mode = "explicit noise" if explicit_noise else "on-device Philox"
    print(f"phase kernel-vs-plain ({mode}): {n_chains} chains x {n_iters} "
          f"it: {frac:.4f} of chains within {tol} rel (need {min_frac:.4f}),"
          f" max |dq| {max_err:.3g}, mean |d accept| {dacc:.3g}, "
          f"divergences equal {div_eq}", flush=True)
    check(frac >= min_frac and dacc < max_dacc and div_eq,
          (frac, dacc, div_eq))
    return max_err


def kernel_bound_ms(em, n_chains, n_iters, n_steps, collect_every, F,
                    col_bytes=0):
    """Least time the card could take for one fused_hmc call: the larger
    of its bytes over the memory rate and its operations over the f32
    rate (Philox integer operations counted at the f32 rate)."""
    ops = n_chains * n_iters * F.op_count(em, n_steps)
    n_out = n_iters // collect_every if collect_every else 0
    dim = em.n_vars
    # columns, q0, ε, Σ̂ read; final q, accept, divergences, draws written
    nbytes = col_bytes + 4 * (n_chains * (dim + 1 + dim)
                              + n_chains * (dim + 2) + n_out * dim * n_chains)
    return _bound(ops, nbytes)


def _bound(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def build_all(F, models):
    """Build every model's kernel, one nvcc each; print each build's
    sizes and what ptxas reports."""
    ems = {}
    for name, cd in models.items():
        kernels, secs, em = F.build(cd)
        ptxas = " | ".join(
            line.split("ptxas info    : ")[-1].strip()
            for line in kernels.log.splitlines()
            if "registers" in line or "spill" in line)
        print(f"phase build: {name}: {em.n_vars} dims, {em.ops} ops per "
              f"logp+grad apart from rows, {em.row_ops} ops per row, "
              f"{em.n_rows} rows of {em.row_width} floats, tile "
              f"{em.tile_rows} rows; {secs:.2f} s; ptxas: {ptxas}",
              flush=True)
        ems[name] = em
    return ems


def time_kernel(F, cd, em, tr, n_steps, device, col_bytes, what, reps=1,
                min_frac=0.99, tol=REL_TOL, max_dacc=0.01):
    """The kernel at a main path's shapes, on its warmup product's inputs:
    per-chain ε and Σ̂, every draw collected, q0 the last draws; held to
    its plain version as the parity phases are (at least `min_frac` of
    chains within `tol`, mean |Δaccept| < `max_dacc`, divergences
    equal)."""
    import torch

    n_chains, n_iters = tr.chains.shape[0], tr.chains.shape[1]
    q0 = torch.as_tensor(tr.chains[:, -1, :].T.copy(), device=device)
    kw = dict(step_size=torch.as_tensor(tr.step_size, device=device),
              n_steps=n_steps, n_iterations=n_iters, seed=1,
              inv_mass_diag=torch.as_tensor(tr.mass.diag, device=device),
              collect_every=1)
    ker, ker_ms = timed(lambda: F.fused_hmc(cd, q0, **kw), device, reps,
                        reps > 1)
    plain, plain_ms = timed(lambda: F.fused_hmc_reference(cd, q0, **kw),
                            device, 1, False)
    frac, max_err, dacc, div_eq = agreement(ker, plain, tol)
    bound_ms, bound_by = kernel_bound_ms(em, n_chains, n_iters, n_steps, 1,
                                         F, col_bytes)
    print(f"phase kernel at main-path shapes, {what} ({n_chains} chains x "
          f"{n_iters} it x {n_steps} steps, draws collected): kernel "
          f"{ker_ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.4f} "
          f"ms ({bound_by}), {frac:.4f} of chains agree within {tol} rel "
          f"(need {min_frac:.4f}), "
          f"max |dq| {max_err:.3g}, mean |d accept| {dacc:.3g}, "
          f"divergences equal {div_eq}", flush=True)
    check(frac >= min_frac and dacc < max_dacc and div_eq,
          (what, frac, dacc, div_eq))
    return dict(max_abs_err=max_err, ms=ker_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def rank_rhat(tr):
    return max(d.r_hat for d in tr.diagnostics(rank_normalized=True))


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
    rhat = rank_rhat(tr)
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
    return {"name": "fused_hmc", "route": "cuda",
            "source": "rainier_tpu_torch/csrc/fused_hmc.cu",
            "replaces": "rainier_tpu/ops/hmc_pallas.py:506",
            "launches": launches, **entry, "library_ms": None}


def density_phase(F, cd, em, x, ys, w_map, cov, device):
    """rt_logp_grad_launch against autograd on the plain version and
    against f64, at full width: LOGIT_CHECK_MAP q drawn from the Laplace
    approximation and LOGIT_CHECK_INIT overdispersed inits, where the
    gradient is large.  Tolerances per point: |Δlp| within 0.01 nats or
    two f32 ulps of lp, whichever is larger (two f32 results of the same
    sum differ by rounding alone up to an ulp); |Δg| within 1e-4 of the
    point's max |g|."""
    import torch

    from rainier_tpu_torch.sampler import SamplerConfig

    rng = np.random.default_rng(7)
    near = w_map[:, None] + np.linalg.cholesky(cov) @ rng.normal(
        size=(cd.n_vars, LOGIT_CHECK_MAP))
    inits = SamplerConfig().init_scale * rng.normal(
        size=(cd.n_vars, LOGIT_CHECK_INIT))
    q = torch.as_tensor(np.hstack([near, inits]), dtype=torch.float32,
                        device=device)
    before = F.logp_grad.launches
    # one warm-up launch, then the mean of three
    (lp_k, g_k), ms = timed(lambda: F.logp_grad(cd, q), device, 3)
    (lp_p, g_p), plain_ms = timed(lambda: F.logp_grad_reference(cd, q),
                                  device, 1, False)
    lp_t, g_t = logistic_truth(x, ys, q, device)
    check(F.logp_grad.launches == before + 4, "logp_grad did not launch")
    tol_lp = torch.clamp(2 * torch.finfo(torch.float32).eps
                         * lp_t.abs().float(), min=0.01)
    gmax = g_t.abs().amax(0).float()
    groups = {"near the MAP": slice(0, LOGIT_CHECK_MAP),
              "inits": slice(LOGIT_CHECK_MAP, None)}
    worst, lines = {}, []
    for name, (lp, g) in (("kernel-vs-plain", (lp_k - lp_p, g_k - g_p)),
                          ("kernel-vs-f64", (lp_k - lp_t.float(),
                                             g_k - g_t.float())),
                          ("plain-vs-f64", (lp_p - lp_t.float(),
                                            g_p - g_t.float()))):
        dlp, dg = lp.abs(), (g.abs().amax(0) / gmax)
        rel = dlp / tol_lp
        worst[name] = (float(dlp.max()), float(rel.max()), float(dg.max()))
        lines.append(f"{name}: " + ", ".join(
            f"{k} max |dlp| {float(dlp[sl].max()):.3g} (mean "
            f"{float(dlp[sl].mean()):.3g}, {float(rel[sl].max()):.3f} of "
            f"the tolerance), max |dg|/max|g| {float(dg[sl].max()):.3g}"
            for k, sl in groups.items()))
    n = LOGIT_CHECK_MAP + LOGIT_CHECK_INIT
    ops = n * em.density_ops()
    nbytes = 4 * (em.n_rows * em.row_width + 2 * n * (cd.n_vars + 1))
    bound_ms, bound_by = _bound(ops, nbytes)
    print(f"phase density at full width: rt_logp_grad_launch at {n} q "
          f"({LOGIT_CHECK_MAP} near the MAP, {LOGIT_CHECK_INIT} inits; "
          f"max |g| {float(gmax[groups['near the MAP']].max()):.4g} and "
          f"{float(gmax[groups['inits']].max()):.4g}, |lp| up to "
          f"{float(lp_t.abs().max()):.4g}); " + "; ".join(lines)
          + f"; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    for k in ("kernel-vs-plain", "kernel-vs-f64"):
        check(worst[k][1] <= 1.0 and worst[k][2] <= 1e-4, (k, worst[k]))
    near_dlp = float((lp_k - lp_p).abs()[groups["near the MAP"]].mean())
    return near_dlp, dict(
        name="rt_logp_grad_launch", route="cuda",
        source="rainier_tpu_torch/csrc/fused_hmc.cu",
        replaces="rainier_tpu/ops/hmc_pallas.py:302",
        max_abs_err=worst["kernel-vs-plain"][0], ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


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
    rhat = rank_rhat(tr)
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
                        4 * em.n_rows * em.row_width, "README regression",
                        reps=3)
    return {"name": "fused_hmc (README regression, one tile)",
            "route": "cuda", "source": "rainier_tpu_torch/csrc/fused_hmc.cu",
            "replaces": "rainier_tpu/ops/hmc_pallas.py:280",
            "launches": launches, **entry, "library_ms": None}


def logistic_main(F, model, cd, em, w_map, cov, device, min_frac):
    """The logistic regression through Model.sample(kernel="fused!"),
    against the Laplace reference, then timed against its plain version
    with the logistic parity phases' bar (`min_frac` within 1e-3 rel);
    returns its JSON entry."""
    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    cfg = SamplerConfig(LOGIT_WARMUP, LOGIT_DRAWS, sampler=HMC(LOGIT_STEPS))
    F.fused_hmc.launches = 0
    tr = model.sample(cfg, n_chains=MAIN_CHAINS, seed=0, kernel="fused!",
                      device=device)
    launches = F.fused_hmc.launches
    flat = tr.flat().astype(np.float64)
    sd_ref = np.sqrt(np.diag(cov))
    dmean = np.abs(flat.mean(0) - w_map) / sd_ref
    dsd = np.abs(flat.std(0) / sd_ref - 1.0)
    rhat = rank_rhat(tr)
    print(f"phase main path, logistic regression: Model.sample(kernel="
          f"'fused!') {MAIN_CHAINS} chains x ({LOGIT_WARMUP} warmup + "
          f"{LOGIT_DRAWS} draws), HMC({LOGIT_STEPS}), {LOGIT_ROWS} rows x "
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
    entry = time_kernel(F, cd, em, tr, LOGIT_STEPS, device,
                        4 * em.n_rows * em.row_width, "logistic regression",
                        min_frac=min_frac, tol=1e-3, max_dacc=0.02)
    return {"name": "fused_hmc (logistic regression, row-tiled)",
            "route": "cuda", "source": "rainier_tpu_torch/csrc/fused_hmc.cu",
            "replaces": "rainier_tpu/ops/hmc_pallas.py:302",
            "launches": launches, **entry, "library_ms": None}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"phase card: {name} ({torch.cuda.device_count()} visible), "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- build: every model's kernel at once --------------------------------
    fmodel, y = funnel(rt)
    lmodel, x, ys = logistic_regression(rt)
    readme = readme_regression(rt)
    cds = {"funnel": fmodel.density(),
           "README regression": readme[0].density(),
           "logistic regression": lmodel.density()}
    ems = build_all(F, cds)

    # -- the funnel: the column-free phases ----------------------------------
    kernels = [funnel_phases(F, cds["funnel"], fmodel, y, ems["funnel"],
                             device, smi)]

    # -- the logistic regression at full width ------------------------------
    lcd, lem = cds["logistic regression"], ems["logistic regression"]
    t0 = time.perf_counter()
    w_map, cov = laplace_reference(x, ys)
    print(f"phase Laplace reference: Newton in f64, MAP "
          f"{np.round(w_map, 5).tolist()}, Laplace SDs "
          f"{np.round(np.sqrt(np.diag(cov)), 6).tolist()} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    dlp_mean, density_entry = density_phase(F, lcd, lem, x, ys, w_map, cov,
                                            device)
    # an accept flips where log u falls between the two versions' log α,
    # which differ by at most |Δlp| at two points, and log u - log α has
    # a density of at most 1: so a chain flips with probability at most
    # 2·E|Δlp| per iteration, with E|Δlp| near the MAP from the density
    # phase; 1e-3 rel allows the f32 gradient differences to compound
    # over the iterations.  Over many iterations the bound falls below
    # one half, where it says little: half the chains is the floor
    def logit_min_frac(n_iters):
        return max(0.5, 1.0 - 2.0 * n_iters * dlp_mean)

    for explicit in (True, False):
        parity_phase(F, lcd, device, PARITY_CHAINS, LOGIT_PARITY_ITERS,
                     explicit, center=w_map, var=np.diag(cov),
                     min_frac=logit_min_frac(LOGIT_PARITY_ITERS), tol=1e-3,
                     max_dacc=0.02)

    # -- main paths with data -----------------------------------------------
    kernels.append(readme_phases(F, readme, ems["README regression"],
                                 device))
    kernels.append(logistic_main(F, lmodel, lcd, lem, w_map, cov, device,
                                 logit_min_frac(LOGIT_DRAWS)))
    kernels.append({**density_entry, "launches": 0})

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
