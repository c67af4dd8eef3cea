#!/usr/bin/env python3
"""On-card smoke test of rainier_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the fused HMC kernel for every model from the checkout's
sources (one nvcc each, all started together), and then, each phase
printing one line:

* the model-built Neal's funnel (column-free): the kernel against its
  plain PyTorch version in both RNG modes, ``Model.sample(kernel="fused!")``
  at 1024 chains with its posterior checked, the kernel's time at the
  main path's shapes (16 lanes a chain) and at bench.py's throughput
  configuration (one thread a chain);
* the same funnel at 1000 dimensions, past 256 parameters, so that its
  chain state lives in the kernel's workspace, a warp a chain: the kernel
  against its plain version in both RNG modes, ``Model.sample(kernel=
  "fused!")`` at 1024 chains keeping 10 coordinates with y's posterior
  checked, and the kernel's time at the main path's shapes;
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
* the forms the emitter took last: a latent Gaussian process over 64
  inputs (an ``MVNormal`` of 64 dimensions, L·z in the kernel's scratch)
  through ``Model.sample(kernel="fused!")`` against its exact Gaussian
  posterior in numpy f64, then the kernel against its plain version; the
  100k logistic at 32 features under the ``MVNormal`` prior, as the
  10-feature one (Laplace reference, density at full width, main path,
  betas against L·z, kernel against plain); each row form at 100,000
  rows (an index column read whole, a vector per row, a row-varying
  gather): a short main path, the density at full width against the
  plain version in f32 and f64, and the kernel against its plain version;
  then ``rt.inspection.ptx`` of the GP's kernel and
  ``rt.inspection.trace`` of a short fused run;
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
  (the 100k model at n = 2,000,000, 512 chains, 20 + 30 iterations of
  HMC(8)), whose 88 MB of columns exceed the card's L2, so its launches
  stream their row tiles: a scan-path run, the streamed density at full
  width at its last draws and at inits against the plain version and
  f64, the kernel streamed against synchronous bit for bit (on the 100k
  logistic too) and, at the main path's 512 chains, against its plain
  version, and ``Model.sample(kernel="fused!")`` held to the scan-path
  run by per-chain moments.  Its phases print their seconds and the card's peak
  memory;
* the samplers that run outside the kernel, on the scan path, through
  ``Model.sample``: eight schools (``benchmarks/models.py:49-60``) with
  NUTS(max_depth=8) and dense mass, held to a quadrature of its posterior
  in numpy f64 (means of mu, tau and theta_1 within 0.05 posterior SD, SDs
  of mu and tau within 5%, rank-r̂ < 1.01), and the funnel under the
  default config, EHMC(1024) synchronized, held to the funnel's bars with
  the same gradient evaluations on every chain; each prints what its
  lockstep loops paid (steps and host syncs an iteration).  They and
  ``Model.smc`` time no launch and are bound by the host, so they run in
  a process of their own (``python3 chip_smoke.py samplers``) beside the
  sections below that time no launch either; the zoo's kernel against
  its plain version and the mixture, which time launches, run after it;
* the generative sections: the goldset zoo fitted at 100,000 rows, the
  kernel held to its plain version from three fits, ``trace.predict``
  and ``Model.sample_prior``, the on-device diagnostics and SBC;
* the rest of inference: the two-component mixture of
  tests/test_marginal.py at 100,000 rows with its assignment summed out
  by ``marginalize`` (a LogSumExp a row), through
  ``Model.sample(kernel="fused!")`` against its Laplace reference in
  numpy f64, its responsibilities against the MAP's, and its kernel
  against the plain version; ``Model.optimize`` on the 100k logistic
  (one start and eight) against the Laplace MAP; ADVI, mean-field and
  full-rank, on the README regression against its kernel posterior;
  ``auto_vip`` on the funnel; ``Model.smc`` on eight schools against the
  quadrature's moments and log evidence; the README regression sampled
  in segments with a ``ConsoleProgress`` against the same run at once,
  and through ``fused!`` with a progress;
* parallel (``rt.parallel`` on ``torch.distributed``, the scan path): the
  100k logistic at 1024 chains on ``make_mesh()``, a world of one over
  NCCL, with the bits of the run without a mesh; its pooled run by the
  two-sample moment test against that run; a checkpoint of its trace in
  CUDA tensors round-tripped and ``resume_config`` continuing it; then
  two ranks over gloo on the one card, spawned by the script
  (``python3 chip_smoke.py parallel-rank PORT RANK DIR``): the (1, 2)
  data-sharded density at the density check's points within its bars of
  the world of one's, and runs at (1, 2) and (2, 1) by the moment test,
  each rank holding the same bits.

``python3 chip_smoke.py parallel`` runs the parallel section alone, and
``python3 chip_smoke.py samplers`` the samplers outside the kernel.
``python3 chip_smoke.py advi-spread`` runs the README main path and ADVI
at three seeds, printed and not held to the bars.

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
import re
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks at the full 700 W limit (NVIDIA data sheet): f32 outside
# the tensor cores, and device memory bandwidth
PEAK_F32_OPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# (draws of the funnel's and the README regression's main paths cut from
# 1000 to 500 for the forms sections: PERF.md §4)
N_WARMUP, N_DRAWS, MAIN_CHAINS, N_STEPS = 1000, 500, 1024, 5
# the funnel at WIDE_DIM dimensions (past 256 parameters: its state in the
# kernel's workspace); its main path keeps WIDE_COLLECT coordinates (y's
# and the first x's) of each draw, and its draws and parity iterations are
# cut from the funnel's 1000 to 500 and 200 for the script's time (at 200
# draws the rank-r_hat of the 10 coordinates came out 1.00992, too near
# its bar of 1.01 for draws of a correct sampler)
WIDE_DIM, WIDE_COLLECT = 1000, 10
WIDE_WARMUP, WIDE_DRAWS, WIDE_PARITY_ITERS = 1000, 500, 200
THROUGHPUT_CHAINS, THROUGHPUT_ITERS, THROUGHPUT_EPS = 524288, 500, 0.18
PARITY_CHAINS, PARITY_ITERS = 1000, 200
REL_TOL = 1e-4   # |kernel - plain| <= REL_TOL * max(1, |plain|), per chain
DEVICE = "cuda"
# a kernel's time is the median of LAUNCH_REPS launches alone (setup
# hoisted, columns bound once; ROADMAP C1) where a whole call takes under
# LAUNCH_SHORT_MS, else one launch; the density check's launches always
# LAUNCH_REPS, and it makes DENSITY_LAUNCHES in all
LAUNCH_REPS, LAUNCH_SHORT_MS = 20, 50.0
DENSITY_LAUNCHES = 4 + 1 + LAUNCH_REPS

# README regression (benchmarks/models.py:30-41); its main path's warmup
# cut from the funnel's 1000 to 500 for the script's time (PERF.md §4)
README_ROWS, README_SEED, README_WARMUP = 200, 0, 500
# 100k logistic regression (benchmarks/models.py:145-159) and its run on
# the main path: fixed-step HMC with the sampler's defaults otherwise
LOGIT_ROWS, LOGIT_FEATURES, LOGIT_SEED, LOGIT_PRIOR_SD = 100_000, 10, 5, 5.0
# draws cut from 1000 to 200 to make room for the 2M-row path, warmup
# from 1000 to 500 for the forms sections, then to 250 for the script's
# time (PERF.md §4)
LOGIT_WARMUP, LOGIT_DRAWS, LOGIT_STEPS = 250, 200, 5
# the scan-path run beside it, for its sample_s only
SCAN_WARMUP = 100
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
# draws cut from 1000 to 500 to make room for the untiled density, then
# to 250, and warmup from 1000 to 300, for the forms sections, then to 150
# for the script's time (both runs; PERF.md §4)
GLMM_WARMUP, GLMM_DRAWS, GLMM_STEPS = 150, 250, 5
GLMM_PARITY_ITERS, GLMM_CHECK_INIT = 100, 64
GLMM_MOMENT_Z = 5.0   # two-sample bound on each per-chain moment's mean
# glmm_large (benchmarks/models.py:162-202, BASELINE config 5) and its
# runs, collecting mu, sd and every 100th group effect (layout slots 0, 1,
# 2, 102, ..., 9902)
LARGE_GROUPS, LARGE_OBS, LARGE_SEED, LARGE_LAM = 10_000, 5, 6, 1.0
# draws cut from 1000 to 200 to make room for the 2M-row path, then to
# 100, and warmup from 1000 to 300, for the forms sections, then to 150
# for the script's time (both runs; PERF.md §4)
LARGE_WARMUP, LARGE_DRAWS, LARGE_STEPS = 150, 100, 5
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
# (warmup cut from 1000 to 300 for the forms sections' time, as the
# mixture's and the 32-feature model's, then to 150: PERF.md §4)
MV_RHO, MV_WARMUP = 0.5, 150
# the 100k logistic observed as two merged blocks of these rows: two row
# spaces, the one-block model's density; its kernel streamed against
# synchronous over this many iterations
SPLIT_ROWS, SPLIT_AB_ITERS = 60_000, 20
# the 2M-row logistic regression of benchmarks/data_scale.py:35-50 (the
# 100k model's graph at n = 2,000,000; docs/performance.md:60-82): 88 MB
# of columns, past the card's L2, so its launches stream their tiles
LOGIT2M_ROWS, LOGIT2M_CHAINS = 2_000_000, 512
# draws cut from 100 to 50 to make room for the untiled density, then to
# 30, and warmup from 100 to 40, for the forms sections, then to 20 for
# the script's time (PERF.md §4)
LOGIT2M_WARMUP, LOGIT2M_DRAWS, LOGIT2M_STEPS = 20, 30, 8
# the density check at this many of the scan-path run's last draws and
# inits (the f64 truth holds several (rows, points) arrays)
LOGIT2M_CHECK_DRAWS, LOGIT2M_CHECK_INIT = 128, 32
# streamed against synchronous and against the plain version, at the main
# path's width over this many iterations
LOGIT2M_AB_ITERS = 2
# eight schools (benchmarks/models.py:44-60, non-centred, 10 parameters)
# under the reference's eight_schools_nuts (benchmarks/e2e.py:92-95) with
# the BASELINE's full adaptation (dense mass), held to a quadrature on a
# grid of (mu from, to, points) and (tau from, to, points)
EIGHT_Y = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
EIGHT_SIGMA = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]
# iterations cut from the reference's 1000 + 1000 for the script's time:
# a lockstep leaf costs 6-9 ms of host-bound eager PyTorch on the card's
# host, some 31 of them a warmup iteration and 21 a draw.  Rank-r̂ sits
# near √(1 + (τ_int − 1)/n) for n draws a half chain, τ_int ~5, and a
# shorter warmup raises it too, so neither is cut below what keeps it
# clear of 1.01 (PERF.md §4): draws 750 (1.00512 there) cut to 600 for the
# forms sections, where it sits near √(1 + 4/300) ≈ 1.0066 (1.00647 at
# 500 warmup, 1.00657 at 400); warmup cut to 300 for the script's time
# (PERF.md §4)
NUTS_WARMUP, NUTS_DRAWS, NUTS_DEPTH = 300, 600, 8
QUAD_MU, QUAD_TAU = (-40.0, 50.0, 1801), (0.0, 200.0, 8001)
# bars: means within this many posterior SDs, SDs within this fraction
NUTS_MEAN_SD, NUTS_SD_REL = 0.05, 0.05
# the funnel under the default config (the reference's ehmc_default,
# benchmarks/e2e.py:96-104): EHMC(1024), synchronized; iterations cut from
# 1000 + 1000 for the script's time (PERF.md §4), warmup to 300 for the
# forms sections
EHMC_WARMUP, EHMC_DRAWS = 300, 500
# the goldset zoo (tests/goldset_zoo.py:28-56, the reference's SBCModel
# goldset: 5 continuous priors under a Normal likelihood and 7 discrete
# likelihoods), each family's data synthesized on the card by the port's
# generators at the reference SBCBenchmark's largest size
# (benchmarks/sbc_sweep.py:3-8) and fitted through
# Model.sample(kernel="fused!") at 1024 chains x (200 + 500), HMC(4); held
# to a quadrature of prior x likelihood in numpy f64 over ZOO_GRID points
# (means within ZOO_MEAN_SD posterior SD, SDs within ZOO_SD_REL, rank-r̂
# under 1.01).  HMC(4), not HMC(5): on these 1-D, near-Gaussian posteriors
# warmup adapts the step to 1.06-1.12 of the posterior SD, where five
# leapfrog steps turn a trajectory about 5.9 rad, near a full period,
# and rank-r̂ over 1000 draws came out 1.004-1.021 on the card with every
# mean and SD within its bar; four steps turn it about 4.7 rad; ``kernel_ab.py
# zoo 5 1000 float64`` reads HMC(5).  500 draws, not 300, for the
# estimator's bias of about (τ - 1)/n a half chain.  Warmup runs in f64
# (``Model.sample(dtype=)``): at 100k rows the large Poisson's Σ v·log λ
# and Σ log v! are ~2e7 each, so f32 rounding moves its lp by about a nat
# (read by `zoo_parity`), more than the posterior's width does, and with
# f32 warmup dual averaging drives its step to ~1e-5 and the negative
# binomial loses chains to its far tail (``kernel_ab.py zoo 4 500
# float32`` reads it; ROADMAP fault C4)
ZOO_ROWS, ZOO_SEED = 100_000, 7
# warmup cut from 300 to 200 for the script's time (PERF.md §4): at 150
# some of gamma_normal's chains kept steps of ~0.001 and the fit missed
# its bars (its SD 7.3 times off)
ZOO_WARMUP, ZOO_DRAWS, ZOO_STEPS = 200, 500, 4
ZOO_GRID, ZOO_MEAN_SD, ZOO_SD_REL = 4001, 0.05, 0.05
# the kernel held to its plain version at the zoo's shapes, from these
# families' fits (their final states, ε and Σ̂): the -inf term of a
# zero-inflated LogSumExp, and the largest data-only lgamma sums (the
# large Poisson's and the negative binomial's); the density at those
# states against the plain version and f64, then ZOO_PARITY_ITERS
# iterations of HMC(ZOO_STEPS) compared by `chaotic` after at most
# ZOO_AGREE_AT (`zoo_parity` says where)
ZOO_PARITY = ("zero_inflated_geometric", "large_poisson", "neg_binomial")
ZOO_PARITY_ITERS, ZOO_AGREE_AT = 100, 20
# predictive checks: every draw of the trace thinned by PRED_THIN, means
# (and the README's variances) within PRED_SE standard errors
PRED_THIN, PRED_SE = 10, 5.0
# the zoo families whose predictive mean is held to the mean over draws
# of the family's mean, as a numpy function of the latent
ZOO_MEANS = {"poisson": lambda x: x, "binomial": lambda x: 10.0 * x,
             "neg_binomial": lambda x: 10.0 * x / (1.0 - x),
             "zero_inflated_geometric": lambda x: 0.7 * (1.0 - x) / x}
# Model.sample_prior on tests/test_distributions.py:179-195's pair
PRIOR_DRAWS = 1000
# on-device diagnostics against the host's f64, rank-normalized: r̂
# within DIAG_RHAT (absolute), ESS within DIAG_ESS_REL; GLMMPoisson2's
# every DIAG_GLMM_EVERY-th coordinate (the host pipeline took 31 s for all
# 146 on the card's host)
DIAG_RHAT, DIAG_ESS_REL, DIAG_GLMM_EVERY = 1e-3, 0.01, 10
# SBC on the card (tests/test_sbc.py:27-34: n = 30 there): simulate at
# SBC_ROWS rows, 2**SBC_LOG_BINS bins, SBC_REPS repetitions, each fit
# SBC_WARMUP warmup iterations (the test's 500) of HMC(SBC_STEPS) (the
# test's 6: at the step warmup adapts on these 1-D posteriors HMC(6) turns
# a trajectory nearly a full period, so each repetition refit 2-5 times
# to thin its draws to 1024 effective, 40-49 s a repetition on the card;
# HMC(4) turns about 4.4 rad, lag-1 autocorrelation near -0.3); bars: max
# r̂ < SBC_RHAT, rank-uniformity p-value > SBC_PVALUE
# (repetitions cut from 12 to 6 for the forms sections)
SBC_ROWS, SBC_LOG_BINS, SBC_REPS, SBC_WARMUP = 100, 2, 6, 150
SBC_STEPS = 4
SBC_RHAT, SBC_PVALUE = 1.2, 1e-4
SBC_FAMILIES = ("zero_inflated_geometric", "binomial")
# the rest of inference.  The two-component mixture of
# tests/test_marginal.py:114-138 at MIX_ROWS rows, its locations latent:
# theta ~ Beta(1, 1), a ~ N(4, 1), b ~ N(-4, 1), y_i ~ N(a or b, 0.5²),
# the Bernoulli(theta) assignment summed out (``marginalize``) under one
# RowSum; through Model.sample(kernel="fused!") at 1024 chains x (150 +
# 200) of HMC(4), held to its Laplace reference (Newton in numpy f64 in
# the constrained coordinates theta, a, b) by the logistic's bars, its
# responsibilities at the last draw of MIX_RESP_DRAWS chains within
# MIX_RESP_TOL of the MAP's on average over the rows; the kernel against
# its plain version from the fit over MIX_PARITY_ITERS iterations.
# HMC(4), not HMC(5), for the zoo's reason (ZOO_ROWS): three nearly
# independent, near-Gaussian coordinates, a step adapted to ~1 SD, and
# 5 steps near a period; at 500 + 200 of HMC(5) every mean came within
# 0.0064 Laplace SD and every SD within 0.51%, but rank-r̂ was 1.0318.
# Warmup cut from 500 to 300 (eager, 96 ms an iteration at 100k rows x
# 1024 chains) for the inference sections' time, then to 150 for the
# script's (PERF.md §4)
MIX_ROWS, MIX_SEED, MIX_SCALE = 100_000, 8, 0.5
MIX_WARMUP, MIX_DRAWS, MIX_STEPS = 150, 200, 4
MIX_RESP_DRAWS, MIX_RESP_TOL, MIX_PARITY_ITERS = 100, 0.01, 100
# Model.optimize on the 100k logistic at the default dtype: every
# coordinate within OPT_SD Laplace SD of the Laplace MAP, with one start
# and with OPT_STARTS
OPT_ITERS, OPT_STARTS, OPT_SD = 200, 8, 0.05
# ADVI on the README regression, mean-field and full-rank: means of alpha
# and the betas within ADVI_MEAN_SD posterior SD of the README main path's
# kernel posterior, full-rank SDs within ADVI_FR_SD_REL of its SDs,
# mean-field SDs at most ADVI_MF_SD_OVER above them (mean-field only
# shrinks); ``python3 chip_smoke.py advi-spread`` runs ADVI_SPREAD_SEEDS
ADVI_LR, ADVI_STEPS, ADVI_SAMPLES, ADVI_DRAWS = 0.01, 2000, 8, 4000
ADVI_MEAN_SD, ADVI_FR_SD_REL, ADVI_MF_SD_OVER = 0.5, 0.2, 0.1
ADVI_SPREAD_SEEDS = (0, 1, 2)
# auto_vip on tests/test_reparam.py:101-113's funnel build
VIP_CANDIDATES, VIP_STEPS = (0.0, 1.0), 400
# Model.smc on eight schools under SMCConfig() (4096 particles): means of
# mu and tau within SMC_MEAN_SD posterior SD and SDs within SMC_SD_REL of
# the quadrature's, log_evidence within SMC_LOGZ nats of its log Z
# (tests/test_smc.py:70-79's bar)
SMC_MEAN_SD, SMC_SD_REL, SMC_LOGZ = 0.1, 0.1, 0.5
# the README regression on the scan path in segments of CHUNK_ITERS (no
# segment count divides either phase) with a ConsoleProgress, against the
# same run unchunked (means within CHUNK_MEAN_SE Monte-Carlo SE), and
# through fused! with a progress, each CHUNK_WARMUP + CHUNK_DRAWS
# (warmup cut from 300 to 150 for the forms sections)
CHUNK_ITERS, CHUNK_CHAINS, CHUNK_WARMUP, CHUNK_DRAWS = 130, 256, 150, 200
CHUNK_MEAN_SE = 5.0
# The forms the emitter took last (the kernel runs them in CUDA: a MatVec
# of a matrix read whole by a vector past 16, an IntColumn read whole, a
# vector per row, a row-varying Gather).  A latent Gaussian process:
# GP_INPUTS inputs evenly spaced on [0, 10], a squared-exponential K of
# amplitude 1 and length scale GP_LENGTH with GP_JITTER on its diagonal,
# y = sin(x) + N(0, GP_SIGMA²) from GP_SEED, sigma fixed, so the posterior
# of f is exactly Gaussian (numpy f64).  In whitened coordinates its
# precision is I + LᵀL/σ², condition number ~1 + λmax(K)/σ² ≈ 180: warmup
# adapts a step of ~0.075 (stable on the narrowest direction, SD ~0.075),
# so HMC(GP_STEPS) makes a trajectory of ~0.9 on the widest (SD 1); at
# HMC(8) and 3000 draws rank-r̂ came out 1.00908, too near its bar (H100,
# 700 W).  Warmup is eager, ~17 ms a density call at 1024 chains (64
# scalar likelihood terms, each its own launches): 500 warmup iterations
# of HMC(16) took 138 s (H100, 700 W), so warmup is cut to GP_WARMUP of
# HMC(GP_STEPS) (rank-r̂ 1.00553 over 2000 draws at 150), then to 100
# for the script's time (PERF.md §4); draws cost the kernel ~0.3 ms each.
# Bars: every f_i's mean within GP_MEAN_SD posterior SD, its SD within
# GP_SD_REL (f evaluated at every GP_THIN-th draw), rank-r̂ < 1.01; the
# kernel against its plain version at the main path's shapes over
# GP_PARITY_ITERS iterations (the plain version is the eager density
# too), the column-free bar
GP_INPUTS, GP_SEED, GP_SIGMA, GP_LENGTH, GP_JITTER = 64, 0, 0.3, 1.0, 1e-6
GP_WARMUP, GP_DRAWS, GP_STEPS, GP_PARITY_ITERS = 100, 2000, 12, 25
GP_MEAN_SD, GP_SD_REL, GP_THIN = 0.05, 0.05, 4
# The same GP at GP_WIDE_INPUTS inputs on [0, 10], whose L (256 x 257
# floats, 263 KB) does not fit a block's shared memory beside its slots:
# its product passes read a transposed copy of L from device memory.  A
# short main path (its warmup is eager, GP_WIDE_INPUTS scalar terms a
# density call), then the density alone and the kernel against its
# plain version over GP_WIDE_PARITY_ITERS iterations from its states;
# the exact-posterior bars stay with the 64-input GP (warmup cut from 30
# to 20 for the script's time: ~0.9 s an iteration)
GP_WIDE_INPUTS, GP_WIDE_WARMUP, GP_WIDE_DRAWS = 256, 20, 200
GP_WIDE_PARITY_ITERS = 5
# the 100k logistic's data at MV32_FEATURES features
# (benchmarks/models.py:145-159 at p = 32) under the MVNormal prior:
# betas = L·z past 16 elements, held once a density call among the
# row-invariant values; warmup cut from 1000 to 300 (as the mixture's).
# Draws 800, not 200: at 200 rank-r̂ came out 1.0195 (pooled adaptation;
# an integrated autocorrelation of ~4.9 draws), and at 800 it sits near
# √(1 + 3.9/400) ≈ 1.005 (H100, 700 W; 1.00451 at 300 warmup, 1.00448 at
# 200); warmup then cut to 150 for the script's time (PERF.md §4)
MV32_FEATURES, MV32_WARMUP, MV32_DRAWS = 32, 150, 800
# the three row forms no model of the repo reaches, each at FORM_ROWS
# rows from the smallest construct that builds it, its data from
# FORM_SEED: a short main path (FORM_WARMUP + FORM_DRAWS of
# HMC(FORM_STEPS), FORM_COLLECT coordinates kept), the density at full
# width at FORM_CHECK_NEAR of its last states and FORM_CHECK_INIT inits
# against the plain version and the plain version in f64, then the
# kernel against its plain version over FORM_PARITY_ITERS iterations with
# the bar of the models with data; the forms of FORM_SAME_BITS also run
# twice from the same states and noise, held to the same bits
FORM_ROWS, FORM_SEED, FORM_GROUPS = 100_000, 9, 3
FORM_SAME_BITS = ("index column read whole", "row-varying gather")
# (warmup cut from 100 to 50 for the script's time: PERF.md §4)
FORM_WARMUP, FORM_DRAWS, FORM_STEPS, FORM_COLLECT = 50, 50, 4, 10
FORM_CHECK_NEAR, FORM_CHECK_INIT, FORM_PARITY_ITERS = 512, 64, 20
# rt.inspection.trace's run: short, since the profiler records every
# eager operation of its warmup (50 + 50 of HMC(4) took 36 s there)
INSPECT_WARMUP, INSPECT_DRAWS, INSPECT_STEPS, INSPECT_CHAINS = 20, 20, 2, 256
# the density check's bounds widen to each point's f32 conditioning
# (`conditioning`, one f64 density call a parameter) up to this many
# parameters
FORM_COND_MAX = 64
# the parallel section (rainier_tpu_torch/parallel): the 100k logistic on
# the scan path through a mesh at MAIN_CHAINS chains, PAR_WARMUP +
# PAR_DRAWS of HMC(PAR_STEPS), a depth cut to keep the section under 45 s;
# its two gloo ranks on the one card get PAR_RANKS_S seconds
PAR_WARMUP, PAR_DRAWS, PAR_STEPS, PAR_RANKS_S = 50, 50, 5, 600
# the samplers outside the kernel (NUTS, EHMC, SMC: `samplers_alone`) run
# in a process of their own, given this many seconds
SAMPLERS_S = 600


def funnel(rt, dim=10):
    """Neal's funnel, 10 dims, built through the model API
    (__graft_entry__.py:9-14), or at `dim` dims (y and a (dim - 1)-vector).
    Returns (model, y)."""
    y = rt.Normal(0.0, 3.0).latent()
    xv = rt.Normal(0.0, (y / 2).exp()).latent_vec(dim - 1)
    return rt.Model.track_({y} | set(xv.to_list())), y


def zoo(rt):
    """The goldset zoo of tests/goldset_zoo.py:28-56 as the port builds
    it: (name, SBC) pairs (that module imports the JAX package, so this
    script keeps its own copy)."""
    from rainier_tpu_torch.core import SBC

    return [
        ("uniform_normal", SBC.of(rt.Uniform(0, 1),
                                  lambda x: rt.Normal(x, 1.0))),
        ("lognormal", SBC.of(rt.LogNormal(0, 0.5),
                             lambda x: rt.Normal(x, 1.0))),
        ("exponential", SBC.of(rt.Exponential(0.5),
                               lambda x: rt.Normal(x, 1.0))),
        ("laplace", SBC.of(rt.Laplace(0, 1), lambda x: rt.Normal(x, 1.0))),
        ("gamma_normal", SBC.of(rt.Gamma(2.0, 2.0),
                                lambda x: rt.Normal(x, 2.0))),
        ("bernoulli", SBC.of(rt.Uniform(0, 1), lambda x: rt.Bernoulli(x))),
        ("binomial", SBC.of(rt.Beta(1.0, 1.0),
                            lambda x: rt.Binomial(x, 10.0))),
        ("geometric", SBC.of(rt.Uniform(0, 1), lambda x: rt.Geometric(x))),
        ("neg_binomial", SBC.of(rt.Uniform(0, 1),
                                lambda x: rt.NegativeBinomial(x, 10.0))),
        ("poisson", SBC.of(rt.Gamma(2.0, 2.0), lambda x: rt.Poisson(x))),
        ("large_poisson", SBC.of(rt.Gamma(2.0, 50.0),
                                 lambda x: rt.Poisson(x))),
        ("zero_inflated_geometric",
         SBC.of(rt.Uniform(0, 1),
                lambda x: rt.Geometric(x).zero_inflated(0.3))),
    ]


def zoo_models(rt, device):
    """Each zoo family's data, ZOO_ROWS rows synthesized on `device` by
    ``SBC.synthesize`` (seed ZOO_SEED), and its model as ``SBC.fit``
    builds it, keeping the likelihood: {name: (model, the likelihood's
    distribution, the latent, data, the true value)}."""
    out = {}
    for name, sbc in zoo(rt):
        data, truth = sbc.synthesize(ZOO_ROWS, ZOO_SEED, device)
        dist, stat = sbc.fn([p.latent() for p in sbc.priors])
        out[name] = (rt.Model.observe(data.astype(np.float64), dist), dist,
                     stat, data.astype(np.float64), truth)
    return out


def _normal_lik(sd):
    """log N(v; x, sd²) summed over the data, up to a constant, from the
    data's sums."""
    def lik(x, v):
        n, s1, s2 = v.size, v.sum(), (v * v).sum()
        return -0.5 * (s2 - 2.0 * x * s1 + n * x * x) / sd ** 2
    return lik


def zoo_log_posterior(name, data):
    """(log prior + log likelihood of x, up to constants, as a numpy f64
    function of a grid of x; the support (lo, hi)) of a zoo family on
    `data`, from the families' textbook densities and the data's
    sufficient statistics: independent of the port."""
    from scipy.special import gammaln

    n, s = data.size, data.sum()
    unit = (1e-12, 1.0 - 1e-12)
    half = (1e-12, 1e6)

    def gamma_prior(shape, scale):
        return lambda x: ((shape - 1) * np.log(x) - x / scale
                          - gammaln(shape) - shape * np.log(scale))

    priors = {
        "uniform_normal": (lambda x: 0.0 * x, unit),
        "lognormal": (lambda x: -np.log(x) - np.log(x) ** 2 / (2 * 0.25),
                      half),
        "exponential": (lambda x: -0.5 * x, half),
        "laplace": (lambda x: -np.abs(x), (-1e6, 1e6)),
        "gamma_normal": (gamma_prior(2.0, 2.0), half),
        "poisson": (gamma_prior(2.0, 2.0), half),
        "large_poisson": (gamma_prior(2.0, 50.0), half),
    }
    prior, support = priors.get(name, (lambda x: 0.0 * x, unit))
    n0 = float(np.sum(data == 0))
    liks = {
        "uniform_normal": _normal_lik(1.0), "lognormal": _normal_lik(1.0),
        "exponential": _normal_lik(1.0), "laplace": _normal_lik(1.0),
        "gamma_normal": _normal_lik(2.0),
        "bernoulli": lambda x, v: s * np.log(x) + (n - s) * np.log1p(-x),
        "binomial": lambda x, v: (s * np.log(x)
                                  + (10.0 * n - s) * np.log1p(-x)),
        "geometric": lambda x, v: n * np.log(x) + s * np.log1p(-x),
        "neg_binomial": lambda x, v: (10.0 * n * np.log1p(-x)
                                      + s * np.log(x)),
        "poisson": lambda x, v: s * np.log(x) - n * x,
        "large_poisson": lambda x, v: s * np.log(x) - n * x,
        "zero_inflated_geometric": lambda x, v: (
            n0 * np.log(0.3 + 0.7 * x) + (n - n0) * (np.log(0.7)
                                                     + np.log(x))
            + s * np.log1p(-x)),
    }
    lik = liks[name]
    return lambda x: prior(x) + lik(x, data), support


def quadrature(log_post, support):
    """Posterior (mean, SD) of a 1-D log density on a grid of ZOO_GRID
    points over the support, refined around the mass: each of six rounds'
    grids spans the last round's mean ± 12 SD, in numpy f64."""
    lo, hi = support
    a, b = lo, hi
    for _ in range(6):
        x = np.linspace(a, b, ZOO_GRID)
        with np.errstate(all="ignore"):
            lp = log_post(x)
        lp = np.where(np.isfinite(lp), lp, -np.inf)
        w = np.exp(lp - lp.max())
        w /= w.sum()
        mean = float(np.dot(w, x))
        sd = max(float(np.sqrt(np.dot(w, (x - mean) ** 2))),
                 (b - a) / (ZOO_GRID - 1))
        a, b = max(lo, mean - 12 * sd), min(hi, mean + 12 * sd)
    return mean, sd


def linear_slot(cd, expr):
    """(slot, factor) of an expression that is a factor times one
    coordinate of the sampler's layout (the funnel's y = 3·z), found by
    evaluating it at every unit vector in f64."""
    from rainier_tpu_torch.compute import interp

    vals = np.asarray(interp.evaluate_lanes(
        [expr], cd.layout.env_for_lanes(np.eye(cd.n_vars)),
        interp.NUMPY_BACKEND, np.float64)[0], dtype=np.float64).ravel()
    check(np.count_nonzero(vals) == 1, ("not one coordinate", vals))
    slot = int(np.flatnonzero(vals)[0])
    return slot, float(vals[slot])


def eight_schools(rt):
    """benchmarks/models.py:49-60: mu ~ N(0, 5), tau = |Cauchy(0, 5)|,
    theta_i ~ N(mu, tau) non-centred, y_i ~ N(theta_i, sigma_i).
    Returns (model, mu, tau, theta_1)."""
    mu = rt.Normal(0, 5).latent()
    tau = rt.Cauchy(0, 5).latent().abs()
    thetas = rt.Normal(mu, tau).latent_vec(len(EIGHT_Y))
    model = rt.Model.empty()
    for i, (y, s) in enumerate(zip(EIGHT_Y, EIGHT_SIGMA)):
        model = model.merge(rt.Model.observe([y], rt.Normal(thetas[i], s)))
    return model, mu, tau, thetas[0]


def eight_schools_quadrature(mu_grid=QUAD_MU, tau_grid=QUAD_TAU):
    """Posterior (mean, SD) of mu, tau and theta_1 of eight schools, by
    quadrature in numpy f64, independent of the port: theta integrated out
    (y_i | mu, tau ~ N(mu, sigma_i² + tau²)), then a grid over (mu, tau)
    of N(mu; 0, 5²) · half-Cauchy(tau; 5) · Π_i N(y_i; mu, sigma_i² +
    tau²).  theta_1 | mu, tau, y is normal with the precision-weighted
    mean and variance tau²·sigma_1² / (tau² + sigma_1²).  "log_z" is the
    log evidence, the same integrand with every constant (N(mu; 0, 5²),
    the half-Cauchy 2/(5π(1 + (τ/5)²)) that |Cauchy(0, 5)| is, and the
    eight normals) by the trapezoid rule on the grid."""
    mu = np.linspace(*mu_grid)[:, None]
    tau = np.linspace(*tau_grid)[None, :]
    y, s2 = np.asarray(EIGHT_Y), np.asarray(EIGHT_SIGMA) ** 2
    logp = -0.5 * (mu / 5.0) ** 2 - np.log1p((tau / 5.0) ** 2)
    for yi, si2 in zip(y, s2):
        v = si2 + tau ** 2
        logp = logp - 0.5 * np.log(v) - 0.5 * (yi - mu) ** 2 / v
    w = np.exp(logp - logp.max())
    trap = (np.diff(np.linspace(*mu_grid))[0] * np.diff(np.linspace(
        *tau_grid))[0] * np.outer(_trapezoid(mu_grid[2]),
                                  _trapezoid(tau_grid[2])))
    const = (-0.5 * np.log(2 * np.pi * 25.0) + np.log(2.0 / (5.0 * np.pi))
             - 0.5 * len(y) * np.log(2 * np.pi))
    log_z = float(logp.max() + np.log(np.sum(w * trap)) + const)
    w /= w.sum()

    def moments(mean, var=0.0):
        m = float(np.sum(w * mean))
        return m, float(np.sqrt(np.sum(w * ((mean - m) ** 2 + var))))

    t2 = tau ** 2
    grid = np.broadcast_to
    return {"mu": moments(grid(mu, w.shape)),
            "tau": moments(grid(tau, w.shape)),
            "theta_1": moments((y[0] * t2 + mu * s2[0]) / (t2 + s2[0]),
                               t2 * s2[0] / (t2 + s2[0])),
            "log_z": log_z}


def _trapezoid(n):
    """Trapezoid weights of n grid points, in units of the spacing."""
    w = np.ones(n)
    w[[0, -1]] = 0.5
    return w


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


def logistic_regression(rt, n=None, p=None):
    """benchmarks/models.py:145-159 at n rows (default LOGIT_ROWS) and p
    features (default LOGIT_FEATURES), data regenerated from its seed:
    (model, x (n, p), ys (n,)); the parameters are alpha, then betas."""
    from rainier_tpu_torch.compute import real as R

    rng = np.random.default_rng(LOGIT_SEED)
    n, p = n or LOGIT_ROWS, p or LOGIT_FEATURES
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


def mv_cov(p=LOGIT_FEATURES):
    """The coefficients' prior covariance: AR(1) at the prior's scale."""
    i = np.arange(p)
    return LOGIT_PRIOR_SD ** 2 * MV_RHO ** np.abs(i[:, None] - i[None, :])


def mvnormal_logistic(rt, x, ys):
    """The logistic regression of `x`, `ys` with betas ~ MVNormal(0,
    mv_cov()), built with the documented Vec API (docs/model.md:23-30):
    each element of betas reads the Cholesky factor, a (p, p) column
    that the kernel reads whole.  Returns (model, alpha, betas)."""
    alpha = rt.Normal(0, LOGIT_PRIOR_SD).latent()
    betas = rt.MVNormal([0.0] * x.shape[1], mv_cov(x.shape[1])).latent_vec()
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
             pz.id: x @ np.linalg.cholesky(mv_cov(x.shape[1]))}
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
    card around whole calls, host work included; the host clock
    elsewhere.  ``kernel_ab.launch_ms`` times a kernel's launches alone."""
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
    # the columns bound once, as Model.sample binds them (ROADMAP C1)
    kw = dict(step_size=eps, n_steps=n_steps, n_iterations=n_iters, seed=11,
              inv_mass_diag=imd, collect_every=collect_every,
              collect_idx=collect_idx,
              columns=cd.column_values(torch.float32, device))
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
    in device memory (0 for a model whose state stays in the thread or
    whose slot lies in the block's shared memory, which that traffic
    never leaves): x read, g written, and the row-invariant values and
    their adjoints each written and read."""
    return 4 * (2 * em.n_vars + 4 * em.n_inv) \
        if em.workspace and not em.shared else 0


def kernel_bound_ms(em, n_chains, n_iters, n_steps, collect_every, F,
                    col_bytes=0, n_collect=None, past_l2=False,
                    noise=False, whole=0):
    """Least time the card could take for one fused_hmc call: the larger
    of its bytes over the memory rate and its operations over the f32
    rate (Philox integer operations counted at the f32 rate).  For a
    model with its state in a workspace larger than the card's L2
    (glmm_large's 369 MB), each density call's workspace bytes and each
    leapfrog step's momentum and position (read and written) count too: a
    workspace inside L2 (the 1000-dim funnel's 28.7 MB) need not reach
    device memory.  Columns past the card's L2 (`past_l2`) come from
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
    if F.workspace_bytes(em, n_chains) > (F.l2_bytes(DEVICE) or 0):
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


@contextlib.contextmanager
def beside(mode, timeout):
    """Runs ``python3 chip_smoke.py MODE`` in a process of its own while
    the block runs, then waits for it (at most `timeout` seconds from its
    start), prints its phase lines and fails if it failed.  The process is
    killed if the block raises."""
    import tempfile

    with tempfile.TemporaryFile() as out:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 mode], stdout=out, stderr=subprocess.STDOUT)
        try:
            yield
            t_join = time.perf_counter()
            proc.wait(timeout=max(timeout - (t_join - t0), 1))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out.seek(0)
        text = out.read().decode(errors="replace")
    for line in text.splitlines():
        if line.startswith("phase "):
            print(line, flush=True)
    print(f"phase time, {mode} in its own process: "
          f"{time.perf_counter() - t0:.1f} s, of them "
          f"{time.perf_counter() - t_join:.1f} s after the block beside it",
          flush=True)
    check(proc.returncode == 0, f"{mode}: {text[-3000:]}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def layout(F, em, n_chains):
    """How a launch over n_chains lays out the chains: lanes a chain and
    chains a block, and where a chain's state lives."""
    return (f"{F.lanes_per_chain(em, n_chains)} lanes a chain, "
            f"{F.chains_per_block(em, n_chains)} chains a block of "
            f"{F.threads_per_block(em, n_chains)} threads, state "
            f"{'in a workspace slot' if em.workspace else 'in registers'}")


def build_all(F, models, launches):
    """Build every model's kernel for each chain count its launches use
    (`launches`: {name: counts}), one nvcc each, all started together;
    print each build's layout, sizes and what ptxas reports.  Returns
    each model's emitted density."""
    from concurrent.futures import ThreadPoolExecutor

    from rainier_tpu_torch.compute import emit_cuda

    def build(job):
        cd = models[job[0]]
        return F.build(cd, F.lanes_per_chain(emit_cuda.emit(cd), job[1]))

    jobs = [(name, n) for name in models for n in launches.get(
        name, (MAIN_CHAINS,))]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(build, jobs)))
    print(f"phase build: {len(jobs)} kernels in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    ems = {}
    for (name, n), (kernels, secs, em) in built.items():
        ptxas = " | ".join(
            line.split("ptxas info    : ")[-1].strip()
            for line in kernels.log.splitlines()
            if "registers" in line or "spill" in line)
        spaces = "; ".join(f"{sp.n_rows} rows of {sp.row_width} floats, "
                           f"{sp.row_ops} ops a row, tile {sp.tile_rows} "
                           f"rows" for sp in em.spaces) or "no rows"
        print(f"phase build: {name} at {n} chains: {layout(F, em, n)}; "
              f"{em.n_vars} dims, {em.ops} ops per "
              f"logp+grad apart from rows, row spaces: {spaces}, "
              f"{whole_bytes(models[name])} bytes of columns read whole, "
              f"{em.n_inv} row-invariant values, "
              f"workspace {em.workspace} floats a chain"
              f"{' in shared memory' if em.shared else ''}; "
              f"{len(em.source.splitlines())} lines emitted; {secs:.2f} s; "
              f"ptxas: {ptxas}", flush=True)
        ems[name] = em
    # the registers and spills of each row kernel's sampling loop, both
    # tile loops (the streamed one is the card's default)
    for (name, n), (kernels, _, em) in built.items():
        if em.spaces:
            regs = ptxas_kernels(kernels.log)
            print(f"phase registers, {name}: " + "; ".join(
                f"fused_hmc {'streamed' if k else 'synchronous'} "
                f"{r} registers, spill stores {st} bytes, spill loads "
                f"{ld} bytes" for k, (r, st, ld) in sorted(
                    regs.get("fused_hmc_kernel", {}).items())), flush=True)
    return ems


def ptxas_kernels(log):
    """{kernel: {streaming flag: (registers, spill stores, spill loads)}}
    from a build's `-Xptxas=-v` output, for the kernels fused_hmc_kernel
    and logp_grad_kernel of fused_hmc.cu, by their mangled names."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for _Z\d+(\w+?)ILi(\d)E", line)
        if m:
            cur = (m.group(1), int(m.group(2)))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out.setdefault(cur[0], {})[cur[1]] = (int(m.group(1)), *spills)
            cur = None
    return out


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

    from rainier_tpu_torch.tools.kernel_ab import launch_ms

    n_chains, n_iters = tr.chains.shape[0], n_iters or tr.chains.shape[1]
    q0, kw = parity_inputs(
        cd, device, n_chains, n_iters, explicit_noise,
        start=(tr.final_q.T, tr.step_size, tr.mass.diag), n_steps=n_steps,
        collect_idx=collect_idx)
    kw["seed"] = 1
    ker, call_ms = timed(lambda: F.fused_hmc(cd, q0, **kw), device, reps,
                         reps > 1)
    # the launch alone: the median of LAUNCH_REPS after a warm one where
    # the whole call is short, else one
    short = call_ms < LAUNCH_SHORT_MS
    _, ker_ms = launch_ms(F.prepare_fused_hmc(cd, q0, **kw), device,
                          LAUNCH_REPS if short else 1, warm=short)
    launches = f"median of {LAUNCH_REPS}" if short else "one"
    plain, plain_ms = timed(lambda: F.fused_hmc_reference(cd, q0, **kw),
                            device, 1, False)
    law, z = "", 0.0
    if agree_at is not None:
        ker, plain, law, z = chaotic(F, cd, q0, kw, ker, plain, agree_at,
                                     tol, device)
    frac, max_err, dacc, div_eq = agreement(ker, plain, tol)
    acc = f"{float(ker[2].mean()):.4f} and {float(plain[2].mean()):.4f}"
    n_collect = cd.n_vars if collect_idx is None else len(collect_idx)
    bound_ms, bound_by = kernel_bound_ms(em, n_chains, n_iters, n_steps, 1,
                                         F, col_bytes, n_collect,
                                         noise=explicit_noise, whole=whole)
    print(f"phase kernel at main-path shapes, {what} ({n_chains} chains x "
          f"{n_iters} it x {n_steps} steps, {layout(F, em, n_chains)}, "
          f"{'explicit noise' if explicit_noise else 'on-device Philox'}, "
          f"{n_collect} coordinates of each draw collected, workspace "
          f"{F.workspace_bytes(em, n_chains)} bytes): kernel "
          f"{ker_ms:.4f} ms a launch ({launches}), {call_ms:.4f} ms a "
          f"whole call (mean of {reps}), plain {plain_ms:.1f} ms, bound "
          f"{bound_ms:.4f} "
          f"ms ({bound_by}), {frac:.4f} of chains agree within {tol} rel "
          f"after {agree_at or n_iters} it (need {min_frac:.4f}), "
          f"max |dq| {max_err:.3g}, mean accept of kernel and plain {acc}, "
          f"mean |d accept| {dacc:.3g}, divergences equal {div_eq}{law}",
          flush=True)
    check(frac >= min_frac and dacc < max_dacc and div_eq
          and z <= GLMM_MOMENT_Z, (what, frac, dacc, div_eq, z))
    return dict(max_abs_err=max_err, ms=ker_ms, call_ms=call_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def rank_rhat(tr):
    """Max over the parameters of the rank-normalized split r̂ (Vehtari et
    al. 2021) of a Trace: ``Trace.diagnostics(rank_normalized=True)``,
    computed on the card that holds its draws."""
    return max(d.r_hat for d in tr.diagnostics(rank_normalized=True))


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
    """The column-free funnel's phases; returns (its JSON entries, its
    main path's trace)."""
    import torch

    from rainier_tpu_torch.tools.kernel_ab import launch_ms

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
    # the same with explicit noise (the host_rng counterpart)
    noise_entry = time_kernel(F, cd, em, tr, N_STEPS, device, 0,
                              "funnel", reps=20, explicit_noise=True)

    # throughput: bench.py's configuration on the model-built funnel
    qz = torch.zeros((cd.n_vars, THROUGHPUT_CHAINS), device=device)
    tp_kw = dict(step_size=THROUGHPUT_EPS, n_steps=N_STEPS, seed=0,
                 collect_every=0)
    _, tp_ms = launch_ms(F.prepare_fused_hmc(
        cd, qz, n_iterations=THROUGHPUT_ITERS, **tp_kw), device, LAUNCH_REPS)
    _, tp_plain_ms = timed(lambda: F.fused_hmc_reference(
        cd, qz, n_iterations=50, **tp_kw), device, 1, False)
    evals = THROUGHPUT_CHAINS * THROUGHPUT_ITERS * N_STEPS
    tp_bound_ms, tp_bound_by = kernel_bound_ms(
        em, THROUGHPUT_CHAINS, THROUGHPUT_ITERS, N_STEPS, 0, F)
    print(f"phase throughput: {THROUGHPUT_CHAINS} chains x "
          f"{THROUGHPUT_ITERS} it x {N_STEPS} steps, eps {THROUGHPUT_EPS}: "
          f"kernel {tp_ms:.4f} ms a launch (median of {LAUNCH_REPS}) = "
          f"{evals / tp_ms * 1e3:.4g} grad evals/s "
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
             "launches": 0, **noise_entry, "library_ms": None}], tr


def funnel_truth(q):
    """The funnel's lp and gradient at every column of q (dim, m), in f64
    in closed form: in the sampler's coordinates (y = 3·q_0, x_i =
    exp(y/2)·q_i) every coordinate is a standard normal, so lp =
    -|q|²/2 - (dim/2)·log 2π and g = -q."""
    import torch

    q = q.double()
    return (-0.5 * (q * q).sum(0) - 0.5 * q.shape[0] * np.log(2 * np.pi),
            -q)


def wide_phases(F, cd, model, y, em, device):
    """The funnel at WIDE_DIM dims, its state in the workspace, a warp a
    chain: the density at full width against its f64 closed form, kernel
    vs plain in both RNG modes, the main path keeping WIDE_COLLECT
    coordinates held to the funnel's y bars, and the kernel at the main
    path's shapes.  The density sums 999 terms, whose order the lanes
    change, so the two versions' lp differ by E|Δlp| (measured by the
    density check at the parity inputs, once it has held the kernel to
    the f64 truth) and an accept may flip: the comparisons take the bar
    of the models with data, at least agree_frac(n, E|Δlp|) of chains
    within 1e-3 after n iterations.  Returns its JSON entries."""
    import torch

    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    q0, _ = parity_inputs(cd, device, MAIN_CHAINS, 1, False)
    inits = SamplerConfig().init_scale * np.random.default_rng(8).normal(
        size=(cd.n_vars, LOGIT_CHECK_INIT))
    q = torch.cat([q0, torch.as_tensor(inits, dtype=torch.float32,
                                       device=device)], dim=1)
    dlp_mean, density_entry = density_check(
        F, cd, em, q, funnel_truth(q), MAIN_CHAINS, "parity inputs", device,
        "rainier_tpu/ops/hmc_pallas.py:257")
    min_frac = agree_frac(WIDE_PARITY_ITERS, dlp_mean)
    for explicit in (True, False):
        parity_phase(F, cd, device, MAIN_CHAINS, WIDE_PARITY_ITERS, explicit,
                     min_frac=min_frac, tol=1e-3, max_dacc=0.02)

    slot, factor = linear_slot(cd, y)
    idx = np.r_[slot, [d for d in range(WIDE_COLLECT) if d != slot]][
        :WIDE_COLLECT]
    cfg = SamplerConfig(WIDE_WARMUP, WIDE_DRAWS, sampler=HMC(N_STEPS))
    F.fused_hmc.launches = 0
    tr = model.sample(cfg, n_chains=MAIN_CHAINS, seed=0, kernel="fused!",
                      device=device, collect_idx=idx)
    launches = F.fused_hmc.launches
    ys = factor * tr.chains[:, :, 0]
    mean_y, var_y = float(np.mean(ys)), float(np.var(ys))
    rhat = rank_rhat(tr)
    print(f"phase main path, funnel {WIDE_DIM}: Model.sample(kernel='fused!',"
          f" collect_idx={WIDE_COLLECT} coordinates) {MAIN_CHAINS} chains x "
          f"({WIDE_WARMUP} warmup + {WIDE_DRAWS} draws), HMC({N_STEPS}): "
          f"fused_hmc launches {launches}, mean(y) {mean_y:.4f}, var(y) "
          f"{var_y:.4f}, rank-r_hat max {rhat:.5f}, accept "
          f"{float(np.mean(tr.accept_rate())):.3f}, divergences "
          f"{tr.divergences()}, step size median "
          f"{float(np.median(tr.step_size)):.4g}, timings {tr.timings}",
          flush=True)
    check(launches >= 1, f"fused_hmc launches {launches}")
    check(np.all(np.isfinite(tr.chains)) and tr.chains.shape == (
        MAIN_CHAINS, WIDE_DRAWS, WIDE_COLLECT), tr.chains.shape)
    check(abs(mean_y) < 0.3 and abs(var_y / 9.0 - 1.0) < 0.15,
          (mean_y, var_y))
    check(rhat < 1.01, rhat)
    entry = time_kernel(F, cd, em, tr, N_STEPS, device, 0,
                        f"funnel {WIDE_DIM}", min_frac=min_frac, tol=1e-3,
                        max_dacc=0.02, collect_idx=idx)
    return [{"name": f"fused_hmc (funnel, {WIDE_DIM} dims, state in the "
                     f"workspace)", "route": "cuda",
             "source": "rainier_tpu_torch/csrc/fused_hmc.cu",
             "replaces": "rainier_tpu/ops/hmc_pallas.py:257",
             "launches": launches, **entry, "library_ms": None},
            {**density_entry, "name": f"rt_logp_grad_launch (funnel, "
                                      f"{WIDE_DIM} dims)", "launches": 0}]


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
                  replaces, cond=None, plain_off=False):
    """rt_logp_grad_launch against autograd on the plain version and
    against the f64 `truth` (lp, g), at full width, at every column of q:
    the first `n_near` columns are `near_name`, the rest inits.
    Tolerances per point: |Δlp| within 0.01 nats or two f32 ulps of lp,
    whichever is larger (two f32 results of the same sum differ by
    rounding alone up to an ulp); |Δg| within 1e-4 of the point's max
    |g|.  `cond` = (lp (n,), g (dim, n)) from `conditioning` widens each
    bound to what the value moves when the inputs move by two f32
    rounding units, where that is larger.  With `plain_off` the bound of
    kernel against plain widens, per point and entry, by the plain
    version's own distance from f64.  Returns (mean |Δlp| kernel vs
    plain over the near points, the JSON entry)."""
    import torch

    from rainier_tpu_torch.tools.kernel_ab import launch_ms

    before = F.logp_grad.launches, F.logp_grad.streamed
    cols = cd.column_values(torch.float32, device)
    # whole calls: one warm-up, then the mean of three; then the launch
    # alone, the median of LAUNCH_REPS after a warm one
    _, call_ms = timed(lambda: F.logp_grad(cd, q, columns=cols), device, 3)
    (lp_k, g_k), ms = launch_ms(F.prepare_logp_grad(cd, q, cols), device,
                                LAUNCH_REPS)
    (lp_p, g_p), plain_ms = timed(
        lambda: F.logp_grad_reference(cd, q, cols), device, 1, False)
    lp_t, g_t = truth
    check(F.logp_grad.launches == before[0] + DENSITY_LAUNCHES,
          "logp_grad did not launch")
    streamed = F.logp_grad.streamed - before[1]
    tol_lp, tol_g, gmax = density_bars(lp_t, g_t)
    if cond is not None:
        tol_lp = torch.maximum(tol_lp, cond[0].float())
        tol_g = torch.maximum(tol_g, cond[1].float())
    tols = {}
    if plain_off:
        # the kernel within the bar of the plain version plus the plain
        # version's own distance from f64, per point and entry: where the
        # plain version's f32 sums are the less exact, as an autograd
        # scatter-add of 33,000 f32 terms an entry is
        tols["kernel-vs-plain"] = (tol_lp + (lp_p - lp_t.float()).abs(),
                                   tol_g + (g_p - g_t.float()).abs())
    groups = {near_name: slice(0, n_near), "inits": slice(n_near, None)}
    worst, lines = {}, []
    for name, (lp, g) in (("kernel-vs-plain", (lp_k - lp_p, g_k - g_p)),
                          ("kernel-vs-f64", (lp_k - lp_t.float(),
                                             g_k - g_t.float())),
                          ("plain-vs-f64", (lp_p - lp_t.float(),
                                            g_p - g_t.float()))):
        t_lp, t_g = tols.get(name, (tol_lp, tol_g))
        dlp, dg = lp.abs(), (g.abs().amax(0) / gmax)
        rel, rel_g = dlp / t_lp, (g.abs() / t_g).amax(0)
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
          f"{streamed} of {DENSITY_LAUNCHES} launches streamed "
          f"({n_near} {near_name}, {n - n_near} inits; "
          f"max |g| {float(gmax[groups[near_name]].max()):.4g} and "
          f"{float(gmax[groups['inits']].max()):.4g}, |lp| up to "
          f"{float(lp_t.abs().max()):.4g}); " + "; ".join(lines)
          + f"; kernel {ms:.4f} ms a launch (median of {LAUNCH_REPS}), "
          f"{call_ms:.4f} ms a whole call (mean of 3), plain "
          f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by})",
          flush=True)
    for k in ("kernel-vs-plain", "kernel-vs-f64"):
        check(worst[k][1] <= 1.0 and worst[k][2] <= 1.0, (k, worst[k]))
    near_dlp = float((lp_k - lp_p).abs()[groups[near_name]].mean())
    return near_dlp, dict(
        name="rt_logp_grad_launch", route="cuda",
        source="rainier_tpu_torch/csrc/fused_hmc.cu", replaces=replaces,
        max_abs_err=worst["kernel-vs-plain"][0], ms=ms, call_ms=call_ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None)


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
    against the numpy least-squares fit; returns (its JSON entry, its
    main path's trace)."""
    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    model, xs, ys, (sigma, alpha, betas) = readme
    cd = model.density()
    xa = np.hstack([np.ones((xs.shape[0], 1)), xs])
    coef = np.linalg.lstsq(xa, ys, rcond=None)[0]
    resid_sd = float(np.sqrt(np.sum((ys - xa @ coef) ** 2)
                             / (xs.shape[0] - xa.shape[1])))
    cfg = SamplerConfig(README_WARMUP, N_DRAWS, sampler=HMC(N_STEPS))
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
          f"'fused!') {MAIN_CHAINS} chains x ({README_WARMUP} warmup + "
          f"{N_DRAWS}"
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
            "launches": launches, **entry, "library_ms": None}, tr


def logistic_main(F, model, cd, em, w_map, cov, device, min_frac,
                  what="logistic regression", pooled=False,
                  warmup=LOGIT_WARMUP, draws=LOGIT_DRAWS):
    """A logistic regression through Model.sample(kernel="fused!"),
    `warmup` + `draws` iterations, against its Laplace reference, then
    timed against its plain version over LOGIT_TIME_ITERS iterations with
    the logistic parity phases' bar (`min_frac` within 1e-3 rel);
    `pooled` adapts ε and Σ̂ pooled over the chains.  Returns (its JSON
    entry's numbers and launches, the trace)."""
    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    cfg = SamplerConfig(warmup, draws, sampler=HMC(LOGIT_STEPS),
                        pooled_adaptation=pooled)
    F.fused_hmc.launches = 0
    tr = model.sample(cfg, n_chains=MAIN_CHAINS, seed=0, kernel="fused!",
                      device=device)
    launches = F.fused_hmc.launches
    flat = tr.flat().astype(np.float64)
    sd_ref = np.sqrt(np.diag(cov))
    dmean = np.abs(flat.mean(0) - w_map) / sd_ref
    dsd = np.abs(flat.std(0) / sd_ref - 1.0)
    rhat = rank_rhat(tr)
    print(f"phase main path, {what}: Model.sample(kernel="
          f"'fused!') {MAIN_CHAINS} chains x ({warmup} warmup + "
          f"{draws} draws), HMC({LOGIT_STEPS}), "
          f"{'pooled' if pooled else 'per-chain'} adaptation, "
          f"{em.n_rows} rows x "
          f"{cd.n_vars - 1} features: fused_hmc launches {launches}, "
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
    sampling phase after SCAN_WARMUP warmup iterations, which sample_s
    does not count): its sample_s beside the kernel's `tr`, the
    comparison of ROADMAP C1."""
    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    cfg = SamplerConfig(SCAN_WARMUP, LOGIT_DRAWS, sampler=HMC(LOGIT_STEPS))
    tr_scan = model.sample(cfg, n_chains=MAIN_CHAINS, seed=1, kernel="scan",
                           device=device)
    print(f"phase scan path, {what}: Model.sample(kernel='scan') "
          f"{MAIN_CHAINS} chains x ({SCAN_WARMUP} warmup + {LOGIT_DRAWS} "
          f"draws), HMC({LOGIT_STEPS}): accept "
          f"{float(np.mean(tr_scan.accept_rate())):.3f}, timings "
          f"{tr_scan.timings}; the kernel's sample_s "
          f"{tr.timings['sample_s']} s against the scan path's "
          f"{tr_scan.timings['sample_s']} s", flush=True)
    check(np.all(np.isfinite(tr_scan.chains)), "non-finite scan-path draws")


def mvnormal_phases(F, mv, cd, em, x, ys, device, what="MVNormal logistic",
                    warmup=LOGIT_WARMUP, draws=LOGIT_DRAWS):
    """The 100k logistic under the MVNormal prior: its Laplace reference
    (on its design, `mv_design`), the density at full width near the MAP
    and at inits, the main path (`warmup` + `draws`) held to the Laplace
    reference as the logistic's is, the betas it draws (Trace.evaluate)
    against L·z in numpy, and the kernel against its plain version at the
    main path's shapes.  Returns its JSON entries."""
    from rainier_tpu_torch.compute.compiler import find_parameters

    model, alpha, betas = mv
    design = mv_design(cd, x, alpha, betas)
    t0 = time.perf_counter()
    w_map, cov = laplace_design(design, ys)
    print(f"phase Laplace reference, {what}: Newton in f64 on "
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
                              what, pooled=True, warmup=warmup, draws=draws)
    # betas on the model's scale: L·z from the draws of z, in numpy f64
    (pz,) = find_parameters(betas.to_list())
    a, b = cd.layout.slices[cd.layout.parameters.index(pz)]
    want = tr.flat()[:, a:b].astype(np.float64) @ np.linalg.cholesky(
        mv_cov(x.shape[1])).T
    got = np.stack(tr.evaluate(betas.to_list()), axis=1)
    err = float(np.abs(got - want).max())
    print(f"phase Trace.evaluate, {what}: betas at "
          f"{got.shape[0]} draws against L z in numpy: max |d| {err:.3g}, "
          f"posterior means {np.round(got.mean(0), 4).tolist()}",
          flush=True)
    check(got.shape == want.shape and err <= 1e-9 * max(
        1.0, float(np.abs(want).max())), ("betas", got.shape, err))
    return [{"name": f"fused_hmc ({what}, columns read whole)",
             "replaces": "rainier_tpu/ops/hmc_pallas.py:282", **entry},
            {**density_entry, "name": f"rt_logp_grad_launch ({what}, "
                                      "columns read whole)",
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
    shapes.  Returns (its JSON entries, its main path's trace)."""
    import torch

    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    cfg = SamplerConfig(GLMM_WARMUP, GLMM_DRAWS, sampler=HMC(GLMM_STEPS))

    def summary(tr):
        return (f"rank-r_hat max {rank_rhat(tr):.5f}, "
                f"accept {float(np.mean(tr.accept_rate())):.3f}, divergences "
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
             "launches": 0}], tr


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
        return (f"rank-r_hat max {rank_rhat(tr):.5f}, "
                f"accept {float(np.mean(tr.accept_rate())):.3f}, divergences "
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
        return (f"rank-r_hat max {rank_rhat(tr):.5f}, "
                f"accept {float(np.mean(tr.accept_rate())):.3f}, divergences "
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
        check(F.logp_grad.streamed - before == DENSITY_LAUNCHES,
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


def loop_summary(counts, n_iters):
    """What the batched loops of EHMC or NUTS paid over a run of
    `n_iters` transitions (sampler.stats.COUNTS)."""
    return (f"{counts.steps / n_iters:.2f} lockstep steps an iteration, "
            f"{counts.syncs / n_iters:.2f} host syncs an iteration")


def nuts_phase(rt, device):
    """Eight schools through Model.sample with NUTS(max_depth=8) and dense
    mass at 1024 chains, held to the quadrature: the means of mu, tau and
    theta_1 (evaluated: tau, not the Cauchy coordinate, whose posterior is
    symmetric in sign) within NUTS_MEAN_SD posterior SDs, the SDs of mu
    and tau within NUTS_SD_REL, rank-r̂ < 1.01 on the three.  Returns the
    quadrature."""
    import torch

    from rainier_tpu_torch.core.trace import Trace
    from rainier_tpu_torch.ops import fused_hmc as F
    from rainier_tpu_torch.sampler import (NUTS, DenseMassMatrixTuner,
                                           SamplerConfig)
    from rainier_tpu_torch.sampler.stats import COUNTS

    t0 = time.perf_counter()
    quad = eight_schools_quadrature()
    print(f"phase quadrature, eight schools: {QUAD_MU[2]} x {QUAD_TAU[2]} "
          f"grid in f64, (mean, SD) {quad} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    model, mu, tau, theta1 = eight_schools(rt)
    cfg = SamplerConfig(NUTS_WARMUP, NUTS_DRAWS,
                        sampler=NUTS(max_depth=NUTS_DEPTH),
                        mass_matrix=DenseMassMatrixTuner())
    F.fused_hmc.launches = 0
    COUNTS.reset()
    tr = model.sample(cfg, n_chains=MAIN_CHAINS, seed=0, device=device)
    launches = F.fused_hmc.launches
    n_iters = NUTS_WARMUP + NUTS_DRAWS
    check(COUNTS.iterations == n_iters, COUNTS.iterations)
    depths = COUNTS.depths.cpu().numpy()
    got = {name: tr.evaluate(e).reshape(MAIN_CHAINS, NUTS_DRAWS)
           for name, e in (("mu", mu), ("tau", tau), ("theta_1", theta1))}
    rhat = rank_rhat(Trace(torch.as_tensor(
        np.stack(list(got.values()), axis=-1), device=device), model, None,
        cfg))
    secs = tr.timings["warmup_s"] + tr.timings["sample_s"]
    print(f"phase main path, eight schools (NUTS, dense mass): "
          f"Model.sample {MAIN_CHAINS} chains x ({NUTS_WARMUP} warmup + "
          f"{NUTS_DRAWS} draws), NUTS(max_depth={NUTS_DEPTH}), "
          f"DenseMassMatrixTuner: fused_hmc launches {launches}; (mean, SD) "
          + ", ".join(f"{k} ({np.mean(v):.4f}, {np.std(v):.4f})"
                      for k, v in got.items())
          + f"; rank-r_hat max {rhat:.5f}, divergences {tr.divergences()}, "
          f"tree depth mean "
          f"{np.dot(depths, np.arange(len(depths))) / depths.sum():.3f} "
          f"max {int(np.flatnonzero(depths).max())} (histogram "
          f"{depths.tolist()}), {loop_summary(COUNTS, n_iters)}, "
          f"{secs / COUNTS.steps * 1e3:.3f} ms a lockstep leaf, "
          f"sampling-phase leaves a chain an iteration "
          f"{np.mean(tr.stats.grad_evals) / NUTS_DRAWS:.2f}, "
          f"accept {float(np.mean(tr.accept_rate())):.3f}, step size median "
          f"{float(np.median(tr.step_size)):.4g}, timings {tr.timings}",
          flush=True)
    check(np.all(np.isfinite(tr.chains)) and tr.chains.shape == (
        MAIN_CHAINS, NUTS_DRAWS, 10), tr.chains.shape)
    check(tr.mass.cov.shape == (MAIN_CHAINS, 10, 10), tr.mass.cov.shape)
    for k, v in got.items():
        m, sd = quad[k]
        check(abs(np.mean(v) - m) < NUTS_MEAN_SD * sd,
              (k, "mean", float(np.mean(v)), m, sd))
        if k != "theta_1":
            check(abs(np.std(v) / sd - 1.0) < NUTS_SD_REL,
                  (k, "SD", float(np.std(v)), sd))
    check(rhat < 1.01, rhat)
    return quad


def ehmc_phase(rt, device):
    """The model-built funnel under the default config, EHMC(1024)
    synchronized, at 1024 chains: the funnel's bars, and the same
    sampling-phase gradient evaluations on every chain (the shared draw)."""
    from rainier_tpu_torch.ops import fused_hmc as F
    from rainier_tpu_torch.sampler import SamplerConfig
    from rainier_tpu_torch.sampler.stats import COUNTS

    model, y = funnel(rt)
    cfg = SamplerConfig(EHMC_WARMUP, EHMC_DRAWS)
    F.fused_hmc.launches = 0
    COUNTS.reset()
    tr = model.sample(cfg, n_chains=MAIN_CHAINS, seed=0, device=device)
    launches = F.fused_hmc.launches
    n_iters = EHMC_WARMUP + EHMC_DRAWS
    check(COUNTS.iterations == n_iters, COUNTS.iterations)
    ys = tr.evaluate(y)
    mean_y, var_y = float(np.mean(ys)), float(np.var(ys))
    rhat = rank_rhat(tr)
    evals = tr.stats.grad_evals
    secs = tr.timings["warmup_s"] + tr.timings["sample_s"]
    print(f"phase main path, funnel (default config: EHMC): Model.sample "
          f"{MAIN_CHAINS} chains x ({EHMC_WARMUP} warmup + {EHMC_DRAWS} "
          f"draws), {cfg.sampler}: fused_hmc launches {launches}; mean(y) "
          f"{mean_y:.4f}, var(y) {var_y:.4f}, rank-r_hat max {rhat:.5f}, "
          f"divergences {tr.divergences()}, counting lanes a warmup "
          f"iteration {float(COUNTS.counting) / EHMC_WARMUP:.3f}, E[L] in "
          f"sampling {evals[0] / EHMC_DRAWS:.3f} (every chain's gradient "
          f"evaluations equal: {bool(np.all(evals == evals[0]))}), "
          f"{loop_summary(COUNTS, n_iters)}, "
          f"{secs / n_iters * 1e3:.3f} ms an iteration, accept "
          f"{float(np.mean(tr.accept_rate())):.3f}, step size median "
          f"{float(np.median(tr.step_size)):.4g}, timings {tr.timings}",
          flush=True)
    check(np.all(np.isfinite(tr.chains)) and tr.chains.shape == (
        MAIN_CHAINS, EHMC_DRAWS, 10), tr.chains.shape)
    check(abs(mean_y) < 0.3 and abs(var_y / 9.0 - 1.0) < 0.15,
          (mean_y, var_y))
    check(rhat < 1.01, rhat)
    check(np.all(evals == evals[0]), ("grad evals differ", evals.min(),
                                      evals.max()))


def zoo_phases(F, models, device):
    """Each zoo family through Model.sample(kernel="fused!") at 1024
    chains, held to its quadrature: the mean within ZOO_MEAN_SD posterior
    SD, the SD within ZOO_SD_REL, rank-r̂ (Trace.diagnostics on the card)
    under 1.01.  Warmup runs in f64 (the reason is at ZOO_ROWS), the
    kernel in f32.  Returns ({name: trace}, {name: fused_hmc launches})."""
    import torch

    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    cfg = SamplerConfig(ZOO_WARMUP, ZOO_DRAWS, sampler=HMC(ZOO_STEPS))
    traces, counts = {}, {}
    for name, (model, _, stat, data, truth) in models.items():
        t0 = time.perf_counter()
        mean_q, sd_q = quadrature(*zoo_log_posterior(name, data))
        quad_s = time.perf_counter() - t0
        F.fused_hmc.launches = 0
        tr = model.sample(cfg, n_chains=MAIN_CHAINS, seed=0,
                          kernel="fused!", device=device,
                          dtype=torch.float64)
        launches = F.fused_hmc.launches
        rhat = rank_rhat(tr)
        x = tr.evaluate(stat)
        steps = np.round(np.quantile(tr.step_size, [0.01, 0.5, 0.99]), 4)
        dmean = abs(float(x.mean()) - mean_q) / sd_q
        dsd = abs(float(x.std()) / sd_q - 1.0)
        print(f"phase zoo fit, {name}: {ZOO_ROWS} rows synthesized on the "
              f"card (true value {truth:.6g}, data mean "
              f"{float(data.mean()):.6g}); Model.sample(kernel='fused!') "
              f"{MAIN_CHAINS} chains x ({ZOO_WARMUP} warmup + {ZOO_DRAWS} "
              f"draws), HMC({ZOO_STEPS}): fused_hmc launches {launches}, "
              f"posterior mean {float(x.mean()):.7g} SD "
              f"{float(x.std()):.5g} against the quadrature's {mean_q:.7g} "
              f"and {sd_q:.5g} ({quad_s:.2f} s): mean {dmean:.4f} SD apart, "
              f"SD {dsd:.4f} off; rank-r_hat {rhat:.5f}, accept "
              f"{float(np.mean(tr.accept_rate())):.3f}, divergences "
              f"{tr.divergences()}, step size quantiles (0.01, 0.5, 0.99) "
              f"{steps.tolist()}, timings {tr.timings}", flush=True)
        check(launches == 1, (name, "fused_hmc launches", launches))
        check(np.all(np.isfinite(x)), (name, "non-finite draws"))
        check(dmean < ZOO_MEAN_SD and dsd < ZOO_SD_REL and rhat < 1.01,
              (name, dmean, dsd, rhat))
        traces[name], counts[name] = tr, launches
    return traces, counts


def fit_parity(F, cd, em, tr, n_steps, what, device, n_iters):
    """The kernel held to its plain version from a fit's final states, ε
    and Σ̂: lp and g of rt_logp_grad_launch there against the plain
    version and f64 (read, not barred: at 10⁵ rows an f32 sum of
    cancelling terms is off by more than two ulps of what remains), then
    fused_hmc against its plain version over `n_iters` iterations of
    HMC(`n_steps`) (`time_kernel`, the mean accept rates of both
    printed).  With E|Δlp| kernel vs plain read here, an accept flips
    with probability at most 2·E|Δlp| an iteration (`agree_frac`), so the
    chains are compared by `chaotic` after n iterations, the most (up to
    ZOO_AGREE_AT, at least 1) that keep 2·n·E|Δlp| within 1/2, where at
    least `agree_frac(n, E|Δlp|)` must agree within REL_TOL; and an
    iteration's accept probability moves by at most |Δlp| at each of its
    two points, so the mean |Δaccept| of a chain is bound by max(0.02,
    2·E|Δlp|), 0.02 being the other models' bar.  Returns time_kernel's
    numbers."""
    import torch

    q = torch.as_tensor(tr.final_q.T, dtype=torch.float32, device=device)
    cols = cd.column_values(torch.float32, device)
    cols64 = tuple(c.double() if c.is_floating_point() else c for c in cols)
    lp_k, g_k = F.logp_grad(cd, q, columns=cols)
    lp_p, g_p = F.logp_grad_reference(cd, q, cols)
    lp_t, g_t = F._lp_grad_fn(cd, cols64)(q.double())
    check(bool(torch.isfinite(lp_k).all() and torch.isfinite(g_k).all()),
          (what, "non-finite lp or g"))
    # g in units of the posterior's scale: g times the fit's SD of q
    sd = torch.as_tensor(np.sqrt(tr.mass.diag).T, device=device)
    reads = []
    for name, lp, g in (("kernel-vs-plain", lp_k - lp_p, g_k - g_p),
                        ("kernel-vs-f64", lp_k - lp_t, g_k - g_t),
                        ("plain-vs-f64", lp_p - lp_t, g_p - g_t)):
        reads.append(
            f"{name} |dlp| mean {float(lp.abs().mean()):.3g} max "
            f"{float(lp.abs().max()):.3g} (SD over the chains "
            f"{float(lp.double().std()):.3g}), |dg|·sd max "
            f"{float((g.abs() * sd).max()):.3g}")
    dlp_mean = float((lp_k - lp_p).abs().mean())
    agree_at = int(min(ZOO_AGREE_AT, max(1, 0.25 / max(dlp_mean, 1e-12))))
    print(f"phase density at the fit's states, {what}: rt_logp_grad_launch "
          f"at the fit's {q.shape[1]} final states, |lp| up to "
          f"{float(lp_t.abs().max()):.6g}, |g|·sd up to "
          f"{float((g_t.abs() * sd).max()):.3g}; " + "; ".join(reads),
          flush=True)
    return time_kernel(F, cd, em, tr, n_steps, device, em.row_bytes(), what,
                       min_frac=agree_frac(agree_at, dlp_mean),
                       max_dacc=max(0.02, 2.0 * dlp_mean),
                       agree_at=agree_at, n_iters=n_iters)


def zoo_parity(F, cds, ems, fits, counts, device):
    """The kernels at the zoo's shapes, from each ZOO_PARITY family's fit
    (`fit_parity`, ZOO_PARITY_ITERS iterations).  Returns the JSON entries
    of fused_hmc."""
    entries = []
    for name in ZOO_PARITY:
        entry = fit_parity(F, cds[f"zoo {name}"], ems[f"zoo {name}"],
                           fits[name], ZOO_STEPS, f"zoo {name}", device,
                           ZOO_PARITY_ITERS)
        entries.append({"name": f"fused_hmc (zoo {name}, {ZOO_ROWS} rows)",
                        "route": "cuda",
                        "source": "rainier_tpu_torch/csrc/fused_hmc.cu",
                        "replaces": "rainier_tpu/ops/hmc_pallas.py:302",
                        "launches": counts[name], **entry,
                        "library_ms": None})
    return entries


def _within(got, want, se, what):
    """Check |got - want| < PRED_SE·se elementwise; returns the largest
    ratio."""
    z = float(np.max(np.abs(np.asarray(got) - np.asarray(want))
                     / np.asarray(se)))
    check(z < PRED_SE, (what, z))
    return z


def predictive_phases(rt, readme, readme_tr, zoo_fits, models, device):
    """Trace.predict on the README regression (a Vec of 200 Normals) and
    on four zoo families' fits, each every PRED_THIN-th draw, and
    Model.sample_prior on tests/test_distributions.py:179-195's pair."""
    from rainier_tpu_torch.core.trace import Trace

    _, xs, _, (sigma, alpha, betas) = readme
    rows = [tuple(r) for r in xs]
    lh = rt.Vec.from_(rows).map(lambda t: rt.Normal(
        alpha + rt.Vec.of(*t).dot(betas), sigma))
    lin = rt.Vec.from_(rows).map(lambda t: alpha + rt.Vec.of(*t).dot(betas))
    tr = readme_tr.thin(PRED_THIN)
    t0 = time.perf_counter()
    pred = tr.predict(lh, seed=3).astype(np.float64)
    pred_s = time.perf_counter() - t0
    mu = tr.evaluate(lin.element)
    s2 = tr.evaluate(sigma) ** 2
    n = pred.shape[0]
    check(pred.shape == mu.shape == (n, len(rows)), (pred.shape, mu.shape))
    z_mean = _within(pred.mean(0), mu.mean(0),
                     np.sqrt((pred - mu).var(0) / n), "README mean")
    var_want = mu.var(0) + s2.mean()
    z_var = _within(pred.var(0), var_want,
                    pred.var(0) * np.sqrt(2.0 / n), "README variance")
    print(f"phase predict, README regression: trace.thin({PRED_THIN})"
          f".predict of a Vec of {len(rows)} Normals, {n} draws x "
          f"{len(rows)} rows in {pred_s:.3f} s; per row, the predictive mean "
          f"against Trace.evaluate of the linear predictor max {z_mean:.3f} "
          f"SE apart, the predictive variance against Var(mu) + E[sigma^2] "
          f"max {z_var:.3f} SE apart (bound {PRED_SE})", flush=True)

    for name, mean_of in ZOO_MEANS.items():
        tr = zoo_fits[name].thin(PRED_THIN)
        _, dist, stat, _, _ = models[name]
        t0 = time.perf_counter()
        pred = tr.predict(dist, seed=4).astype(np.float64)
        pred_s = time.perf_counter() - t0
        want = mean_of(tr.evaluate(stat))
        z = _within(pred.mean(), want.mean(),
                    np.sqrt((pred - want).var() / pred.size), name)
        print(f"phase predict, {name}: {pred.size} draws in {pred_s:.3f} s,"
              f" predictive mean {pred.mean():.6g} against the mean over "
              f"draws of the family's mean {want.mean():.6g}: {z:.3f} SE "
              f"apart (bound {PRED_SE})", flush=True)

    a = rt.Uniform(0, 1).latent()
    c = rt.Normal(a + 1, a).latent()
    t0 = time.perf_counter()
    da, dc = rt.Model.sample_prior([a, c], n=PRIOR_DRAWS, seed=0,
                                   device=device)
    prior_s = time.perf_counter() - t0
    # the draws are 4 chains' in turn: c's ESS gives the SE of its mean
    ess = Trace(dc.reshape(4, -1, 1), None, None, None).diagnostics(
        device=False)[0].effective_sample_size
    z = abs(float(dc.mean()) - 1.5) / (float(dc.std()) / np.sqrt(ess))
    corr = float(np.corrcoef(da, dc)[0, 1])
    print(f"phase Model.sample_prior: a ~ Uniform(0, 1), c ~ Normal(a + 1, "
          f"a), {da.size} draws in {prior_s:.2f} s: a in (0, 1) "
          f"{bool(np.all((da > 0) & (da < 1)))}, mean(c) "
          f"{float(dc.mean()):.4f} ({z:.3f} SE from 1.5, ESS {ess:.0f}), "
          f"corr(a, c) {corr:.4f}", flush=True)
    check(da.shape == dc.shape == (PRIOR_DRAWS,), (da.shape, dc.shape))
    check(np.all((da > 0) & (da < 1)), "a outside (0, 1)")
    check(z < PRED_SE and corr > 0.1, (z, corr))


def diagnostics_phase(traces):
    """Trace.diagnostics(rank_normalized=True) on the card (device=True)
    against the host's f64 pipeline (device=False): r̂ within DIAG_RHAT,
    ESS within DIAG_ESS_REL relative, and no warning that the two rank
    formulations disagree."""
    import warnings

    for name, tr in traces.items():
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            dev = tr.diagnostics(rank_normalized=True)
        dev_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = tr.diagnostics(rank_normalized=True, device=False)
        host_s = time.perf_counter() - t0
        d_rhat = max(abs(a.r_hat - b.r_hat) for a, b in zip(dev, host))
        d_ess = max(abs(a.effective_sample_size / b.effective_sample_size
                        - 1.0) for a, b in zip(dev, host))
        print(f"phase on-device diagnostics, {name} ({tr.n_chains} chains "
              f"x {tr.n_iterations} draws x {len(dev)} parameters, "
              f"rank-normalized): card {dev_s:.3f} s, host f64 "
              f"{host_s:.3f} s; max |d r_hat| {d_rhat:.3g}, max ESS rel "
              f"{d_ess:.3g}, max r_hat {max(d.r_hat for d in dev):.5f}, "
              f"warnings {[str(w.message) for w in caught]}", flush=True)
        check(d_rhat < DIAG_RHAT and d_ess < DIAG_ESS_REL and not caught,
              (name, d_rhat, d_ess, len(caught)))


def sbc_phase(sbcs, device):
    """SBC.simulate on the card, fits through kernel="fused!": SBC_REPS
    repetitions of each of SBC_FAMILIES at SBC_ROWS rows, held to
    tests/test_sbc.py:27-34's bars."""
    from rainier_tpu_torch.core import rank_uniformity_pvalue
    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    def cfg(n):
        return SamplerConfig(SBC_WARMUP, max(n, 64),
                             sampler=HMC(SBC_STEPS))

    for name, sbc in sbcs.items():
        reps = list(sbc.simulate(SBC_ROWS, cfg, log_bins=SBC_LOG_BINS,
                                 reps=SBC_REPS, seed=0, device=device,
                                 kernel="fused!"))
        p = rank_uniformity_pvalue(reps, 1 << SBC_LOG_BINS)
        max_rhat = max(r.r_hat for r in reps)
        print(f"phase SBC, {name}: {SBC_REPS} repetitions at {SBC_ROWS} "
              f"rows, {1 << SBC_LOG_BINS} bins: ranks "
              f"{[r.rank for r in reps]}, thin {[r.thin for r in reps]}, "
              f"max r_hat {max_rhat:.4f}, rank-uniformity p {p:.4g}, "
              f"seconds a repetition "
              f"{[round(r.seconds, 2) for r in reps]}", flush=True)
        check(max_rhat < SBC_RHAT and p > SBC_PVALUE, (name, max_rhat, p))


def marginal_mixture(rt):
    """tests/test_marginal.py:114-138's mixture at MIX_ROWS rows, data
    from MIX_SEED: z_i ~ Bernoulli(0.4), y_i ~ N(±4, MIX_SCALE²); theta ~
    Beta(1, 1), a ~ N(4, 1), b ~ N(−4, 1); z summed out under one RowSum.
    Returns (model, ys, (theta, a, b), the MarginalizedLatent)."""
    from rainier_tpu_torch.compute import real as R

    rng = np.random.default_rng(MIX_SEED)
    z = rng.random(MIX_ROWS) < 0.4
    ys = np.where(z, rng.normal(4.0, MIX_SCALE, MIX_ROWS),
                  rng.normal(-4.0, MIX_SCALE, MIX_ROWS))
    theta = rt.Beta(1.0, 1.0).latent()
    a, b = rt.Normal(4.0, 1.0).latent(), rt.Normal(-4.0, 1.0).latent()
    col = R.Column(ys)
    m = rt.marginalize(rt.Bernoulli(theta), lambda k: rt.Normal(
        a if k == 1 else b, MIX_SCALE).log_density_at(col))
    return (rt.Model.likelihood(R.RowSum(m.log_density, MIX_ROWS)), ys,
            (theta, a, b), m)


def mixture_laplace(ys):
    """MAP, inverse negative Hessian and the responsibilities at the MAP
    of the mixture's posterior, by Newton's method in numpy f64 in the
    constrained coordinates (theta, a, b), where the Beta(1, 1) prior is
    flat: the gradient in closed form, the Hessian by central
    differences of it."""
    s2 = MIX_SCALE ** 2

    def grad(w):
        th, a, b = w
        l1 = np.log(th) - 0.5 * (ys - a) ** 2 / s2
        l0 = np.log1p(-th) - 0.5 * (ys - b) ** 2 / s2
        r = np.exp(l1 - np.logaddexp(l1, l0))
        return np.array([np.sum(r / th - (1 - r) / (1 - th)),
                         np.sum(r * (ys - a)) / s2 - (a - 4.0),
                         np.sum((1 - r) * (ys - b)) / s2 - (b + 4.0)]), r

    def hess(w):
        h = np.empty((3, 3))
        for j in range(3):
            e = np.zeros(3)
            e[j] = 1e-6 * max(1.0, abs(w[j]))
            h[:, j] = (grad(w + e)[0] - grad(w - e)[0]) / (2 * e[j])
        return 0.5 * (h + h.T)

    w = np.array([0.4, 4.0, -4.0])
    for _ in range(100):
        step = np.linalg.solve(hess(w), grad(w)[0])
        w = w - step
        if np.max(np.abs(step)) < 1e-12:
            break
    return w, np.linalg.inv(-hess(w)), grad(w)[1]


def mixture_phases(F, model, cd, em, ys, exprs, marg, device):
    """The marginalized mixture through Model.sample(kernel="fused!")
    against `mixture_laplace`: means within 0.1 Laplace SD of the MAP, SDs
    within 10% of the Laplace SDs, rank-r̂ < 1.01 (the logistic's bars);
    `posterior_prob(1)` by Trace.evaluate at the last draw of
    MIX_RESP_DRAWS chains, averaged over them, within MIX_RESP_TOL of the
    MAP's responsibilities on average over the rows; then the kernel
    against its plain version from the fit (`fit_parity`).  Warmup in
    f32, the default.  Returns its JSON entry."""
    from rainier_tpu_torch.core.trace import Trace
    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    t0 = time.perf_counter()
    w_map, cov, resp_map = mixture_laplace(ys)
    sd_ref = np.sqrt(np.diag(cov))
    print(f"phase Laplace reference, marginalized mixture: Newton in f64 in "
          f"(theta, a, b), MAP {w_map.tolist()}, Laplace SDs "
          f"{sd_ref.tolist()} ({time.perf_counter() - t0:.2f} s)",
          flush=True)
    cfg = SamplerConfig(MIX_WARMUP, MIX_DRAWS, sampler=HMC(MIX_STEPS))
    F.fused_hmc.launches = 0
    tr = model.sample(cfg, n_chains=MAIN_CHAINS, seed=0, kernel="fused!",
                      device=device)
    launches = F.fused_hmc.launches
    draws = np.stack([tr.evaluate(e) for e in exprs], axis=-1)
    dmean = np.abs(draws.mean(0) - w_map) / sd_ref
    dsd = np.abs(draws.std(0) / sd_ref - 1.0)
    rhat = rank_rhat(tr)
    last = Trace(tr._chains_src[:MIX_RESP_DRAWS, -1:], model, cd, cfg)
    resp = last.evaluate(marg.posterior_prob(1))
    dresp = float(np.mean(np.abs(resp.mean(0) - resp_map)))
    print(f"phase main path, marginalized mixture: Model.sample(kernel="
          f"'fused!') {MAIN_CHAINS} chains x ({MIX_WARMUP} warmup + "
          f"{MIX_DRAWS} draws), HMC({MIX_STEPS}), {MIX_ROWS} rows: fused_hmc "
          f"launches {launches}, rank-r_hat max {rhat:.5f}, (theta, a, b) "
          f"means {draws.mean(0).tolist()} SDs {draws.std(0).tolist()}: "
          f"means max {float(dmean.max()):.4f} Laplace SD from the MAP, SDs "
          f"max {float(dsd.max()):.4f} off; responsibilities at "
          f"{resp.shape[0]} draws x {resp.shape[1]} rows, mean |E p(z=1) - "
          f"the MAP's| {dresp:.3g}; accept "
          f"{float(np.mean(tr.accept_rate())):.3f}, divergences "
          f"{tr.divergences()}, step size median "
          f"{float(np.median(tr.step_size)):.4g}, timings {tr.timings}",
          flush=True)
    check(launches >= 1, f"fused_hmc launches {launches}")
    check(np.all(np.isfinite(draws)), "non-finite draws")
    check(rhat < 1.01 and float(dmean.max()) < 0.1
          and float(dsd.max()) < 0.1, (rhat, dmean, dsd))
    check(resp.shape == (MIX_RESP_DRAWS, MIX_ROWS) and dresp < MIX_RESP_TOL,
          (resp.shape, dresp))
    entry = fit_parity(F, cd, em, tr, MIX_STEPS, "marginalized mixture",
                       device, MIX_PARITY_ITERS)
    return {"name": f"fused_hmc (marginalized mixture, {MIX_ROWS} rows)",
            "route": "cuda", "source": "rainier_tpu_torch/csrc/fused_hmc.cu",
            "replaces": "rainier_tpu/ops/hmc_pallas.py:302",
            "launches": launches, **entry, "library_ms": None}


def optimize_phase(lmodel, w_map, cov, device):
    """Model.optimize on the 100k logistic at the default dtype, with one
    start and with OPT_STARTS: every coordinate within OPT_SD Laplace SD
    of the Laplace MAP; prints what ended each start's run."""
    from rainier_tpu_torch.optimizer import lbfgs

    sd = np.sqrt(np.diag(cov))
    for n_starts in (1, OPT_STARTS):
        lbfgs.COUNTS.reset()
        t0 = time.perf_counter()
        x = lmodel.optimize(max_iters=OPT_ITERS, n_starts=n_starts,
                            device=device)
        secs = time.perf_counter() - t0
        st = lbfgs.COUNTS.last
        d = np.abs(x.double().cpu().numpy() - w_map) / sd
        k = st.k.cpu().numpy()
        print(f"phase Model.optimize, logistic regression: {n_starts} "
              f"start(s), max_iters {OPT_ITERS}, {x.dtype}: {secs:.2f} s, "
              f"iterations {k.tolist()}, converged "
              f"{st.converged.cpu().numpy().tolist()}, failed "
              f"{st.failed.cpu().numpy().tolist()}, -lp "
              f"{st.f.cpu().numpy().tolist()}, {lbfgs.COUNTS.evaluations} "
              f"batched density calls, {lbfgs.COUNTS.syncs} host syncs "
              f"({lbfgs.COUNTS.syncs / max(int(k.max()), 1):.2f} an "
              f"iteration), {lbfgs.COUNTS.fallbacks} zoom fallbacks; the "
              f"optimum max {float(d.max()):.4f} Laplace SD from the MAP",
              flush=True)
        check(np.all(np.isfinite(d)) and float(d.max()) < OPT_SD,
              (n_starts, d))


def advi_phase(rt, readme, readme_tr, device, seeds=(0,), bars=True):
    """ADVI on the README regression, mean-field and full-rank (learning
    rate ADVI_LR, ADVI_STEPS steps of ADVI_SAMPLES draws), against the
    README main path's kernel posterior `readme_tr`: the ELBO rises, the
    means of alpha and the betas within ADVI_MEAN_SD posterior SD, the
    full-rank SDs within ADVI_FR_SD_REL, the mean-field SDs at most
    ADVI_MF_SD_OVER above the posterior's.  Each seed of `seeds` is
    printed; `bars` holds them."""
    model, _, _, (_, alpha, betas) = readme
    post = np.hstack([readme_tr.evaluate(alpha)[:, None],
                      readme_tr.evaluate(betas.element)])
    p_mean, p_sd = post.mean(0), post.std(0)
    for seed in seeds:
        for full_rank in (False, True):
            t0 = time.perf_counter()
            vp = rt.advi(model, n_steps=ADVI_STEPS, n_samples=ADVI_SAMPLES,
                         learning_rate=ADVI_LR, full_rank=full_rank,
                         seed=seed, device=device)
            secs = time.perf_counter() - t0
            q = np.hstack([vp.evaluate(alpha, ADVI_DRAWS, seed)[:, None],
                           vp.evaluate(betas.element, ADVI_DRAWS, seed)])
            dmean = np.abs(q.mean(0) - p_mean) / p_sd
            rel = q.std(0) / p_sd - 1.0
            kind = "full-rank" if full_rank else "mean-field"
            print(f"phase ADVI, README regression, {kind}, seed {seed}: "
                  f"{ADVI_STEPS} steps x {ADVI_SAMPLES} draws, lr {ADVI_LR}, "
                  f"{secs:.2f} s ({secs / ADVI_STEPS * 1e3:.3f} ms a step); "
                  f"ELBO {vp.elbo_trace[0]:.3f} -> {vp.elbo_trace[-1]:.3f}; "
                  f"(alpha, betas) means max {float(dmean.max()):.4f} "
                  f"posterior SD from the kernel's, SDs / the kernel's - 1 "
                  f"{np.round(rel, 4).tolist()}", flush=True)
            if bars:
                sd_ok = (np.all(np.abs(rel) < ADVI_FR_SD_REL) if full_rank
                         else np.all(rel < ADVI_MF_SD_OVER))
                check(vp.elbo_trace[-1] > vp.elbo_trace[0]
                      and float(dmean.max()) < ADVI_MEAN_SD and sd_ok,
                      (kind, vp.elbo_trace[[0, -1]], dmean, rel))


def funnel_vip(rt):
    """tests/test_reparam.py:101-113's build(lam)."""
    def build(lam):
        log_tau = rt.Normal(0.0, 3.0).latent()
        thetas = rt.vip_latent_vec(0.0, log_tau.exp(), 4, lam=lam)
        return rt.Model.track_([log_tau] + [thetas[i] for i in range(4)])
    return build


def auto_vip_phase(rt, device):
    """auto_vip on the funnel: picks lam 0.0, every ELBO finite."""
    t0 = time.perf_counter()
    res = rt.auto_vip(funnel_vip(rt), candidates=VIP_CANDIDATES,
                      n_steps=VIP_STEPS, seed=0, device=device)
    print(f"phase auto_vip, funnel: candidates {VIP_CANDIDATES}, "
          f"{VIP_STEPS} steps each: {res} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    check(res.lam == 0.0 and bool(np.all(np.isfinite(res.elbos))), res)


def smc_phase(rt, quad, device):
    """Model.smc on eight schools under SMCConfig() against the quadrature:
    means of mu and tau within SMC_MEAN_SD posterior SD, their SDs within
    SMC_SD_REL, log_evidence within SMC_LOGZ nats of its log Z."""
    from rainier_tpu_torch.sampler import SMCConfig

    model, mu, tau, _ = eight_schools(rt)
    cfg = SMCConfig()
    t0 = time.perf_counter()
    tr, res = model.smc(cfg, seed=0, device=device)
    secs = time.perf_counter() - t0
    n = int(res.n_stages)
    got = {"mu": tr.evaluate(mu), "tau": tr.evaluate(tau)}
    log_z = float(res.log_evidence)
    print(f"phase Model.smc, eight schools: {cfg.n_particles} particles, "
          f"{n} stages in {secs:.2f} s ({secs / max(n, 1):.3f} s a stage), "
          f"betas {np.round(res.betas[:n].cpu().numpy(), 5).tolist()}, "
          f"mutation accept {np.round(res.accept_rates[:n].cpu().numpy(), 3).tolist()}; "
          f"(mean, SD) " + ", ".join(
              f"{k} ({np.mean(v):.4f}, {np.std(v):.4f}) against "
              f"({quad[k][0]:.4f}, {quad[k][1]:.4f})"
              for k, v in got.items())
          + f"; log evidence {log_z:.4f} against the quadrature's "
          f"{quad['log_z']:.4f}", flush=True)
    check(np.all(np.isfinite(tr.flat())), "non-finite particles")
    for k, v in got.items():
        m, sd = quad[k]
        check(abs(np.mean(v) - m) < SMC_MEAN_SD * sd
              and abs(np.std(v) / sd - 1.0) < SMC_SD_REL,
              (k, float(np.mean(v)), float(np.std(v)), m, sd))
    check(abs(log_z - quad["log_z"]) < SMC_LOGZ, (log_z, quad["log_z"]))


def chunked_phase(F, readme, device):
    """The README regression on the scan path in segments of CHUNK_ITERS
    with a ConsoleProgress against the same run unchunked: the same draw
    count, means within CHUNK_MEAN_SE Monte-Carlo SE (the chains' ESS),
    progress lines with accept, E-BFMI and the window, compile_s on
    both; then through fused! with a ConsoleProgress (its three lines),
    and chunk_iters with fused! refused."""
    import io

    from rainier_tpu_torch.core.trace import Trace
    from rainier_tpu_torch.sampler import ConsoleProgress, HMC, SamplerConfig

    model, _, _, _ = readme
    cfg = SamplerConfig(CHUNK_WARMUP, CHUNK_DRAWS, sampler=HMC(N_STEPS))
    buf = io.StringIO()
    prog = ConsoleProgress(buf)
    prog.output_every_seconds = 0.0
    tr = model.sample(cfg, n_chains=CHUNK_CHAINS, seed=0, device=device,
                      chunk_iters=CHUNK_ITERS, progress=prog)
    ref = model.sample(cfg, n_chains=CHUNK_CHAINS, seed=0, device=device)
    out = buf.getvalue()
    a, b = tr.chains.astype(np.float64), ref.chains.astype(np.float64)
    ess = np.array([d.effective_sample_size for d in Trace(
        b, None, None, None).diagnostics(device=False)])
    z = np.abs(a.mean((0, 1)) - b.mean((0, 1))) / (
        b.std((0, 1)) / np.sqrt(ess))
    print(f"phase chunked sampling, README regression: scan path "
          f"{CHUNK_CHAINS} chains x ({CHUNK_WARMUP} + {CHUNK_DRAWS}), "
          f"chunk_iters {CHUNK_ITERS}: draws {a.shape} against unchunked "
          f"{b.shape}, means max {float(z.max()):.4f} MC SE apart (equal bit "
          f"for bit: {bool(np.array_equal(a, b))}), timings {tr.timings} "
          f"against {ref.timings}; {len(out.splitlines())} progress lines, "
          f"the last {out.splitlines()[-1]!r}", flush=True)
    check(a.shape == b.shape == (CHUNK_CHAINS, CHUNK_DRAWS, a.shape[-1]),
          (a.shape, b.shape))
    check(float(z.max()) < CHUNK_MEAN_SE, z)
    check(all(w in out for w in ("accept", "E-BFMI", "[window:")), out)
    check("compile_s" in tr.timings and "compile_s" in ref.timings,
          (tr.timings, ref.timings))
    buf = io.StringIO()
    F.fused_hmc.launches = 0
    tr = model.sample(cfg, n_chains=MAIN_CHAINS, seed=1, device=device,
                      kernel="fused!", progress=ConsoleProgress(buf))
    lines = buf.getvalue().splitlines()
    print(f"phase progress, README regression through fused!: "
          f"{MAIN_CHAINS} chains, fused_hmc launches "
          f"{F.fused_hmc.launches}, lines {lines}, timings {tr.timings}",
          flush=True)
    check(len(lines) == 3 and lines[1].startswith("warmup complete")
          and lines[2].startswith("complete") and "compile_s" in tr.timings,
          lines)
    try:
        model.sample(cfg, n_chains=MAIN_CHAINS, device=device,
                     kernel="fused!", chunk_iters=CHUNK_ITERS)
        refused = ""
    except ValueError as e:
        refused = str(e)
    print(f"phase chunk_iters with fused!: {refused!r}", flush=True)
    check("chunk_iters needs the scan path" in refused, refused)


def inference_sections(F, rt, readme, readme_tr, lmodel, w_map, cov,
                       device):
    """The rest of inference that times no launch, each section timed (the
    mixture's section times its kernel and runs apart; Model.smc runs in
    the samplers' process, `samplers_alone`)."""
    t0 = time.perf_counter()
    with phase("Model.optimize", device):
        optimize_phase(lmodel, w_map, cov, device)
    with phase("ADVI", device):
        advi_phase(rt, readme, readme_tr, device)
    with phase("auto_vip", device):
        auto_vip_phase(rt, device)
    with phase("progress and chunked sampling", device):
        chunked_phase(F, readme, device)
    print(f"phase time, the inference sections: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def gp_data(inputs=GP_INPUTS):
    """The latent GP's inputs, K and y (GP_* constants) at `inputs`
    inputs."""
    x = np.linspace(0.0, 10.0, inputs)
    K = np.exp(-0.5 * ((x[:, None] - x[None, :]) / GP_LENGTH) ** 2)
    K += GP_JITTER * np.eye(inputs)
    y = np.sin(x) + GP_SIGMA * np.random.default_rng(GP_SEED).normal(
        size=inputs)
    return x, K, y


def latent_gp(rt, inputs=GP_INPUTS):
    """Latent GP regression: f = MVNormal(0, K).latent_vec(), y_i ~
    Normal(f_i, GP_SIGMA); no rows, `inputs` parameters (z, f = L·z).
    Returns (model, f)."""
    _, K, y = gp_data(inputs)
    f = rt.MVNormal([0.0] * inputs, K).latent_vec()
    return rt.Model.observe(list(y), f.map(
        lambda fi: rt.Normal(fi, GP_SIGMA))), f


def mat_layout(em):
    """Where a workspace model's product passes read L."""
    return (f"L staged in shared memory ({em.staged} floats)" if em.staged
            else "L from a transposed copy in device memory"
            if em.transposed else "L from its device pointer")


def gp_phases(F, gp, cd, em, device):
    """The latent GP through Model.sample(kernel="fused!") against its
    exact posterior (numpy f64): every f_i's mean within GP_MEAN_SD
    posterior SD and SD within GP_SD_REL (f by Trace.evaluate), rank-r̂ <
    1.01; then the density alone (`states_density`), where the time a
    call of its product passes shows, and the kernel against its plain
    version at the main path's shapes over GP_PARITY_ITERS iterations
    (the column-free bar).  Returns its JSON entries."""
    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    model, f = gp
    _, K, y = gp_data()
    a = K + GP_SIGMA ** 2 * np.eye(GP_INPUTS)
    mean = K @ np.linalg.solve(a, y)
    sd = np.sqrt(np.diag(K - K @ np.linalg.solve(a, K)))
    cfg = SamplerConfig(GP_WARMUP, GP_DRAWS, sampler=HMC(GP_STEPS))
    F.fused_hmc.launches = 0
    tr = model.sample(cfg, n_chains=MAIN_CHAINS, seed=0, kernel="fused!",
                      device=device)
    launches = F.fused_hmc.launches
    fs = np.stack(tr.thin(GP_THIN).evaluate(f.to_list()), axis=1)
    dmean = np.abs(fs.mean(0) - mean) / sd
    dsd = np.abs(fs.std(0) / sd - 1.0)
    rhat = rank_rhat(tr)
    print(f"phase main path, latent GP: Model.sample(kernel='fused!') "
          f"{MAIN_CHAINS} chains x ({GP_WARMUP} warmup + {GP_DRAWS} draws), "
          f"HMC({GP_STEPS}), {GP_INPUTS} inputs, {cd.n_vars} parameters "
          f"({layout(F, em, MAIN_CHAINS)}, {mat_layout(em)}): fused_hmc "
          f"launches {launches}, "
          f"rank-r_hat max {rhat:.5f}, f means max {float(dmean.max()):.4f} "
          f"posterior SD from the exact mean, SDs max {float(dsd.max()):.4f} "
          f"off the exact SDs (exact SDs {float(sd.min()):.4f}-"
          f"{float(sd.max()):.4f}), accept "
          f"{float(np.mean(tr.accept_rate())):.3f}, divergences "
          f"{tr.divergences()}, step size median "
          f"{float(np.median(tr.step_size)):.4g}, timings {tr.timings}",
          flush=True)
    check(launches >= 1, f"fused_hmc launches {launches}")
    check(np.all(np.isfinite(fs)), "non-finite draws")
    check(rhat < 1.01 and float(dmean.max()) < GP_MEAN_SD
          and float(dsd.max()) < GP_SD_REL, (rhat, dmean.max(), dsd.max()))
    # the density alone, so that a product pass's time a call shows
    _, dentry = states_density(F, cd, em, tr, device,
                               "rainier_tpu/ops/hmc_pallas.py:293")
    entry = time_kernel(F, cd, em, tr, GP_STEPS, device, 0, "latent GP",
                        n_iters=GP_PARITY_ITERS, whole=whole_bytes(cd))
    return [{"name": f"fused_hmc (latent GP, {GP_INPUTS} inputs: L·z past "
                     "16 in the scratch)", "route": "cuda",
             "source": "rainier_tpu_torch/csrc/fused_hmc.cu",
             "replaces": "rainier_tpu/ops/hmc_pallas.py:293",
             "launches": launches, **entry, "library_ms": None},
            {**dentry, "name": f"rt_logp_grad_launch (latent GP, "
                               f"{GP_INPUTS} inputs: the product passes)",
             "launches": 0}]


def gp_wide_phases(F, gp, cd, em, device):
    """The latent GP at GP_WIDE_INPUTS inputs, its L read from a
    transposed copy: a short main path through
    Model.sample(kernel="fused!"), every state finite; then the density
    alone (`states_density`) and the kernel against its plain version at
    the main path's shapes over GP_WIDE_PARITY_ITERS iterations (the
    column-free bar).  Returns its JSON entries."""
    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    check(bool(em.transposed), f"{mat_layout(em)}, not a transposed copy")
    cfg = SamplerConfig(GP_WIDE_WARMUP, GP_WIDE_DRAWS, sampler=HMC(GP_STEPS))
    F.fused_hmc.launches = 0
    tr = gp[0].sample(cfg, n_chains=MAIN_CHAINS, seed=0, kernel="fused!",
                      device=device)
    launches = F.fused_hmc.launches
    print(f"phase main path, latent GP {GP_WIDE_INPUTS}: "
          f"Model.sample(kernel='fused!') {MAIN_CHAINS} chains x "
          f"({GP_WIDE_WARMUP} warmup + {GP_WIDE_DRAWS} draws), "
          f"HMC({GP_STEPS}), {GP_WIDE_INPUTS} inputs, {cd.n_vars} parameters "
          f"({layout(F, em, MAIN_CHAINS)}, {mat_layout(em)}): fused_hmc "
          f"launches {launches}, accept "
          f"{float(np.mean(tr.accept_rate())):.3f}, divergences "
          f"{tr.divergences()}, step size median "
          f"{float(np.median(tr.step_size)):.4g}, timings {tr.timings}",
          flush=True)
    check(launches >= 1, f"fused_hmc launches {launches}")
    check(bool(np.all(np.isfinite(tr.final_q))), "non-finite states")
    _, dentry = states_density(F, cd, em, tr, device,
                               "rainier_tpu/ops/hmc_pallas.py:293")
    entry = time_kernel(F, cd, em, tr, GP_STEPS, device, 0,
                        f"latent GP {GP_WIDE_INPUTS}",
                        n_iters=GP_WIDE_PARITY_ITERS, whole=whole_bytes(cd))
    what = f"latent GP, {GP_WIDE_INPUTS} inputs: L·z past 16 in the " \
        "scratch, L from a transposed copy"
    return [{"name": f"fused_hmc ({what})", "route": "cuda",
             "source": "rainier_tpu_torch/csrc/fused_hmc.cu",
             "replaces": "rainier_tpu/ops/hmc_pallas.py:293",
             "launches": launches, **entry, "library_ms": None},
            {**dentry, "name": f"rt_logp_grad_launch ({what})",
             "launches": 0}]


def form_models(rt):
    """The three row forms at FORM_ROWS rows, each from the smallest
    construct that builds it, the data from FORM_SEED: {name: (model,
    the coordinates its main path keeps)}."""
    from rainier_tpu_torch.compute import real as R

    rng = np.random.default_rng(FORM_SEED)
    n = FORM_ROWS
    # an IntColumn read whole: every row's mean is a plus the mean of
    # b[idx] over all rows (a nested RowSum of a gather by it)
    b = rt.Normal(0, 1).latent_vec(FORM_GROUPS)
    a = rt.Normal(0, 1).latent()
    idx = R.IntColumn(rng.integers(0, FORM_GROUPS, n))
    whole = rt.Model.observe(list(rng.normal(0.5, 1.0, n)), rt.Normal(
        a + R.RowSum(R.Gather(b.element, idx), n) / float(n), 1.0))
    # a vector per row: b_i times w_i at row i, b of the rows' length
    v = rt.Normal(0, 1).latent_vec(n)
    per_row = rt.Model.likelihood(R.RowSum(
        v.element * R.Column(rng.uniform(0.5, 1.5, n)), n))
    # a Gather whose source varies by row: each row reads y·a at the
    # row of a permutation
    ys = rng.normal(0.5, 1.0, n)
    c = rt.Normal(0, 1).latent()
    y = R.Column(ys)
    ya = y * c
    across = rt.Model.likelihood(R.RowSum(rt.Normal(
        R.Gather(ya, R.IntColumn(rng.permutation(n))) + ya, 1.0)
        .log_density_at(y), n))
    keep = np.arange(FORM_COLLECT)
    return {"index column read whole": (whole, None),
            "vector per row": (per_row, keep),
            "row-varying gather": (across, None)}


def form_phase(F, name, model, collect, cd, em, device):
    """One row form: its main path (FORM_WARMUP + FORM_DRAWS, `collect`
    coordinates kept), the density at full width at its last states and
    at inits against the plain version and the plain version in f64
    (`density_check`), then the kernel against its plain version over
    FORM_PARITY_ITERS iterations from the main path's states, ε and Σ̂
    (`time_kernel`, the bar of the models with data).  Returns its JSON
    entries."""
    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    cfg = SamplerConfig(FORM_WARMUP, FORM_DRAWS, sampler=HMC(FORM_STEPS))
    F.fused_hmc.launches = 0
    tr = model.sample(cfg, n_chains=MAIN_CHAINS, seed=0, kernel="fused!",
                      device=device, collect_idx=collect)
    launches = F.fused_hmc.launches
    print(f"phase main path, form {name}: Model.sample(kernel='fused!') "
          f"{MAIN_CHAINS} chains x ({FORM_WARMUP} warmup + {FORM_DRAWS} "
          f"draws), HMC({FORM_STEPS}), {em.n_rows} rows, {cd.n_vars} "
          f"parameters, {em.n_inv} row-invariant values "
          f"({layout(F, em, MAIN_CHAINS)}): fused_hmc launches {launches}, "
          f"accept {float(np.mean(tr.accept_rate())):.3f}, divergences "
          f"{tr.divergences()}, timings {tr.timings}", flush=True)
    check(launches >= 1, f"fused_hmc launches {launches}")
    check(bool(np.all(np.isfinite(tr.final_q))), "non-finite states")
    dlp_mean, dentry = states_density(F, cd, em, tr, device,
                                      "rainier_tpu/ops/hmc_pallas.py:302")
    entry = time_kernel(F, cd, em, tr, FORM_STEPS, device, em.row_bytes(),
                        f"form {name}", tol=1e-3, max_dacc=0.02,
                        min_frac=agree_frac(FORM_PARITY_ITERS, dlp_mean),
                        n_iters=FORM_PARITY_ITERS, collect_idx=collect,
                        whole=whole_bytes(cd))
    if name in FORM_SAME_BITS:
        same_bits(F, cd, tr, collect, device, f"form {name}")
    return [{"name": f"fused_hmc (form: {name}, {FORM_ROWS} rows)",
             "route": "cuda", "source": "rainier_tpu_torch/csrc/fused_hmc.cu",
             "replaces": "rainier_tpu/ops/hmc_pallas.py:302",
             "launches": launches, **entry, "library_ms": None},
            {**dentry, "name": f"rt_logp_grad_launch (form: {name})",
             "launches": 0}]


def states_density(F, cd, em, tr, device, replaces):
    """`density_check` at FORM_CHECK_NEAR of the main path's last states
    and FORM_CHECK_INIT inits, against the plain version and the plain
    version in f64, the kernel's bound widened by the plain version's own
    distance from f64.  Returns what `density_check` returns."""
    import torch

    from rainier_tpu_torch.sampler import SamplerConfig

    rng = np.random.default_rng(3)
    q = torch.as_tensor(np.hstack([
        tr.final_q[:FORM_CHECK_NEAR].T, SamplerConfig().init_scale
        * rng.normal(size=(cd.n_vars, FORM_CHECK_INIT))]),
        dtype=torch.float32, device=device)
    cols = cd.column_values(torch.float32, device)
    cols64 = tuple(c.double() if c.is_floating_point() else c for c in cols)
    lp_grad64 = F._lp_grad_fn(cd, cols64)
    truth = lp_grad64(q.double())
    # a model of few parameters may sum many rows into each gradient
    # entry, near the mode a difference of large sums (the index column
    # read whole: Σ (y − mean) over 100,000 rows): its bounds widen to
    # its f32 conditioning as the GLMMs' do
    cond = conditioning(lp_grad64, q) if cd.n_vars <= FORM_COND_MAX \
        else None
    return density_check(F, cd, em, q, truth, FORM_CHECK_NEAR,
                         "at the main path's states", device, replaces,
                         cond, plain_off=True)


def same_bits(F, cd, tr, collect, device, what):
    """Two launches of the kernel from the main path's last states, ε and
    Σ̂ with the same explicit noise (FORM_PARITY_ITERS iterations of
    HMC(FORM_STEPS), every draw collected): every output the same bits,
    since no sum of the kernel depends on the order in which lanes or
    blocks run."""
    import torch

    q0, kw = parity_inputs(
        cd, device, tr.final_q.shape[0], FORM_PARITY_ITERS, True,
        start=(tr.final_q.T, tr.step_size, tr.mass.diag), n_steps=FORM_STEPS,
        collect_idx=collect)
    a = [x.clone() for x in F.fused_hmc(cd, q0, **kw)]
    b = F.fused_hmc(cd, q0, **kw)
    same = [bool(torch.equal(x, y)) for x, y in zip(a, b)]
    print(f"phase same bits, {what}: two launches from the same states and "
          f"noise ({q0.shape[1]} chains x {FORM_PARITY_ITERS} it x "
          f"{FORM_STEPS} steps): final q, draws, accept, divergences "
          f"equal {same}", flush=True)
    check(all(same), (what, same))


def inspection_phase(rt, model, device):
    """rt.inspection on the card: the PTX of `model`'s kernel, and a
    profile of a short fused run of it (INSPECT_WARMUP + INSPECT_DRAWS of
    HMC(INSPECT_STEPS) at INSPECT_CHAINS chains, run twice: once to warm,
    once captured) written under profiles/ in the checkout."""
    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    t0 = time.perf_counter()
    ptx = rt.inspection.ptx(model)
    print(f"phase inspection: rt.inspection.ptx of the latent GP's kernel, "
          f"{len(ptx)} characters, {ptx.count('.entry')} entries "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    check(".entry" in ptx, "no kernel entry in the PTX")
    t0 = time.perf_counter()
    cfg = SamplerConfig(INSPECT_WARMUP, INSPECT_DRAWS,
                        sampler=HMC(INSPECT_STEPS))
    out = rt.inspection.trace(model, cfg, "profiles/gp_trace",
                              n_chains=INSPECT_CHAINS, kernel="fused!",
                              device=device)
    files = [f for f in os.listdir(out) if f.endswith(".json")]
    print(f"phase inspection: rt.inspection.trace of a fused run of the "
          f"latent GP at {INSPECT_CHAINS} chains x ({INSPECT_WARMUP} + "
          f"{INSPECT_DRAWS}) of HMC({INSPECT_STEPS}) written to {out}: "
          f"{files} ({time.perf_counter() - t0:.2f} s)", flush=True)
    check(bool(files), "no trace written")


def forms_sections(F, rt, cds, ems, gp, gpw, mv32, x32, ys32, forms,
                   device):
    """The slice of the forms: the latent GP at 64 and at GP_WIDE_INPUTS
    inputs, the 32-feature MVNormal logistic, each row form, then the
    GP's kernel's PTX and a profile of a short fused run
    (`rt.inspection`).  Returns the JSON entries."""
    t0 = time.perf_counter()
    with phase("latent GP", device):
        kernels = gp_phases(F, gp, cds["latent GP"], ems["latent GP"],
                            device)
    wide = f"latent GP {GP_WIDE_INPUTS}"
    with phase(wide, device):
        kernels += gp_wide_phases(F, gpw, cds[wide], ems[wide], device)
    what = f"MVNormal logistic {MV32_FEATURES}"
    with phase(what, device):
        kernels += mvnormal_phases(F, mv32, cds[what], ems[what], x32, ys32,
                                   device, what, MV32_WARMUP, MV32_DRAWS)
    for name, (model, collect) in forms.items():
        with phase(f"form {name}", device):
            kernels += form_phase(F, name, model, collect,
                                  cds[f"form {name}"], ems[f"form {name}"],
                                  device)
    with phase("inspection", device):
        inspection_phase(rt, gp[0], device)
    print(f"phase time, the forms sections: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return kernels


def parallel_section(rt, lmodel, x, ys, w_map, cov, device):
    """The 100k logistic through ``rt.parallel`` on the scan path: a world
    of one over NCCL (``make_mesh()``), whose run gives the bits of the
    run without a mesh, whose pooled run passes `moment_z` against the
    pooled run without a mesh, and
    whose trace round-trips a checkpoint of CUDA tensors and resumes by
    ``resume_config``; and two ranks over gloo on the one card, spawned
    here (`parallel_rank`), whose (1, 2) data-sharded density at the
    density check's points is within its bars of the world of one's, and
    whose (1, 2) and (2, 1) runs pass `moment_z` against it, each rank
    holding the same bits.  Both densities are plain f32 sums of 100,000
    rows in another order, so the bars widen, per point and entry, by the
    world of one's own distance from f64 (`logistic_truth`), as the row
    forms' bars against their plain version do (PERF.md §2)."""
    import dataclasses
    import socket
    import tempfile

    import torch
    import torch.distributed as dist

    from rainier_tpu_torch.parallel import (load_checkpoint, make_mesh,
                                            resume_config, save_checkpoint)
    from rainier_tpu_torch.sampler import HMC, SamplerConfig
    from rainier_tpu_torch.sampler.mass import MassState

    torch.cuda.empty_cache()
    cd = lmodel.density()
    q = check_points(w_map, cov, device)
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "points.npy"), q.cpu().numpy())
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        # the ranks start first: they take seconds to reach the card
        t_ranks = time.perf_counter()
        ranks = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "parallel-rank",
             str(port), str(r), tmp], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in (0, 1)]
        try:
            mesh = make_mesh()
            one = torch.ones(1, device=device)
            dist.all_reduce(one)
            print(f"phase world of one: backend {dist.get_backend()}, "
                  f"{dist.get_world_size()} rank, mesh "
                  f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}", flush=True)
            check(dist.get_backend() == "nccl" and float(one) == 1.0,
                  "NCCL world of one")
            cfg = SamplerConfig(PAR_WARMUP, PAR_DRAWS, sampler=HMC(PAR_STEPS))
            pooled = dataclasses.replace(cfg, pooled_adaptation=True)
            runs = {(c.pooled_adaptation, m is not None): lmodel.sample(
                c, n_chains=MAIN_CHAINS, seed=0, device=device, mesh=m)
                for c in (cfg, pooled) for m in (None, mesh)}

            def same_bits(a, b):
                return (np.array_equal(a.chains, b.chains)
                        and np.array_equal(a.step_size, b.step_size)
                        and np.array_equal(a.mass.diag, b.mass.diag))

            u, m = runs[False, False], runs[False, True]
            same = same_bits(u, m)
            z = moment_z(runs[True, True].chains, runs[True, False].chains,
                         device)
            # not a bar: pooling changes the adaptation, so at this depth
            # the pooled and per-chain runs draw from two laws
            z_laws = moment_z(runs[True, True].chains, u.chains, device)
            print(f"phase main path through a mesh of one, logistic "
                  f"regression: {MAIN_CHAINS} chains x ({PAR_WARMUP} "
                  f"warmup + {PAR_DRAWS} draws), HMC({PAR_STEPS}), scan "
                  f"path: the same bits as no mesh {same} (timings "
                  f"{m.timings}, no mesh {u.timings}); pooled: max z "
                  f"{z[0]:.3f} ({z[1]} of parameter {z[2]}) against the "
                  f"pooled run without a mesh, bar {GLMM_MOMENT_Z} (the "
                  f"same bits {same_bits(runs[True, True], runs[True, False])}"
                  f"; against the per-chain run, not gated, max z "
                  f"{z_laws[0]:.3f}, {z_laws[1]} of parameter {z_laws[2]})",
                  flush=True)
            check(same, "the mesh of one changed the bits")
            check(z[0] < GLMM_MOMENT_Z, z)

            state = {"chains": m._chains_src,
                     "mass": MassState(diag=torch.as_tensor(
                         m.mass.diag, device=device)),
                     "step_size": torch.as_tensor(m.step_size, device=device),
                     "final": torch.as_tensor(m.final_q, device=device)}
            path = os.path.join(tmp, "checkpoint.npz")
            save_checkpoint(path, state)
            back = load_checkpoint(path, state)
            kept = all(a.device == b.device and torch.equal(a, b)
                       for a, b in ((back["chains"], state["chains"]),
                                    (back["mass"].diag, state["mass"].diag),
                                    (back["step_size"], state["step_size"]),
                                    (back["final"], state["final"])))
            resumed = lmodel.sample(resume_config(m, cfg),
                                    n_chains=MAIN_CHAINS, seed=1,
                                    device=device, mesh=mesh)
            print(f"phase checkpoint: {os.path.getsize(path)} bytes of CUDA "
                  f"tensors, round trip the same bits {kept}; resume_config "
                  f"run: draws {resumed.chains.shape}, accept "
                  f"{float(np.mean(resumed.accept_rate())):.3f}, step size "
                  f"{float(resumed.step_size[0]):.4g}", flush=True)
            check(kept, "checkpoint round trip")
            check(resumed.chains.shape == (MAIN_CHAINS, PAR_DRAWS, cd.n_vars)
                  and np.all(np.isfinite(resumed.chains)), "resumed run")
            lp1, g1 = cd.batched_logp_and_grad_fn()(
                q.T.contiguous(), cd.column_values(torch.float32, device))
            dist.destroy_process_group()

            outs = []
            for p in ranks:
                out, _ = p.communicate(
                    timeout=max(PAR_RANKS_S - (time.perf_counter()
                                               - t_ranks), 1))
                outs.append(out.decode(errors="replace"))
        finally:
            for p in ranks:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(ranks, outs)):
            print("\n".join(f"phase rank {r}: {line}"
                            for line in out.strip().splitlines()
                            if line.startswith("rank ")), flush=True)
            check(p.returncode == 0, f"rank {r}: {out[-3000:]}")
        res = [dict(np.load(os.path.join(tmp, f"rank_{r}.npz")))
               for r in (0, 1)]
    for k in res[0]:
        check(np.array_equal(res[0][k], res[1][k]),
              f"the two ranks' {k} differ")
    lp_t, g_t = logistic_truth(x, ys, q, device)
    tol_lp, tol_g, _ = density_bars(lp_t, g_t)
    lp2 = torch.as_tensor(res[0]["lp"], device=device)
    g2 = torch.as_tensor(res[0]["g"], device=device).T
    g1 = g1.T
    rel = {}
    for name, (a, b, off_lp, off_g) in {
            "sharded-vs-world-of-one": (lp2, g2, (lp1 - lp_t).abs(),
                                        (g1 - g_t).abs()),
            "the same, not widened": (lp2, g2, 0.0, 0.0),
            "sharded-vs-f64": (lp2, g2, 0.0, 0.0),
            "world-of-one-vs-f64": (lp1, g1, 0.0, 0.0)}.items():
        ref_lp, ref_g = ((lp_t, g_t) if name.endswith("f64")
                         else (lp1, g1))
        rel[name] = (float(((a - ref_lp).abs() / (tol_lp + off_lp)).max()),
                     float(((b - ref_g).abs() / (tol_g + off_g)).max()))
    dlp = float((lp2 - lp1).abs().max())
    z12 = moment_z(res[0]["c12"], u.chains, device)
    z21 = moment_z(res[0]["c21"], u.chains, device)
    print(f"phase two ranks over gloo on one card: the (1, 2) data-sharded "
          f"density at {q.shape[1]} q: max |dlp| {dlp:.3g} from the world "
          f"of one's; of the tolerance (lp, g): " + ", ".join(
              f"{k} {v[0]:.3f}, {v[1]:.3f}" for k, v in rel.items())
          + f"; (1, 2) run "
          f"max z {z12[0]:.3f} ({z12[1]} of parameter {z12[2]}), (2, 1) run "
          f"max z {z21[0]:.3f} ({z21[1]} of parameter {z21[2]}) against the "
          f"world of one's, bar {GLMM_MOMENT_Z}; the ranks hold the same "
          f"bits", flush=True)
    check(max(rel["sharded-vs-world-of-one"]) <= 1.0, rel)
    check(z12[0] < GLMM_MOMENT_Z, z12)
    check(z21[0] < GLMM_MOMENT_Z, z21)


def parallel_rank(port, rank, tmp) -> int:
    """``python3 chip_smoke.py parallel-rank PORT RANK DIR``: one of
    `parallel_section`'s two ranks, both on the card, joined over gloo
    (NCCL takes one rank a card): the (1, 2) data-sharded density at
    DIR/points.npy, then the logistic's run at (1, 2) and at (2, 1),
    written to DIR/rank_RANK.npz."""
    import torch
    import torch.distributed as dist

    import rainier_tpu_torch as rt
    from rainier_tpu_torch.parallel import make_mesh, sharded_logp_fn
    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    rank = int(rank)
    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    lmodel, _, _ = logistic_regression(rt)
    cd = lmodel.density()
    m12, m21 = make_mesh(1, 2), make_mesh(2, 1)
    q = torch.as_tensor(np.load(os.path.join(tmp, "points.npy")),
                        device=device)
    fn, _ = sharded_logp_fn(cd, m12)
    lp, g = fn(q.T.contiguous())
    out = {"lp": lp.cpu().numpy(), "g": g.cpu().numpy()}
    print(f"rank {rank}: joined and density in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cfg = SamplerConfig(PAR_WARMUP, PAR_DRAWS, sampler=HMC(PAR_STEPS))
    for tag, mesh in (("c12", m12), ("c21", m21)):
        tr = lmodel.sample(cfg, n_chains=MAIN_CHAINS, seed=0, device=device,
                           mesh=mesh)
        out[tag] = tr.chains
        print(f"rank {rank}: {tag[1]} x {tag[2]} mesh, timings "
              f"{tr.timings}", flush=True)
    np.savez(os.path.join(tmp, f"rank_{rank}.npz"), **out)
    dist.destroy_process_group()
    return 0


def advi_spread() -> int:
    """``python3 chip_smoke.py advi-spread``: the README main path, then
    ADVI at each of ADVI_SPREAD_SEEDS, printed and not held to the bars
    (the spread over seeds, PERF.md §2)."""
    import torch

    import rainier_tpu_torch as rt
    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device(DEVICE)
    print(f"phase card: {nvidia_smi()}", flush=True)
    readme = readme_regression(rt)
    ems = build_all(F, {"README regression": readme[0].density()}, {})
    _, readme_tr = readme_phases(F, readme, ems["README regression"], device)
    advi_phase(rt, readme, readme_tr, device, ADVI_SPREAD_SEEDS, bars=False)
    return 0


def samplers_alone() -> int:
    """``python3 chip_smoke.py samplers``: the samplers that run outside the
    kernel, on the scan path: eight schools under NUTS with dense mass,
    the funnel under EHMC, then Model.smc on eight schools.  `main` runs it
    beside the sections that time no launch (`beside`)."""
    import torch

    import rainier_tpu_torch as rt

    device = torch.device(DEVICE)
    with phase("eight schools (NUTS, dense mass)", device):
        quad = nuts_phase(rt, device)
    with phase("funnel (default config: EHMC)", device):
        ehmc_phase(rt, device)
    with phase("Model.smc", device):
        smc_phase(rt, quad, device)
    return 0


def parallel_alone() -> int:
    """``python3 chip_smoke.py parallel``: the parallel section alone."""
    import torch

    import rainier_tpu_torch as rt

    device = torch.device(DEVICE)
    print(f"phase card: {nvidia_smi()}, torch {torch.__version__}",
          flush=True)
    lmodel, x, ys = logistic_regression(rt)
    w_map, cov = laplace_reference(x, ys)
    with phase("parallel", device):
        parallel_section(rt, lmodel, x, ys, w_map, cov, device)
    return 0


def main(argv=()) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if list(argv) == ["advi-spread"]:
        return advi_spread()
    if list(argv[:1]) == ["parallel-rank"]:
        return parallel_rank(*argv[1:])
    if list(argv) == ["parallel"]:
        return parallel_alone()
    if list(argv) == ["samplers"]:
        return samplers_alone()
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.core.trace import Trace
    from rainier_tpu_torch.ops import fused_hmc as F

    t_start = time.perf_counter()
    device = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"phase card: {name} ({torch.cuda.device_count()} visible), "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- build: every model's kernel at once --------------------------------
    fmodel, y = funnel(rt)
    wmodel, wy = funnel(rt, WIDE_DIM)
    lmodel, x, ys = logistic_regression(rt)
    readme = readme_regression(rt)
    gmodel = glmm_poisson(rt)
    large = glmm_large(rt)
    l2model, x2, ys2 = logistic_regression(rt, LOGIT2M_ROWS)
    mv = mvnormal_logistic(rt, x, ys)
    smodel = split_logistic(rt, x, ys)
    mix = marginal_mixture(rt)
    gp = latent_gp(rt)
    gpw = latent_gp(rt, GP_WIDE_INPUTS)
    _, x32, ys32 = logistic_regression(rt, p=MV32_FEATURES)
    mv32 = mvnormal_logistic(rt, x32, ys32)
    forms = form_models(rt)
    cds = {"funnel": fmodel.density(),
           f"funnel {WIDE_DIM}": wmodel.density(),
           "README regression": readme[0].density(),
           "logistic regression": lmodel.density(),
           "MVNormal logistic": mv[0].density(),
           "logistic regression, two row spaces": smodel.density(),
           "GLMMPoisson2": gmodel.density(),
           "glmm_large": large.density(),
           "logistic regression 2M": l2model.density(),
           "marginalized mixture": mix[0].density(),
           "latent GP": gp[0].density(),
           f"latent GP {GP_WIDE_INPUTS}": gpw[0].density(),
           f"MVNormal logistic {MV32_FEATURES}": mv32[0].density(),
           **{f"form {name}": m.density()
              for name, (m, _) in forms.items()}}
    # the zoo's data synthesized on the card, and the SBC phase's models,
    # so that their kernels build with the others
    zoo_fit_models = zoo_models(rt, device)
    cds.update({f"zoo {name}": m[0].density()
                for name, m in zoo_fit_models.items()})
    sbcs = {name: sbc for name, sbc in zoo(rt) if name in SBC_FAMILIES}
    cds.update({f"SBC {name}": sbc._fit_template(SBC_ROWS)[0].density()
                for name, sbc in sbcs.items()})
    with phase("build", device):
        ems = build_all(F, cds, {"funnel": (MAIN_CHAINS, THROUGHPUT_CHAINS),
                                 "logistic regression 2M": (
                                     LOGIT2M_CHAINS,)})

    # -- the funnel: the column-free phases ----------------------------------
    with phase("funnel", device):
        kernels, funnel_tr = funnel_phases(F, cds["funnel"], fmodel, y,
                                           ems["funnel"], device, smi)
    with phase(f"funnel {WIDE_DIM}", device):
        kernels += wide_phases(F, cds[f"funnel {WIDE_DIM}"], wmodel, wy,
                               ems[f"funnel {WIDE_DIM}"], device)

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
        entry, readme_tr = readme_phases(F, readme,
                                         ems["README regression"], device)
        kernels.append(entry)
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
                                   ems["MVNormal logistic"], x, ys, device,
                                   warmup=MV_WARMUP)
    with phase("logistic regression, two row spaces", device):
        kernels.append(split_phases(
            F, cds["logistic regression, two row spaces"],
            ems["logistic regression, two row spaces"], lcd, x, ys, w_map,
            cov, device))

    # -- the forms slice: a latent GP, MVNormal past 16, the row forms -------
    kernels += forms_sections(F, rt, cds, ems, gp, gpw, mv32, x32, ys32,
                              forms, device)

    # -- GLMMPoisson2: integer index columns ---------------------------------
    with phase("GLMMPoisson2", device):
        entries, glmm_tr = glmm_phases(F, gmodel, cds["GLMMPoisson2"],
                                       ems["GLMMPoisson2"], device)
        kernels += entries

    # -- glmm_large: the chain state in the kernel's workspace ---------------
    with phase("glmm_large", device):
        kernels += large_phases(F, large, cds["glmm_large"],
                                ems["glmm_large"], device)

    # -- the 2M-row logistic regression: streamed columns ---------------------
    kernels += logit2m_phases(F, l2model, cds["logistic regression 2M"],
                              ems["logistic regression 2M"], x2, ys2, lcd,
                              w_map, cov, device)

    # -- the sections that time no launch, beside the samplers outside the
    # kernel (NUTS with dense mass, EHMC, SMC) in a process of their own:
    # both are eager loops bound by the host, one core each
    t_beside = time.perf_counter()
    with beside("samplers", SAMPLERS_S):
        # -- the generative side and the rest of Trace: the zoo at 100k rows
        t_new = time.perf_counter()
        with phase("zoo fits", device):
            zoo_fits, zoo_counts = zoo_phases(F, zoo_fit_models, device)
        with phase("posterior predictive and the prior", device):
            predictive_phases(rt, readme, readme_tr, zoo_fits,
                              zoo_fit_models, device)
        with phase("on-device diagnostics", device):
            diagnostics_phase({"funnel": funnel_tr, "GLMMPoisson2": Trace(
                glmm_tr._chains_src[..., ::DIAG_GLMM_EVERY], gmodel, None,
                None)})
        with phase("SBC", device):
            sbc_phase(sbcs, device)
        print(f"phase time, the generative sections: "
              f"{time.perf_counter() - t_new:.1f} s", flush=True)

        # -- the rest of inference: MAP, ADVI, auto_vip, progress ----------
        inference_sections(F, rt, readme, readme_tr, lmodel, w_map, cov,
                           device)

        # -- parallel: the mesh, data-sharded densities, checkpoints -------
        with phase("parallel", device):
            parallel_section(rt, lmodel, x, ys, w_map, cov, device)
        print(f"phase time, the sections beside the samplers: "
              f"{time.perf_counter() - t_beside:.1f} s", flush=True)

    # -- the timed sections after them: the zoo's kernel against its plain
    # version, and the marginalized mixture
    with phase("zoo: kernel vs plain", device):
        kernels += zoo_parity(F, cds, ems, zoo_fits, zoo_counts, device)
    with phase("marginalized mixture", device):
        kernels.append(mixture_phases(F, mix[0], cds["marginalized mixture"],
                                      ems["marginalized mixture"], *mix[1:],
                                      device))
    print(f"phase total: {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
