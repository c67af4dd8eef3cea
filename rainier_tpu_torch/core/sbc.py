"""Simulation-Based Calibration (Talts et al., arXiv:1804.06788; port of
rainier_tpu/core/sbc.py, counterpart of core/SBC.scala:15-216).

Synthesize data from the prior, re-fit, and rank the true parameter
among the posterior draws; over many repetitions the ranks must be
uniform.  Auto-thinning until ESS ≥ `SAMPLES` (at most `TRIALS`
attempts) is the JAX package's.  Draws come from the port's generators
on the entry point's device, from one ``torch.Generator`` seeded by
`seed`; the fits run ``Model.sample`` there, with the `kernel` the
caller names.  ``animate`` draws the rank histogram in the terminal
after each repetition, as the JAX package's does.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .. import config
from ..compute import real as R
from .continuous import Continuous
from .generator import Env
from .model import Model

SAMPLES = 1024
CHAINS = 4
REPS_PER_BIN = 40
TRIALS = 5


@dataclass
class Rep:
    rank: int
    r_hat: float
    thin: int
    effective_sample_size: float
    seconds: float


def _rng(seed, device) -> torch.Generator:
    """`seed` as a torch.Generator on `device` (a Generator is used as
    it is)."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=config.resolve_device(device)).manual_seed(
        int(seed))


class SBC:
    """sbc = SBC([prior, ...], fn) where fn maps the latent values to
    (likelihood distribution, tracked statistic)."""

    def __init__(self, priors: Sequence[Continuous],
                 fn: Callable[[list], tuple]):
        self.priors = list(priors)
        self.fn = fn
        # one model graph per data length (_fit_template)
        self._templates: dict = {}

    @staticmethod
    def of(prior: Continuous, fn: Callable) -> "SBC":
        """SBC(prior){ x => dist } — calibrates on the latent itself
        (SBC.scala:185-189)."""
        return SBC([prior], lambda xs: (fn(xs[0]), xs[0]))

    # -- synthesize -------------------------------------------------------
    def synthesize(self, n_samples: int, seed=0, device=None) -> tuple:
        """Prior-predictive draw: (data values (n_samples,) numpy, true
        statistic).  `seed` is an int or a ``torch.Generator`` (whose
        device the draws use)."""
        gen = _rng(seed, device)
        one = Env(1, device=gen.device)
        vals = [float(p.generator().get(gen, one)[0]) for p in self.priors]
        dist, stat = self.fn([R.const(v) for v in vals])
        true_stat = float(one(stat)[0])
        data = dist.generator().get(gen, Env(n_samples, device=gen.device))
        return data.cpu().numpy(), true_stat

    def fit(self, values) -> tuple:
        dist, stat = self.fn([p.latent() for p in self.priors])
        return Model.observe(np.asarray(values, dtype=np.float64), dist), stat

    def _fit_template(self, n: int) -> tuple:
        """One model graph per data length; repetitions swap the Column's
        values through Model.with_data, so the compiled density and the
        fused kernel's build are reused across repetitions."""
        if n not in self._templates:
            col = R.Column(np.zeros(n))
            dist, stat = self.fn([p.latent() for p in self.priors])
            model = Model.likelihood(
                R.RowSum(dist.log_density_at(col), n))
            self._templates[n] = (model, stat, col)
        return self._templates[n]

    def model(self, n_synthetic: int, seed: int = 0, device=None) -> tuple:
        data, _ = self.synthesize(n_synthetic, seed, device)
        return self.fit(data)

    # -- repetition -------------------------------------------------------
    def _sample_once(self, sampler_fn, data, true_stat, thin, seed, device,
                     kernel):
        model, stat, col = self._fit_template(len(data))
        model.with_data({col: data})
        cfg = sampler_fn(SAMPLES * thin // CHAINS)
        trace = model.sample(cfg, n_chains=CHAINS, seed=seed, device=device,
                             kernel=kernel)
        trace = trace.thin(thin) if thin > 1 else trace
        diags = trace.diagnostics()
        max_rhat = max(d.r_hat for d in diags)
        min_ess = min(d.effective_sample_size for d in diags)
        stats = trace.evaluate(stat)
        raw_rank = int(np.sum(stats[1:] < true_stat))
        return raw_rank, max_rhat, min_ess, len(stats)

    def _repetition(self, sampler_fn, n_synthetic, bins, gen, seed,
                    kernel) -> Rep:
        """One synthesized data set, fitted again with more thinning
        until its ESS reaches SAMPLES (at most TRIALS fits), as the JAX
        package refits one key's data."""
        t0 = time.perf_counter()
        data, true_stat = self.synthesize(n_synthetic, gen)
        thin = 1
        for trial in range(TRIALS):
            raw_rank, r_hat, ess, n_draws = self._sample_once(
                sampler_fn, data, true_stat, thin, seed + trial, gen.device,
                kernel)
            if ess >= SAMPLES or trial == TRIALS - 1:
                break
            thin = int(math.ceil(SAMPLES / max(ess, 1.0)))
        rank = (raw_rank * bins) // max(n_draws - 1, 1)
        rank = min(rank, bins - 1)
        return Rep(rank=rank, r_hat=r_hat, thin=thin,
                   effective_sample_size=ess,
                   seconds=time.perf_counter() - t0)

    def simulate(self, n_synthetic: int, sampler_fn: Callable,
                 log_bins: int = 3, reps: Optional[int] = None,
                 seed: int = 0, device=None, kernel: str = "scan"):
        """Yield Reps (lazily, like the reference's Stream).  Every
        repetition draws from one generator seeded by `seed` on `device`
        and fits with ``Model.sample(kernel=kernel)`` there."""
        if log_bins <= 0:
            raise ValueError(f"log_bins must be positive, got {log_bins}")
        bins = 1 << log_bins
        if bins > SAMPLES:
            raise ValueError(f"{bins} bins exceed the {SAMPLES} draws")
        reps = reps if reps is not None else bins * REPS_PER_BIN
        gen = _rng(seed, device)
        for i in range(reps):
            yield self._repetition(sampler_fn, n_synthetic, bins, gen,
                                   seed + i * TRIALS, kernel)

    # -- terminal animation (SBC.animate / plot) --------------------------
    def animate(self, n_synthetic: int, sampler_fn: Callable,
                log_bins: int = 3, reps: Optional[int] = None,
                seed: int = 0, out=sys.stdout, device=None,
                kernel: str = "scan"):
        """Run `simulate` and, after each repetition, print the rank
        histogram so far with the 99% band of a uniform one (SBC.animate);
        returns the Reps."""
        bins = 1 << log_bins
        total = reps if reps is not None else bins * REPS_PER_BIN
        lower = binomial_quantile(0.005, total, 1.0 / bins)
        upper = binomial_quantile(0.995, total, 1.0 / bins)
        print(f"\nRunning simulation-based calibration "
              f"({total} reps, {bins} bins).", file=out)
        results = []
        t0 = time.time()
        for i, rep in enumerate(
                self.simulate(n_synthetic, sampler_fn, log_bins, total,
                              seed, device, kernel)):
            results.append(rep)
            elapsed = time.time() - t0
            remaining = elapsed * (total - i - 1) / (i + 1)
            self._plot(results, bins, i + 1, total, lower, upper,
                       remaining, out)
        return results

    def _plot(self, reps, bins, i, total, lower, upper, remaining, out):
        """One frame: the histogram of the ranks of `reps`, each bin green
        inside [lower, upper] and red outside, with the progress line."""
        counts = np.zeros(bins, dtype=int)
        for r in reps:
            counts[r.rank] += 1
        max_rhat = max(r.r_hat for r in reps)
        ess_per_s = sum(r.effective_sample_size for r in reps) / max(
            sum(r.seconds for r in reps), 1e-9)
        lines = [f"Repetition {i}/{total}. ~{remaining:.0f}s remaining. "
                 f"ESS/s {ess_per_s:.0f}. max rHat {max_rhat:.3f}"]
        lines.append("99% of bins should land between [ and ]")
        for c in counts:
            color = "\033[32m" if lower <= c <= upper else "\033[31m"
            bar = "#" * min(c, lower) + " " * max(lower - c, 0)
            mid = "#" * max(min(c - lower, upper - lower), 0)
            mid += " " * max(upper - lower - len(mid), 0)
            tail = "#" * max(c - upper, 0)
            lines.append(f"{color}{bar}[{mid}]{tail}\033[0m")
        print("\n".join(lines) + "\n", file=out)


def binomial_quantile(q: float, n: int, p: float) -> int:
    """Smallest k with CDF ≥ q (SBC.binomialQuantile)."""
    from scipy.stats import binom

    return int(binom.ppf(q, n, p))


def rank_uniformity_pvalue(reps: Sequence[Rep], bins: int) -> float:
    """χ² goodness-of-fit p-value of the rank histogram vs uniform."""
    from scipy.stats import chisquare

    counts = np.zeros(bins, dtype=int)
    for r in reps:
        counts[r.rank] += 1
    return float(chisquare(counts).pvalue)
