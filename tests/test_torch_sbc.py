"""Simulation-based calibration in the port (``rainier_tpu_torch/core/
sbc.py``) on the goldset zoo, built through either package by one
``zoo(rt)``.

The JAX package's goldsets (``tests/goldsets/``) are bit-pinned to
``jax.random`` (``tests/goldset_zoo.py:1-12``), whose streams the port
does not share, so the port is held to what SBC itself asks:

* every one of the 12 families synthesizes finite data of its support
  and fits: the model ``SBC.fit`` builds has the JAX package's density
  on the same data, and ``Model.sample(kernel="fused!")`` on the CPU
  draws finite values of the statistic;
* ``SBC.simulate`` on two families (a zero-inflated discrete likelihood
  and a binomial) passes ``tests/test_sbc.py:27-34``'s bars: max r̂
  under 1.2, ranks in at least two bins, rank-uniformity p-value over
  1e-4;
* ``rank_uniformity_pvalue`` and ``binomial_quantile`` equal the JAX
  package's.
"""

import io

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu.core import sbc as sbc_j
from rainier_tpu_torch.core import sbc as sbc_t
from rainier_tpu_torch.sampler import HMC, SamplerConfig

torch.set_num_threads(2)
rtt.config.set_device("cpu")


def zoo(rt):
    """tests/goldset_zoo.py:28-56's 12 families through either package:
    {name: SBC}."""
    SBC = rt.core.SBC
    return {
        "uniform_normal": SBC.of(rt.Uniform(0, 1),
                                 lambda x: rt.Normal(x, 1.0)),
        "lognormal": SBC.of(rt.LogNormal(0, 0.5),
                            lambda x: rt.Normal(x, 1.0)),
        "exponential": SBC.of(rt.Exponential(0.5),
                              lambda x: rt.Normal(x, 1.0)),
        "laplace": SBC.of(rt.Laplace(0, 1), lambda x: rt.Normal(x, 1.0)),
        "gamma_normal": SBC.of(rt.Gamma(2.0, 2.0),
                               lambda x: rt.Normal(x, 2.0)),
        "bernoulli": SBC.of(rt.Uniform(0, 1), lambda x: rt.Bernoulli(x)),
        "binomial": SBC.of(rt.Beta(1.0, 1.0),
                           lambda x: rt.Binomial(x, 10.0)),
        "geometric": SBC.of(rt.Uniform(0, 1), lambda x: rt.Geometric(x)),
        "neg_binomial": SBC.of(rt.Uniform(0, 1),
                               lambda x: rt.NegativeBinomial(x, 10.0)),
        "poisson": SBC.of(rt.Gamma(2.0, 2.0), lambda x: rt.Poisson(x)),
        "large_poisson": SBC.of(rt.Gamma(2.0, 50.0),
                                lambda x: rt.Poisson(x)),
        "zero_inflated_geometric": SBC.of(
            rt.Uniform(0, 1), lambda x: rt.Geometric(x).zero_inflated(0.3)),
    }


DISCRETE = {"bernoulli", "binomial", "geometric", "neg_binomial", "poisson",
            "large_poisson", "zero_inflated_geometric"}


@pytest.mark.parametrize("name", sorted(zoo(rtt)))
def test_zoo_synthesizes_and_fits(name):
    """40 rows from a fixed seed: finite, integer-valued for the discrete
    families, the same seed the same data; the fit's density at 3 points
    within f32 rounding of the JAX package's fit of the same data; two
    chains of kernel="fused!" on the CPU give a finite statistic."""
    sbc = zoo(rtt)[name]
    data, truth = sbc.synthesize(40, 3)
    again, truth2 = sbc.synthesize(40, 3)
    assert data.shape == (40,) and np.all(np.isfinite(data))
    assert np.array_equal(data, again) and truth == truth2
    assert np.isfinite(truth)
    if name in DISCRETE:
        assert data.dtype == np.int32 and data.min() >= 0
    model, stat = sbc.fit(data)
    model_j, _ = zoo(rtj)[name].fit(data)
    cd, cdj = model.density(), model_j.density()
    for q in np.random.default_rng(1).normal(scale=0.5, size=(3, 1)):
        got = float(cd.logp(q, device="cpu"))
        want = float(cdj.logp(jnp.asarray(q, jnp.float32)))
        assert abs(got - want) <= 1e-5 * (1 + abs(want))
    tr = model.sample(SamplerConfig(60, 40, sampler=HMC(4)), n_chains=2,
                      seed=1, kernel="fused!", device="cpu")
    vals = tr.evaluate(stat)
    assert vals.shape == (80,) and np.all(np.isfinite(vals))


def _cfg(n):
    # tests/test_sbc.py's config at a small size: warmup cut from 500 to
    # 150 (these 1-D posteriors at 30 rows adapt within it) and HMC(4) for
    # HMC(6), which at the adapted step turns a trajectory nearly a full
    # period, so that SBC refits to thin (chip_smoke.py SBC_STEPS)
    return SamplerConfig(warmup_iterations=150, iterations=max(n, 64),
                         sampler=HMC(4))


@pytest.mark.parametrize("name", ["zero_inflated_geometric", "binomial"])
def test_sbc_reps_calibrate(name, monkeypatch):
    """tests/test_sbc.py:27-34's bars, 12 repetitions at 30 rows, 4 bins,
    on the port's scan path on the CPU, each ranked among 256 draws (the
    reference's 1024 cut for the CPU time)."""
    monkeypatch.setattr(sbc_t, "SAMPLES", 256)
    reps = list(zoo(rtt)[name].simulate(30, _cfg, log_bins=2, reps=12,
                                        seed=0, device="cpu"))
    ranks = [r.rank for r in reps]
    assert len(reps) == 12 and all(0 <= r < 4 for r in ranks)
    assert max(r.r_hat for r in reps) < 1.2
    assert len(set(ranks)) >= 2, ranks
    assert sbc_t.rank_uniformity_pvalue(reps, 4) > 1e-4
    assert all(r.seconds > 0 and r.thin >= 1 for r in reps)


def test_helpers_match_jax():
    reps_t = [sbc_t.Rep(rank=r, r_hat=1.0, thin=1,
                        effective_sample_size=100.0, seconds=0.1)
              for r in (0, 1, 1, 3, 2, 2, 2, 0)]
    reps_j = [sbc_j.Rep(**vars(r)) for r in reps_t]
    assert sbc_t.rank_uniformity_pvalue(reps_t, 4) == \
        sbc_j.rank_uniformity_pvalue(reps_j, 4)
    for q in (0.005, 0.5, 0.995):
        assert sbc_t.binomial_quantile(q, 320, 0.125) == \
            sbc_j.binomial_quantile(q, 320, 0.125)
    # SBC.animate's frame (the rank histogram in the terminal), which the
    # port draws since viz/ was ported: the JAX package's, character for
    # character
    frames = []
    for pkg, reps in ((sbc_t, reps_t), (sbc_j, reps_j)):
        out = io.StringIO()
        pkg.SBC._plot(None, reps, 4, len(reps), len(reps), 0, 4, 0.0, out)
        frames.append(out.getvalue())
    assert frames[0] == frames[1] and "Repetition 8/8" in frames[0]
    with pytest.raises(ValueError, match="log_bins"):
        next(zoo(rtt)["poisson"].simulate(30, _cfg, log_bins=0))
