"""Generators in the port (``rainier_tpu_torch/core/generator.py`` and
every ``generator()``), ``Trace.predict`` and ``Model.sample_prior``.

The port's draws come from torch's samplers, whose streams differ from
``jax.random``'s, so each generator is held to the law of its draws, at
a fixed ``torch.Generator`` seed:

* discrete families by a χ² goodness-of-fit against scipy's pmf, tails
  pooled into one cell;
* continuous families by a Kolmogorov–Smirnov test against scipy's cdf;
* ``MVNormal`` by its covariance; mixtures and ``repeat`` by moments;
* ``flat_map``, ``zip``, ``traverse``, ``categorical`` and
  ``Generator.of`` on tuples, dicts and a ``Vec`` by their shapes and
  values;
* ``Trace.predict`` against the JAX package's on the same posterior
  draws, by moments; ``Model.sample_prior`` as
  ``tests/test_distributions.py:179-195`` holds the JAX package's.

Every p-value bar is 1e-3 at a fixed seed: the draws are the same on
every run, and a correct generator passes it.
"""

import numpy as np
import pytest
from scipy import stats

import jax
import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu_torch.compute import real as Rt
from rainier_tpu_torch.core.generator import Env, Generator, to_generator
from rainier_tpu_torch.core.trace import Trace

torch.set_num_threads(2)
rtt.config.set_device("cpu")

N = 20000
P_MIN = 1e-3


def _draw(g, n=N, seed=0):
    """n draws of generator-like `g` from a fixed seed, draw axis first."""
    return to_generator(g).get(torch.Generator().manual_seed(seed),
                               Env(n, device="cpu"))


DISCRETE = {
    "poisson": (lambda: rtt.Poisson(3.5), lambda k: stats.poisson.pmf(k, 3.5)),
    "geometric": (lambda: rtt.Geometric(0.3),
                  lambda k: stats.geom.pmf(k + 1, 0.3)),
    "neg_binomial": (lambda: rtt.NegativeBinomial(0.3, 5.0),
                     lambda k: stats.nbinom.pmf(k, 5, 0.7)),
    "binomial": (lambda: rtt.Binomial(0.3, 10.0),
                 lambda k: stats.binom.pmf(k, 10, 0.3)),
    "beta_binomial": (lambda: rtt.BetaBinomial(2.0, 3.0, 10.0),
                      lambda k: stats.betabinom.pmf(k, 10, 2, 3)),
    "beta_binomial_mean_precision": (
        lambda: rtt.BetaBinomial.mean_and_precision(0.4, 5.0, 10.0),
        lambda k: stats.betabinom.pmf(k, 10, 2, 3)),
    "bernoulli": (lambda: rtt.Bernoulli(0.3),
                  lambda k: stats.bernoulli.pmf(k, 0.3)),
    "zero_inflated_geometric": (
        lambda: rtt.Geometric(0.3).zero_inflated(0.2),
        lambda k: 0.2 * (k == 0) + 0.8 * stats.geom.pmf(k + 1, 0.3)),
    "constant_inflated_poisson": (
        lambda: rtt.Poisson(3.5).constant_inflated(2.0, 0.25),
        lambda k: 0.25 * (k == 2) + 0.75 * stats.poisson.pmf(k, 3.5)),
    "discrete_mixture": (
        lambda: rtt.DiscreteMixture({rtt.Poisson(1.0): 0.4,
                                     rtt.Geometric(0.2): 0.6}),
        lambda k: 0.4 * stats.poisson.pmf(k, 1.0)
        + 0.6 * stats.geom.pmf(k + 1, 0.2)),
}


@pytest.mark.parametrize("name", sorted(DISCRETE))
def test_discrete_generator_law(name):
    """χ² goodness of fit of N draws against the pmf, over the cells
    whose expected count is at least 5, the rest pooled into one."""
    build, pmf = DISCRETE[name]
    draws = _draw(build()).numpy()
    assert draws.dtype == np.int32 and draws.shape == (N,)
    assert draws.min() >= 0
    kmax = int(draws.max())
    probs = pmf(np.arange(kmax + 1))
    keep = probs * N >= 5
    counts = np.bincount(draws, minlength=kmax + 1)
    obs = np.append(counts[keep], counts[~keep].sum())
    exp = np.append(probs[keep], 1.0 - probs[keep].sum()) * N
    if exp[-1] < 5:
        # too few expected in the tail to pool: the kept cells alone,
        # their expectations scaled to the draws that fell in them
        obs, exp = obs[:-1], exp[:-1] * obs[:-1].sum() / exp[:-1].sum()
    assert stats.chisquare(obs, exp).pvalue > P_MIN


CONTINUOUS = {
    "normal": (lambda: rtt.Normal(2.0, 3.0), stats.norm(2, 3).cdf),
    "cauchy": (lambda: rtt.Cauchy(1.0, 2.0), stats.cauchy(1, 2).cdf),
    "laplace": (lambda: rtt.Laplace(1.0, 2.0), stats.laplace(1, 2).cdf),
    "gamma": (lambda: rtt.Gamma(2.0, 3.0), stats.gamma(2, scale=3).cdf),
    "exponential": (lambda: rtt.Exponential(2.0),
                    stats.expon(scale=0.5).cdf),
    "beta": (lambda: rtt.Beta(2.0, 5.0), stats.beta(2, 5).cdf),
    "lognormal": (lambda: rtt.LogNormal(0.5, 1.5),
                  stats.lognorm(1.5, scale=np.exp(0.5)).cdf),
    "uniform": (lambda: rtt.Uniform(2.0, 5.0), stats.uniform(2, 3).cdf),
}


@pytest.mark.parametrize("name", sorted(CONTINUOUS))
def test_continuous_generator_law(name):
    """Kolmogorov–Smirnov test of N draws against the scipy cdf."""
    build, cdf = CONTINUOUS[name]
    draws = _draw(build()).double().numpy()
    assert draws.shape == (N,) and np.all(np.isfinite(draws))
    assert stats.kstest(draws, cdf).pvalue > P_MIN


def test_mvnormal_generator_covariance():
    """μ + L z: each entry of the sample covariance within 5 standard
    errors of Σ (SE² = (Σᵢᵢ Σⱼⱼ + Σᵢⱼ²)/N), the means within 5 SE."""
    cov = np.array([[2.0, 0.6, 0.0], [0.6, 1.0, -0.3], [0.0, -0.3, 0.5]])
    mu = [1.0, -2.0, 0.5]
    draws = _draw(rtt.MVNormal(mu, cov).generator()).double().numpy()
    assert draws.shape == (N, 3)
    d = np.sqrt(np.diag(cov))
    assert np.all(np.abs(draws.mean(0) - mu) < 5 * d / np.sqrt(N))
    se = np.sqrt((np.outer(d ** 2, d ** 2) + cov ** 2) / N)
    assert np.all(np.abs(np.cov(draws.T) - cov) < 5 * se)


def test_mixture_and_repeat_moments():
    """A continuous Mixture's mean and variance, and repeat(n)'s shape
    (N, n) with independent columns, within 5 standard errors."""
    mix = rtt.Mixture({rtt.Normal(0.0, 0.5): 0.3, rtt.Normal(4.0, 1.0): 0.7})
    x = _draw(mix).double().numpy()
    mean = 0.7 * 4.0
    var = 0.3 * 0.25 + 0.7 * (1.0 + 16.0) - mean ** 2
    assert abs(x.mean() - mean) < 5 * np.sqrt(var / N)
    assert abs(x.var() / var - 1) < 5 * np.sqrt(2.0 / N) * 2
    r = _draw(Generator.of(rtt.Poisson(2.0)).repeat(4), n=5000).double()
    r = r.numpy()
    assert r.shape == (5000, 4)
    assert np.all(np.abs(r.mean(0) - 2.0) < 5 * np.sqrt(2.0 / 5000))
    corr = np.corrcoef(r.T)[np.triu_indices(4, 1)]
    assert np.all(np.abs(corr) < 5 / np.sqrt(5000))


def test_combinators_and_shapes():
    """flat_map, zip, traverse, categorical and Generator.of on tuples,
    dicts and a Vec: shapes with the draw axis first, and values."""
    g = Generator.of(rtt.Poisson(3.0)).flat_map(
        lambda k: Generator.constant(k * 2))
    v = _draw(g, 1000).numpy()
    assert v.shape == (1000,) and np.all(v % 2 == 0)
    a, b = _draw(Generator.of(rtt.Normal(0.0, 1.0)).zip(
        Generator.of(rtt.Poisson(1.0))), 100)
    assert a.shape == b.shape == (100,) and b.dtype == torch.int32
    t = _draw(Generator.traverse([rtt.Normal(1.0, 0.1), 3.0]), 50)
    assert isinstance(t, list) and torch.all(t[1] == 3.0)
    c = _draw(Generator.categorical({1.0: 0.25, 5.0: 0.75})).numpy()
    assert set(np.unique(c)) == {1.0, 5.0}
    assert abs(np.mean(c == 5.0) - 0.75) < 5 * np.sqrt(0.1875 / N)
    out = _draw({"x": rtt.Normal(0.0, 1.0),
                 "t": (rtt.const(2.0), rtt.Bernoulli(0.5)),
                 "v": rtt.Vec.from_([1.0, 2.0, 3.0]).map(lambda x: x * 2)},
                7)
    assert out["x"].shape == (7,)
    assert isinstance(out["t"], tuple) and torch.all(out["t"][0] == 2.0)
    assert out["v"].shape == (7, 3)
    assert torch.allclose(out["v"], torch.tensor([2.0, 4.0, 6.0]))
    # a Vec of distributions over a column: one independent draw a row
    vec = rtt.Vec.from_([0.0, 10.0, 20.0]).map(lambda m: rtt.Normal(m, 1.0))
    d = _draw(vec, 4000).double().numpy()
    assert d.shape == (4000, 3)
    assert np.all(np.abs(d.mean(0) - [0.0, 10.0, 20.0]) < 5 / np.sqrt(4000))
    assert abs(np.corrcoef(d.T)[0, 1]) < 5 / np.sqrt(4000)
    with pytest.raises(ValueError, match="statically known"):
        Generator.of(1.0).repeat(rtt.Normal(0, 1).latent())


def test_same_seed_same_draws():
    g = Generator.of((rtt.Gamma(2.0, 1.0), rtt.NegativeBinomial(0.4, 3.0),
                      rtt.Geometric(0.2).zero_inflated(0.1)))
    a, b = _draw(g, 500, seed=5), _draw(g, 500, seed=5)
    c = _draw(g, 500, seed=6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def _predict_model(rt, data):
    mu = rt.Normal(0, 10).latent()
    return rt.Model.observe(list(data), rt.Normal(mu, 1.0)), mu


def test_predict_matches_jax_on_the_same_draws():
    """tests/test_sampler.py:180's posterior predictive, Normal(mu, 1)
    at each of the same 4,000 posterior draws of mu, through both
    packages' Trace.predict: means within 5 standard errors of each other
    (SE² = Var/4000 for each), SDs within 5% (the JAX package's own
    bar there is 0.25 on 1)."""
    data = np.random.default_rng(11).normal(2.0, 1.0, size=200)
    # the sampler's coordinate of mu ~ Normal(0, 10) is mu / 10
    draws = np.random.default_rng(3).normal(0.2, 0.007, size=(4, 1000, 1))
    preds = []
    for rt in (rtt, rtj):
        model, mu = _predict_model(rt, data)
        cd = model.density()
        tr = (Trace(torch.as_tensor(draws, dtype=torch.float32), model, cd,
                    None) if rt is rtt else
              rt.core.Trace(draws.astype(np.float32), model, cd, None))
        preds.append(np.asarray(tr.predict(rt.Normal(mu, 1.0), seed=1),
                                dtype=np.float64))
    t, j = preds
    assert t.shape == j.shape == (4000,)
    se = np.sqrt(t.var() / t.size + j.var() / j.size)
    assert abs(t.mean() - j.mean()) < 5 * se
    assert abs(t.std() / j.std() - 1) < 0.05
    assert abs(t.mean() - 2.0) < 0.2 and abs(t.std() - 1.0) < 0.25


def test_predict_shapes_thin_and_lazy_copy():
    """Trace.predict of a Vec of per-row Normals gives (draws, rows); a
    thinned trace keeps every n-th draw where the draws are, and the
    host copy of the draws is made on first read of `chains`."""
    rows = np.random.default_rng(1).normal(size=(30, 2))
    a = rtt.Normal(0, 1).latent()
    b = rtt.Normal(0, 1).latent_vec(2)
    vec = rtt.Vec.from_([tuple(r) for r in rows]).map(
        lambda t: rtt.Normal(a + rtt.Vec.of(*t).dot(b), 0.5))
    model = rtt.Model.observe(list(rows[:, 0]), vec)
    src = torch.as_tensor(np.random.default_rng(2).normal(
        size=(3, 40, 3)), dtype=torch.float32)
    tr = Trace(src, model, model.density(), None)
    assert tr.transfer_s is None
    thin = tr.thin(4)
    assert thin.n_iterations == 10 and thin.transfer_s is None
    p = thin.predict(vec, seed=2)
    assert p.shape == (30, 30)
    assert np.array_equal(thin.chains, src.numpy()[:, ::4])
    assert thin.transfer_s is not None and thin.transfer_s >= 0


def test_model_sample_prior():
    """tests/test_distributions.py:179-195 on the port (scan path on the
    CPU): supports, E[c] = 1.5, corr(a, c) > 0.1."""
    a = rtt.Uniform(0, 1).latent()
    c = rtt.Normal(a + 1, a).latent()
    da, dc = rtt.Model.sample_prior([a, c], n=400, seed=0, device="cpu")
    assert da.shape == dc.shape and da.shape[0] >= 400
    assert np.all((da > 0) & (da < 1))
    assert abs(float(np.mean(dc)) - 1.5) < 0.2
    assert float(np.corrcoef(da, dc)[0, 1]) > 0.1
    single = rtt.Model.sample_prior(a, n=200, seed=1, device="cpu")
    assert single.ndim == 1


def test_generators_of_both_packages_agree_in_law():
    """The Poisson, Gamma and zero-inflated geometric generators of both
    packages at the same parameters: two-sample KS p-value above 1e-3
    (jax.random's streams against torch's)."""
    keys = jax.random.split(jax.random.PRNGKey(0), 4000)
    for build in (lambda rt: rt.Poisson(4.0),
                  lambda rt: rt.Gamma(2.0, 2.0),
                  lambda rt: rt.Geometric(0.3).zero_inflated(0.3)):
        gj = build(rtj).generator()
        j = np.asarray(jax.vmap(lambda k: gj.get(k))(keys), np.float64)
        t = _draw(build(rtt), 4000, seed=9).double().numpy()
        assert stats.ks_2samp(t, j).pvalue > P_MIN


def test_env_binds_columns_whole():
    """An Env over N draws evaluates a parameter-free column expression
    as (rows, N), the same values in every draw, and a scalar
    parameter's as (N,)."""
    col = Rt.Column(np.array([1.0, 2.0]))
    p = Rt.parameter(lambda q: Rt.zero)
    env = Env(3, {p.id: torch.tensor([[0.5, 1.0, 2.0]])}, device="cpu")
    assert env(col * 3).shape == (2, 3)
    assert torch.equal(env(col * 3)[:, 1], torch.tensor([3.0, 6.0]))
    assert torch.equal(env(p * 2), torch.tensor([1.0, 2.0, 4.0]))
    assert env.shape(col, p) == (2, 3)
