"""The discrete families and Multinomial in the port
(``rainier_tpu_torch/core/discrete.py``, ``core/multinomial.py``), held
against the JAX package's (``rainier_tpu/core/discrete.py:26-232``,
``core/multinomial.py``) and against scipy.

Every case is built through both packages by one ``build(rt)`` function
from the same numpy data:

* each family's ``log_density_at`` over a column of values, with its
  eq-guarded 0·log 0 corners: the port's torch f32 evaluation against the
  JAX package's jnp f32 (f32 rounding), and the port's f64 numpy
  evaluation against scipy's log-pmf (1e-9);
* the zero-inflated, constant-inflated and ``mean_and_precision`` forms,
  ``DiscreteConstant`` and ``DiscreteMixture``;
* ``Multinomial`` and ``Multinomial.optional`` against scipy;
* each family as a 1,000-row likelihood: ``CompiledDensity``'s logp and
  gradient against the JAX package's at seeded points, and
  ``Model.sample(kernel="fused!")`` on the CPU (the kernel's plain
  version) against the JAX package's sampler within 5 Monte-Carlo
  standard errors;
* with g++, the emitted density through the host build of
  ``csrc/fused_hmc.cu`` against autograd, the zero-inflated family's
  ``LogSumExp`` with its −∞ term included.
"""

import math

import numpy as np
import pytest
from scipy import stats

import jax.numpy as jnp
import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu.compute import interp as interp_j
from rainier_tpu.compute import real as Rj
from rainier_tpu_torch.compute import interp as interp_t
from rainier_tpu_torch.compute import real as Rt
from rainier_tpu_torch.sampler import HMC, SamplerConfig
from test_torch_columns import _host_library, _host_logp_grad

torch.set_num_threads(2)
rtt.config.set_device("cpu")


def _R(rt):
    return Rj if rt is rtj else Rt


# name: (the distribution at fixed parameters, values to evaluate at, the
# scipy log-pmf of those values)
PMF_CASES = {
    "geometric": (lambda rt: rt.Geometric(0.3), np.arange(0.0, 9.0),
                  lambda v: stats.geom.logpmf(v + 1, 0.3)),
    "neg_binomial": (lambda rt: rt.NegativeBinomial(0.3, 5.0),
                     np.arange(0.0, 12.0),
                     lambda v: stats.nbinom.logpmf(v, 5, 0.7)),
    "binomial": (lambda rt: rt.Binomial(0.3, 10.0), np.arange(0.0, 11.0),
                 lambda v: stats.binom.logpmf(v, 10, 0.3)),
    # the eq-guards: p = 0 and p = 1 leave 0·log 0 at v = 0 and v = k
    "binomial_p0": (lambda rt: rt.Binomial(0.0, 4.0), np.array([0.0]),
                    lambda v: stats.binom.logpmf(v, 4, 0.0)),
    "binomial_p1": (lambda rt: rt.Binomial(1.0, 4.0), np.array([4.0]),
                    lambda v: stats.binom.logpmf(v, 4, 1.0)),
    "beta_binomial": (lambda rt: rt.BetaBinomial(2.0, 3.0, 10.0),
                      np.arange(0.0, 11.0),
                      lambda v: stats.betabinom.logpmf(v, 10, 2, 3)),
    "beta_binomial_mean_precision": (
        lambda rt: rt.BetaBinomial.mean_and_precision(0.4, 5.0, 10.0),
        np.arange(0.0, 11.0), lambda v: stats.betabinom.logpmf(v, 10, 2, 3)),
    "poisson": (lambda rt: rt.Poisson(3.5), np.arange(0.0, 12.0),
                lambda v: stats.poisson.logpmf(v, 3.5)),
    "zero_inflated_geometric": (
        lambda rt: rt.Geometric(0.3).zero_inflated(0.2),
        np.arange(0.0, 9.0),
        lambda v: np.log(0.2 * (v == 0) + 0.8 * stats.geom.pmf(v + 1, 0.3))),
    "constant_inflated_poisson": (
        lambda rt: rt.Poisson(3.5).constant_inflated(2.0, 0.25),
        np.arange(0.0, 10.0),
        lambda v: np.log(0.25 * (v == 2) + 0.75 * stats.poisson.pmf(v, 3.5))),
    "discrete_mixture": (
        lambda rt: rt.DiscreteMixture({rt.Poisson(1.0): 0.4,
                                       rt.Geometric(0.2): 0.6}),
        np.arange(0.0, 10.0),
        lambda v: np.log(0.4 * stats.poisson.pmf(v, 1.0)
                         + 0.6 * stats.geom.pmf(v + 1, 0.2))),
}


def _lanes(rt, dist, values, backend, dtype):
    """dist.log_density_at over a column of `values`, by the package's
    lanes evaluator: (n,)."""
    R = _R(rt)
    col = R.Column(values)
    interp = interp_j if rt is rtj else interp_t
    lp = dist.log_density_at(col)
    env = {col.id: backend.asarray(values.reshape(-1, 1), dtype)}
    out = interp.evaluate_lanes([lp], env, backend, dtype)[0]
    return np.broadcast_to(np.asarray(out, dtype=np.float64).reshape(-1),
                           values.shape)


@pytest.mark.parametrize("name", sorted(PMF_CASES))
def test_log_density_at_matches_jax_and_scipy(name):
    """f32: the port's torch evaluation against the JAX package's jnp one,
    within 4 f32 ulps of each value's magnitude plus 4 of the terms'
    (lgamma terms of order 10 cancel to the log-pmf); f64: the port's
    numpy evaluation against scipy within 1e-9."""
    build, values, ref = PMF_CASES[name]
    t32 = _lanes(rtt, build(rtt), values, interp_t.torch_backend("cpu"),
                 torch.float32)
    j32 = _lanes(rtj, build(rtj), values, interp_j.jax_backend(),
                 jnp.float32)
    eps = np.finfo(np.float32).eps
    np.testing.assert_allclose(t32, j32, rtol=0,
                               atol=4 * eps * (30.0 + np.abs(j32).max()))
    t64 = _lanes(rtt, build(rtt), values, interp_t.NUMPY_BACKEND,
                 np.float64)
    np.testing.assert_allclose(t64, ref(values), rtol=1e-9, atol=1e-9)


def test_discrete_constant():
    """A point mass: 0 at its value, −∞ elsewhere, as the JAX package's."""
    values = np.array([0.0, 2.0, 3.0])
    got = [_lanes(rt, rt.core.DiscreteConstant(2.0), values,
                  interp.NUMPY_BACKEND, np.float64)
           for rt, interp in ((rtt, interp_t), (rtj, interp_j))]
    assert np.array_equal(got[0], got[1])
    assert np.array_equal(got[0], [-np.inf, 0.0, -np.inf])


def _f64(rt, expr):
    interp = interp_j if rt is rtj else interp_t
    return float(interp.evaluate([expr], {}, interp.NUMPY_BACKEND,
                                 np.float64)[0])


@pytest.mark.parametrize("counts", [(3, 0, 7), (0, 0, 10), (2, 5, 3)])
def test_multinomial_matches_jax_and_scipy(counts):
    """Multinomial over a dict of counts (zero counts through the
    eq-guard) and Multinomial.optional, in f64: the two packages equal
    within 1e-12, and scipy's multinomial within 1e-9."""
    pmf = {"a": 0.2, "b": 0.3, "c": 0.5}
    obs = dict(zip("abc", map(float, counts)))
    want = stats.multinomial.logpmf(counts, 10, [0.2, 0.3, 0.5])
    got = [_f64(rt, rt.Multinomial(pmf, 10.0).log_density_at(obs))
           for rt in (rtt, rtj)]
    assert abs(got[0] - got[1]) <= 1e-12 * (1 + abs(want))
    assert abs(got[0] - want) <= 1e-9 * (1 + abs(want))
    # optional: the outcomes a, b or none of them (probability 0.5)
    opt = {("a",): float(counts[0]), ("b",): float(counts[1]),
           None: float(counts[2])}
    got = [_f64(rt, rt.core.Multinomial.optional(
        {"a": 0.2, "b": 0.3}, 10.0).log_density_at(opt))
        for rt in (rtt, rtj)]
    assert abs(got[0] - got[1]) <= 1e-12 * (1 + abs(want))
    assert abs(got[0] - want) <= 1e-9 * (1 + abs(want))


# -- each family as a 1,000-row likelihood -----------------------------------

N_ROWS = 1000


def _data(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "geometric":
        return rng.geometric(0.3, N_ROWS) - 1.0
    if name == "neg_binomial":
        return rng.negative_binomial(10, 0.7, N_ROWS).astype(float)
    if name == "binomial":
        return rng.binomial(10, 0.3, N_ROWS).astype(float)
    if name == "beta_binomial":
        return rng.binomial(10, rng.beta(2.0, 3.0, N_ROWS)).astype(float)
    if name == "zero_inflated_geometric":
        v = rng.geometric(0.3, N_ROWS) - 1.0
        return np.where(rng.uniform(size=N_ROWS) < 0.3, 0.0, v)
    if name == "constant_inflated_poisson":
        v = rng.poisson(3.5, N_ROWS).astype(float)
        return np.where(rng.uniform(size=N_ROWS) < 0.25, 2.0, v)
    raise KeyError(name)


# name: build(rt) of a model whose likelihood is the family over the rows
LIKELIHOODS = {
    "geometric": lambda rt: rt.Model.observe(
        _data("geometric"), rt.Geometric(rt.Uniform(0, 1).latent())),
    "neg_binomial": lambda rt: rt.Model.observe(
        _data("neg_binomial"),
        rt.NegativeBinomial(rt.Uniform(0, 1).latent(), 10.0)),
    "binomial": lambda rt: rt.Model.observe(
        _data("binomial"), rt.Binomial(rt.Beta(2.0, 2.0).latent(), 10.0)),
    "beta_binomial": lambda rt: rt.Model.observe(
        _data("beta_binomial"), rt.BetaBinomial.mean_and_precision(
            rt.Uniform(0, 1).latent(), rt.Gamma(2.0, 5.0).latent(), 10.0)),
    "zero_inflated_geometric": lambda rt: rt.Model.observe(
        _data("zero_inflated_geometric"),
        rt.Geometric(rt.Uniform(0, 1).latent()).zero_inflated(
            rt.Uniform(0, 1).latent())),
    "constant_inflated_poisson": lambda rt: rt.Model.observe(
        _data("constant_inflated_poisson"),
        rt.Poisson(rt.Gamma(2.0, 2.0).latent()).constant_inflated(
            2.0, rt.Uniform(0, 1).latent())),
}


def _points(n_vars, n, seed):
    return np.random.default_rng(seed).normal(scale=0.5, size=(n, n_vars))


@pytest.mark.parametrize("name", sorted(LIKELIHOODS))
def test_likelihood_logp_and_grad_match_jax(name):
    """CompiledDensity.logp_and_grad (f32) at 4 seeded points against the
    JAX package's: lp within 1e-5 relative (1,000 f32 terms summed in
    other orders), gradients within 1e-4 of their largest entry."""
    cdt, cdj = LIKELIHOODS[name](rtt).density(), \
        LIKELIHOODS[name](rtj).density()
    assert cdt.n_vars == cdj.n_vars
    for q in _points(cdt.n_vars, 4, 1):
        lp_t, g_t = cdt.logp_and_grad(q, device="cpu")
        lp_j, g_j = cdj.logp_and_grad(jnp.asarray(q, jnp.float32))
        lp_j, g_j = float(lp_j), np.asarray(g_j)
        assert abs(float(lp_t) - lp_j) <= 1e-5 * (1 + abs(lp_j))
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0,
                                   atol=1e-4 * (1 + np.abs(g_j).max()))


def _mean_and_se(tr):
    """Per-coordinate posterior mean and its Monte-Carlo standard error
    sd / sqrt(ESS), ESS from the trace's own diagnostics (host f64)."""
    flat = tr.flat().astype(np.float64)
    ess = np.array([d.effective_sample_size
                    for d in tr.diagnostics(device=False)])
    return flat.mean(0), flat.std(0) / np.sqrt(ess)


@pytest.mark.parametrize("name", sorted(LIKELIHOODS))
def test_fused_sample_matches_jax(name):
    """Model.sample(kernel="fused!", device="cpu") against the JAX
    package's Model.sample (its scan path), 8 chains × (150 warmup + 200
    draws) of HMC(5) each: every coordinate's mean within 5 Monte-Carlo
    standard errors of the two runs combined."""
    tr_t = LIKELIHOODS[name](rtt).sample(
        SamplerConfig(150, 200, sampler=HMC(5)), n_chains=8, seed=0,
        kernel="fused!", device="cpu")
    tr_j = LIKELIHOODS[name](rtj).sample(
        rtj.SamplerConfig(150, 200, sampler=rtj.HMC(5)), n_chains=8, seed=0)
    (m_t, se_t), (m_j, se_j) = _mean_and_se(tr_t), _mean_and_se(tr_j)
    z = np.abs(m_t - m_j) / np.sqrt(se_t ** 2 + se_j ** 2)
    assert np.all(z < 5.0), z
    assert np.all(np.isfinite(tr_t.chains))


@pytest.mark.parametrize("name", ["zero_inflated_geometric",
                                  "constant_inflated_poisson", "binomial"])
def test_host_build_matches_autograd(name, tmp_path):
    """The emitted density through the host build of the kernel's tile
    loop (f32 per tile, f64 across) against torch autograd on the lanes
    evaluator, at 5 seeded points: lp within 1e-5 relative, gradients
    within 1e-5 of their largest entry.  The inflated families' rows
    away from the inflated value hold a −∞ LogSumExp term, which must
    leave lp and g finite."""
    cd = LIKELIHOODS[name](rtt).density()
    lib, em = _host_library(cd, tmp_path)
    q = torch.as_tensor(_points(cd.n_vars, 5, 2).T,
                        dtype=torch.float32).contiguous()
    cols = cd.column_values(torch.float32, "cpu")
    lp, g = _host_logp_grad(lib, em, q, cols)
    lp_t, g_t = cd.batched_logp_and_grad_fn()(q.T.contiguous(), cols)
    assert torch.isfinite(lp).all() and torch.isfinite(g).all()
    np.testing.assert_allclose(lp.numpy(), lp_t.numpy(), rtol=1e-5,
                               atol=1e-5 * (1 + np.abs(lp_t.numpy()).max()))
    np.testing.assert_allclose(g.numpy().T, g_t.numpy(), rtol=0,
                               atol=1e-5 * np.abs(g_t.numpy()).max())


def test_inflated_density_at_a_lone_point():
    """At v ≠ 0 the zero-inflated density's point-mass term is −∞ and the
    LogSumExp is the other term plus log(1 − ψ); its gradient in p is the
    geometric's, finite (autograd through the port's lanes evaluator)."""
    p = torch.tensor([[0.3]], dtype=torch.float64, requires_grad=True)
    x = Rt.parameter(lambda q: Rt.zero)
    lp = rtt.Geometric(x).zero_inflated(0.2).log_density_at(Rt.const(4.0))
    out = interp_t.evaluate_lanes([lp], {x.id: p},
                                  interp_t.torch_backend("cpu"),
                                  torch.float64)[0]
    (g,) = torch.autograd.grad(out.sum(), p)
    want = math.log(0.8) + math.log(0.3) + 4 * math.log(0.7)
    assert abs(float(out) - want) < 1e-12
    assert abs(float(g) - (1 / 0.3 - 4 / 0.7)) < 1e-10


def test_log_one_minus_logistic_is_softplus():
    """1 − logistic(x) folds to logistic(−x), so a geometric's log(1 − p)
    on a Uniform latent is −softplus(q): at q = 16 (p = 1 − 1.1e-7) the
    f32 density is within 1e-3 of f64, where log(1 − p) computed from p
    would round 1 − p to 0 or to a multiple of 6e-8."""
    x = Rt.parameter(lambda q: Rt.zero)
    lp = rtt.Geometric(x.logistic()).log_density_at(Rt.const(3.0))
    nodes = {type(n).__name__ + getattr(n, "op", "")
             for n in Rt.topological([lp])}
    assert "Binarysub" not in nodes
    got = [float(interp_t.evaluate_lanes(
        [lp], {x.id: torch.tensor([[16.0]], dtype=dt)},
        interp_t.torch_backend("cpu"), dt)[0].reshape(()))
        for dt in (torch.float32, torch.float64)]
    assert abs(got[0] - got[1]) < 1e-3
    assert abs(got[1] - (-np.logaddexp(0, -16.0) - 3 * np.logaddexp(0, 16.0))
               ) < 1e-9


def test_fused_sample_warms_up_in_the_dtype_asked():
    """Model.sample(kernel="fused!", dtype=torch.float64): warmup in f64
    (its step sizes and mass), the kernel's draws in f32."""
    model = LIKELIHOODS["geometric"](rtt)
    tr = model.sample(SamplerConfig(40, 20, sampler=HMC(3)), n_chains=4,
                      seed=0, kernel="fused!", device="cpu",
                      dtype=torch.float64)
    assert tr.step_size.dtype == np.float64
    assert tr.mass.diag.dtype == np.float64
    assert tr.chains.dtype == np.float32 and tr.chains.shape == (4, 20, 1)
    assert np.all(np.isfinite(tr.chains))
