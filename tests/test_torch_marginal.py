"""Marginalized discrete latents in the port (``core/marginal.py``),
held against the JAX package's ``rainier_tpu/core/marginal.py``.

Every case of tests/test_marginal.py runs through the port under that
file's bars, and beside it:

* the marginal densities by the port's ``Evaluator`` against the JAX
  package's ``Evaluator`` on the same graph built through each package,
  exactly (both are numpy float64 over one interpreter);
* logp and gradient of the marginal models, compiled, against
  ``jax.value_and_grad`` of the JAX package's density at seeded points
  in f32, within 1e-5·(1 + |lp|) and 1e-5·(1 + max |g|);
* the column-shaped mixture (tests/test_marginal.py:114-138 with its two
  locations latent, as chip_smoke.py runs it at 100,000 rows) through
  ``Model.sample(kernel="fused!")`` on the CPU, which runs the kernel's
  plain version, against the JAX package's sampler: every posterior mean
  within 5 Monte-Carlo standard errors (each side's SE from its own
  ESS), and the responsibilities by ``Trace.evaluate``.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu.compute import Evaluator as EvaluatorJ
from rainier_tpu.compute import real as Rj
from rainier_tpu_torch.compute import Evaluator as EvaluatorT
from rainier_tpu_torch.compute import emit_cuda
from rainier_tpu_torch.compute import real as Rt
from rainier_tpu_torch.core import enumerated_support

torch.set_num_threads(2)
rtt.config.set_device("cpu")


def _R(rt):
    return Rj if rt is rtj else Rt


def test_enumerated_support():
    rt, R = rtt, Rt
    assert enumerated_support(rt.Bernoulli(0.3)) == [0.0, 1.0]
    assert enumerated_support(rt.Binomial(0.5, 4.0)) == [0, 1, 2, 3, 4]
    assert enumerated_support(rt.BetaBinomial(1.0, 1.0, 3.0)) == [0, 1, 2, 3]
    assert enumerated_support(rt.DiscreteConstant(2.0)) == [2.0]
    assert enumerated_support(rt.Poisson(3.0)) is None
    assert enumerated_support(rt.Poisson(3.0), max_value=5) == [0, 1, 2, 3,
                                                                4, 5]
    mix = rt.DiscreteMixture({rt.DiscreteConstant(0.0): R.const(0.3),
                              rt.Bernoulli(0.5): R.const(0.7)})
    assert enumerated_support(mix) == [0.0, 1.0]
    with pytest.raises(ValueError, match="no finite support"):
        rt.marginalize(rt.Poisson(2.0), lambda z: R.zero)
    with pytest.raises(ValueError, match="empty support"):
        rt.marginalize(rt.Bernoulli(0.5), support=[])


def bernoulli_case(rt, theta=0.3, x=0.7):
    mus = [-1.0, 2.0]
    return rt.marginalize(rt.Bernoulli(theta), lambda z: rt.Normal(
        mus[z], 1.0).log_density_at(_R(rt).const(x)))


def poisson_case(rt):
    return rt.marginalize(rt.Poisson(2.0), lambda z: rt.Normal(
        float(z), 1.0).log_density_at(_R(rt).const(3.0)), max_value=20)


def test_bernoulli_marginal_matches_hand_logsumexp_and_jax():
    theta, x = 0.3, 0.7
    m = bernoulli_case(rtt)
    mj = bernoulli_case(rtj)

    def norm_lpdf(v, mu):
        return -0.5 * (v - mu) ** 2 - 0.5 * math.log(2 * math.pi)

    want = np.logaddexp(math.log(1 - theta) + norm_lpdf(x, -1.0),
                        math.log(theta) + norm_lpdf(x, 2.0))
    got = float(EvaluatorT().value(m.log_density))
    assert abs(got - want) < 1e-10
    assert got == float(EvaluatorJ().value(mj.log_density))
    p1 = float(EvaluatorT().value(m.posterior_prob(1)))
    assert abs(p1 - math.exp(math.log(theta) + norm_lpdf(x, 2.0) - want)
               ) < 1e-10
    probs = [float(EvaluatorT().value(p)) for p in m.posterior_probs()]
    assert abs(sum(probs) - 1.0) < 1e-10
    assert probs == [float(EvaluatorJ().value(p))
                     for p in mj.posterior_probs()]
    pm = float(EvaluatorT().value(m.posterior_mean()))
    assert abs(pm - probs[1]) < 1e-10


def test_truncated_poisson_marginal():
    m, mj = poisson_case(rtt), poisson_case(rtj)
    got = float(EvaluatorT().value(m.log_density))
    ks = np.arange(21)
    lpmf = ks * math.log(2.0) - 2.0 - np.array(
        [math.lgamma(k + 1) for k in ks])
    lbody = -0.5 * (3.0 - ks) ** 2 - 0.5 * math.log(2 * math.pi)
    want = float(np.logaddexp.reduce(lpmf + lbody))
    assert abs(got - want) < 1e-8
    assert got == float(EvaluatorJ().value(mj.log_density))
    pm = float(EvaluatorT().value(m.posterior_mean()))
    assert abs(pm - float(np.sum(ks * np.exp(lpmf + lbody - want)))) < 1e-8
    assert pm == float(EvaluatorJ().value(mj.posterior_mean()))


def fd_model(rt):
    """tests/test_marginal.py:69-91's model: mu a parameter, z ~
    Bernoulli(0.4), 0.5 ~ N(±mu, 1)."""
    R = _R(rt)
    mu = R.parameter(lambda p: R.zero)
    m = rt.marginalize(rt.Bernoulli(0.4), lambda z: rt.Normal(
        mu if z == 1 else -mu, 1.0).log_density_at(R.const(0.5)))
    return rt.Model.likelihood(m.log_density), mu, m


def test_marginal_gradient_matches_finite_differences():
    """The compiled gradient against central differences of the port's
    Evaluator (tests/test_marginal.py:69-91's bars)."""
    model, mu, m = fd_model(rtt)
    cd = model.density()
    for v in [-1.5, -0.3, 0.0, 0.8, 2.0]:
        eps = 1e-5
        up = float(EvaluatorT({mu: v + eps}).value(m.log_density))
        dn = float(EvaluatorT({mu: v - eps}).value(m.log_density))
        fd = (up - dn) / (2 * eps)
        lp, g = cd.logp_and_grad([v], device="cpu")
        oracle = float(EvaluatorT({mu: v}).value(m.log_density))
        assert abs(float(lp) - oracle) < 1e-5 * max(1.0, abs(oracle))
        assert abs(float(g[0]) - fd) < 1e-3 * max(1.0, abs(fd))


def mixture(rt, n=200, latent_locations=True, seed=0):
    """A two-component mixture over a data Column of n rows, z_i ~
    Bernoulli(0.4), y_i ~ N(±4, 0.5²), z marginalized under one RowSum.
    With `latent_locations`, a ~ N(4, 1) and b ~ N(−4, 1) (as
    chip_smoke.py), else ±4.  Returns (model, theta, m, z_true, [a, b])."""
    R = _R(rt)
    rng = np.random.default_rng(seed)
    z_true = rng.random(n) < 0.4
    ys = np.where(z_true, rng.normal(4.0, 0.5, n), rng.normal(-4.0, 0.5, n))
    theta = rt.Beta(1.0, 1.0).latent()
    locs = ([rt.Normal(4.0, 1.0).latent(), rt.Normal(-4.0, 1.0).latent()]
            if latent_locations else [4.0, -4.0])
    col = R.Column(ys)
    m = rt.marginalize(rt.Bernoulli(theta), lambda z: rt.Normal(
        locs[0] if z == 1 else locs[1], 0.5).log_density_at(col))
    return (rt.Model.likelihood(R.RowSum(m.log_density, n)), theta, m,
            z_true, locs)


@pytest.mark.parametrize("case", ["fd", "mixture", "fixed_mixture"])
def test_marginal_logp_and_grad_match_jax(case):
    if case == "fd":
        (mt, *_), (mj, *_) = fd_model(rtt), fd_model(rtj)
    else:
        latent = case == "mixture"
        mt = mixture(rtt, latent_locations=latent)[0]
        mj = mixture(rtj, latent_locations=latent)[0]
    cdt, cdj = mt.density(), mj.density()
    assert cdt.n_vars == cdj.n_vars
    q = (np.random.default_rng(1).normal(size=(6, cdt.n_vars)) * 0.7
         ).astype(np.float32)
    lp_t, g_t = cdt.batched_logp_and_grad_fn()(
        torch.as_tensor(q), cdt.column_values(torch.float32, "cpu"))
    lp_j, g_j = jax.vmap(jax.value_and_grad(cdj.logp_fn()),
                         in_axes=(0, None))(jnp.asarray(q),
                                            cdj.column_values(jnp.float32))
    lp_j, g_j = np.asarray(lp_j), np.asarray(g_j)
    np.testing.assert_allclose(lp_t.numpy(), lp_j, rtol=1e-5,
                               atol=1e-5 * (1 + np.abs(lp_j).max()))
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-5,
                               atol=1e-5 * (1 + np.abs(g_j).max()))


def test_column_shaped_marginal_emits():
    """The mixture is one row space whose row term is a LogSumExp with a
    latent weight and latent locations: the emitter takes it."""
    em = emit_cuda.emit(mixture(rtt)[0].density())
    assert em.n_vars == 3 and len(em.spaces) == 1
    assert em.spaces[0].n_rows == 200


def _mean_se(x):
    """(mean, Monte-Carlo SE) of draws (chains, draws) by their ESS."""
    from rainier_tpu_torch.core.trace import Trace

    ess = Trace(x[..., None], None, None, None).diagnostics(
        device=False)[0].effective_sample_size
    return float(x.mean()), float(x.std()) / math.sqrt(ess)


def test_column_shaped_mixture_fused_against_jax():
    """tests/test_marginal.py:114-138's end-to-end test on the mixture
    with latent locations: the port's ``fused!`` (its plain version on
    the CPU) and the JAX package's scan path, each 4 chains of 300 + 300
    HMC(5); theta, a and b within 5 MC SE of each other, theta near the
    share of z, and the port's responsibilities assign every row."""
    from rainier_tpu.sampler import HMC as HMCj, SamplerConfig as CfgJ

    mt, theta_t, m_t, z_true, locs_t = mixture(rtt)
    mj, theta_j, _, _, locs_j = mixture(rtj)
    tr_t = mt.sample(rtt.SamplerConfig(300, 300, sampler=rtt.HMC(5)),
                     n_chains=4, seed=0, kernel="fused!")
    tr_j = mj.sample(CfgJ(300, 300, sampler=HMCj(5)), n_chains=4, seed=0)
    for et, ej in zip([theta_t] + locs_t, [theta_j] + locs_j):
        mt_, se_t = _mean_se(tr_t.evaluate(et).reshape(4, -1))
        mj_, se_j = _mean_se(np.asarray(tr_j.evaluate(ej)).reshape(4, -1))
        assert abs(mt_ - mj_) < 5 * math.hypot(se_t, se_j), (mt_, mj_)
    assert abs(float(np.mean(tr_t.evaluate(theta_t)))
               - float(np.mean(z_true))) < 0.1
    resp = tr_t.evaluate(m_t.posterior_prob(1))
    assert resp.shape == (1200, 200)
    mean_resp = resp.mean(axis=0)
    assert np.all((mean_resp > 0.5) == z_true)
    assert np.all(np.abs(mean_resp - z_true.astype(float)) < 0.05)
