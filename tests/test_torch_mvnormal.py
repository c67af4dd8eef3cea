"""MVNormal in the port (``rainier_tpu_torch/core/mvnormal.py``), held
against the JAX package's (``rainier_tpu/core/mvnormal.py``).

* ``log_density`` over (n, k) data and ``log_density_at`` over a k-vector
  of Reals, evaluated in f64 by both packages' numpy evaluators at seeded
  inputs: equal within 1e-10 (the same f64 operations; only the order of
  a few sums may differ);
* ``latent_vec``'s log-density and gradient through ``CompiledDensity``
  against the JAX package's ``logp_and_grad_fn``, f32, at q from a numpy
  seed;
* the prior-only model of ``tests/test_mvnormal.py:30-44`` through the
  port's scan path, to the same moment bars.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu.compute import interp as interp_j
from rainier_tpu_torch.compute import interp as interp_t
from rainier_tpu_torch.sampler import HMC, SamplerConfig

torch.set_num_threads(2)
rtt.config.set_device("cpu")

COV = np.array([[2.0, 0.6], [0.6, 1.0]])


def _cov(k, seed):
    a = np.random.default_rng(seed).normal(size=(k, k))
    return a @ a.T + k * np.eye(k)


def _f64(rt, expr, env=None):
    interp = interp_j if rt is rtj else interp_t
    return float(interp.evaluate([expr], env or {}, interp.NUMPY_BACKEND,
                                 np.float64)[0])


@pytest.mark.parametrize("k", [2, 5])
def test_log_density_matches_jax(k):
    """Summed density of (n, k) observations, the mean a mix of Reals and
    numbers, one of them a parameter bound to a value."""
    rng = np.random.default_rng(k)
    cov, x = _cov(k, k + 1), rng.normal(size=(7, k))
    got = []
    for rt in (rtt, rtj):
        a = rt.Normal(0, 1).latent()
        mu = [a * 2.0] + [0.1 * i for i in range(1, k)]
        lh = rt.MVNormal(mu, cov).log_density(x)
        got.append(_f64(rt, lh, {a.id: 0.7}))
    assert abs(got[0] - got[1]) <= 1e-10 * (1 + abs(got[1]))


@pytest.mark.parametrize("k", [2, 5])
def test_log_density_at_matches_jax(k):
    rng = np.random.default_rng(10 + k)
    cov, xs = _cov(k, k + 2), rng.normal(size=k)
    mu = [0.3 - 0.1 * i for i in range(k)]
    got = [_f64(rt, rt.MVNormal(mu, cov).log_density_at(
        [rt.const(float(v)) for v in xs])) for rt in (rtt, rtj)]
    assert abs(got[0] - got[1]) <= 1e-10 * (1 + abs(got[1]))


def _latent_model(rt, k):
    """A correlated latent block under a likelihood that reads each
    element, so the gradient runs back through L."""
    lat = rt.MVNormal([0.5 * i for i in range(k)], _cov(k, 3)).latent_vec()
    ys = np.random.default_rng(4).normal(size=k)
    return rt.Model.likelihoods([rt.Normal(lat[i], 1.0).log_density([y])
                                 for i, y in enumerate(ys)])


@pytest.mark.parametrize("k", [3, 17])
def test_latent_vec_logp_and_grad_match_jax(k):
    """f32 through both compilers at 4 seeded points: lp within rtol 1e-5
    and gradients within 1e-5 of their largest entry (sums of k terms in
    other orders)."""
    cdt, cdj = _latent_model(rtt, k).density(), _latent_model(rtj, k).density()
    assert cdt.n_vars == cdj.n_vars == k
    f_t, f_j = cdt.logp_and_grad_fn(), cdj.logp_and_grad_fn()
    cols_t = cdt.column_values(torch.float32, "cpu")
    cols_j = cdj.column_values(jnp.float32)
    for q in np.random.default_rng(5).normal(size=(4, k)).astype(np.float32):
        lp_t, g_t = f_t(torch.as_tensor(q), cols_t)
        lp_j, g_j = f_j(jnp.asarray(q), cols_j)
        np.testing.assert_allclose(float(lp_t), float(lp_j), rtol=1e-5)
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0,
                                   atol=1e-5 * np.abs(g_j).max())


def test_latent_vec_prior_is_mvn():
    """tests/test_mvnormal.py:30-44 on the port's scan path: the
    prior-only model of the correlated block has the target moments."""
    lat = rtt.MVNormal([1.0, 2.0], COV).latent_vec()
    m = rtt.Model.track_(set(lat.to_list()))
    tr = m.sample(SamplerConfig(400, 1500, sampler=HMC(8)), n_chains=2,
                  seed=0, device="cpu")
    a = tr.evaluate(lat[0])
    b = tr.evaluate(lat[1])
    assert abs(a.mean() - 1.0) < 0.2
    assert abs(b.mean() - 2.0) < 0.2
    corr = np.corrcoef(a, b)[0, 1]
    want = COV[0, 1] / np.sqrt(COV[0, 0] * COV[1, 1])
    assert abs(corr - want) < 0.12


def test_generator_waits_for_its_port():
    """MVNormal.generator, once a placeholder that raised until the port
    of core/generator.py, now draws μ + L z: (N, k), the mean within 5
    standard errors (tests/test_torch_generator.py holds its covariance)."""
    from rainier_tpu_torch.core.generator import Env

    draws = rtt.MVNormal([1.0, -1.0], COV).generator().get(
        torch.Generator().manual_seed(0), Env(4000, device="cpu"))
    assert draws.shape == (4000, 2)
    se = np.sqrt(np.diag(COV) / 4000)
    assert np.all(np.abs(draws.double().mean(0).numpy() - [1.0, -1.0])
                  < 5 * se)
