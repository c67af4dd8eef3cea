"""Tempered SMC in the port (``rainier_tpu_torch/sampler/smc.py``), held
against the JAX package's ``rainier_tpu/sampler/smc.py``.

Checked here:

* ``_log_ess`` and ``_choose_delta`` on fixed log ratios against the JAX
  package's in f64, within 1e-12 relative (the 30 bisection steps take
  the same branches);
* the resampling comb given the JAX package's uniform: indices equal to
  ``systematic_resample``'s for the same key, on concentrated, uniform,
  periodic and random weights in f32;
* tests/test_smc.py's bars through the port: the conjugate posterior and
  its analytic evidence, the pseudo-chain Trace's r̂, and the standalone
  3-d density with its evidence; and ``Model.smc`` refuses a mesh that
  is not a ``DeviceMesh`` (tests/test_torch_parallel.py runs it on one).
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import rainier_tpu_torch as rtt
from rainier_tpu_torch.sampler.smc import SMCConfig

# the modules (each package's sampler/__init__ exports a function `smc`)
smc_j = importlib.import_module("rainier_tpu.sampler.smc")
smc_t = importlib.import_module("rainier_tpu_torch.sampler.smc")

torch.set_num_threads(2)
rtt.config.set_device("cpu")


@pytest.fixture
def jax_f64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _log_ratios():
    rng = np.random.default_rng(0)
    return [rng.normal(0.0, 1.0, 512), rng.normal(-40.0, 25.0, 512),
            np.concatenate([rng.normal(0, 1, 500), [200.0] * 12]),
            rng.standard_cauchy(1024)]


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("beta", [0.0, 0.37, 0.999])
def test_log_ess_and_choose_delta_match_jax(case, beta, jax_f64):
    lr = _log_ratios()[case]
    n = lr.size
    np.testing.assert_allclose(
        float(smc_t._log_ess(torch.as_tensor(lr))),
        float(smc_j._log_ess(jnp.asarray(lr))), rtol=1e-12)
    got = float(smc_t._choose_delta(torch.as_tensor(lr),
                                    torch.tensor(beta, dtype=torch.float64),
                                    0.5, n, 30))
    want = float(smc_j._choose_delta(jnp.asarray(lr), jnp.asarray(beta),
                                     0.5, n, 30))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def _weights():
    rng = np.random.default_rng(2)
    conc = np.full(64, -np.inf)
    conc[17] = 0.0
    return [conc, np.zeros(256),
            np.log(np.array([3.0, 1.0] * 32) / 128.0),
            rng.normal(0.0, 2.0, 1000)]


@pytest.mark.parametrize("case", range(4))
def test_comb_matches_jax_systematic_resample(case):
    log_w = _weights()[case].astype(np.float32)
    n = log_w.size
    for k in range(5):
        key = jax.random.PRNGKey(k)
        want = np.asarray(smc_j.systematic_resample(key, jnp.asarray(log_w),
                                                    n))
        u0 = float(jax.random.uniform(key, dtype=jnp.float32))
        got = smc_t.systematic_comb(torch.as_tensor(log_w),
                                    torch.tensor(u0), n).numpy()
        np.testing.assert_array_equal(got, want)
    gen = torch.Generator().manual_seed(0)
    idx = smc_t.systematic_resample(gen, torch.as_tensor(log_w), n)
    assert idx.shape == (n,) and int(idx.min()) >= 0 and int(idx.max()) < n


@pytest.fixture(scope="module")
def conjugate():
    rng = np.random.default_rng(3)
    ys = (1.5 + rng.normal(size=20)).tolist()
    mu = rtt.Normal(0, 1).latent()
    model = rtt.Model.observe(ys, rtt.Normal(mu, 1))
    n = len(ys)
    post_prec = 1.0 + n
    post_mean = float(np.sum(ys) / post_prec)
    y = np.array(ys)
    cov = np.eye(n) + np.ones((n, n))
    _, logdet = np.linalg.slogdet(cov)
    log_z = float(-0.5 * (y @ np.linalg.solve(cov, y))
                  - 0.5 * logdet - 0.5 * n * np.log(2 * np.pi))
    return model, post_mean, 1.0 / post_prec, log_z


def test_smc_conjugate_posterior_and_evidence(conjugate):
    """tests/test_smc.py:70-79's bars."""
    model, post_mean, post_var, log_z = conjugate
    trace, res = model.smc(SMCConfig(n_particles=2048, mutation_steps=3),
                           seed=0)
    draws = trace.flat()[:, 0]
    assert abs(draws.mean() - post_mean) < 0.05
    assert abs(draws.var() - post_var) < 0.02
    assert abs(float(res.log_evidence) - log_z) < 0.5
    assert int(res.n_stages) >= 2
    assert np.all(np.isfinite(draws))
    k = int(res.n_stages)
    assert float(res.betas[k - 1]) == pytest.approx(1.0)
    assert np.all(np.diff(res.betas[:k].numpy()) > 0)


def test_smc_trace_integration(conjugate):
    """tests/test_smc.py:82-88: 4 pseudo-chains with healthy r̂."""
    model, _, _, _ = conjugate
    trace, res = model.smc(SMCConfig(n_particles=1024), seed=4)
    assert trace.n_chains == 4 and trace.n_iterations == 256
    assert trace.diagnostics()[0].r_hat < 1.05
    assert int(res.n_stages) <= 100
    with pytest.raises(TypeError, match="DeviceMesh"):
        model.smc(SMCConfig(n_particles=64), mesh=object())


def test_run_smc_standalone_density():
    """tests/test_smc.py:91-104: any batched logp works; the evidence of
    exp(−½‖q‖²) is (3/2)·log 2π."""
    def logp(q):
        return -0.5 * torch.sum(q * q, dim=-1)

    res = smc_t.run_smc(logp, 3, SMCConfig(n_particles=1024,
                                           mutation_steps=2), seed=1)
    q = res.particles.numpy()
    assert abs(q.mean()) < 0.1
    assert abs(q.var() - 1.0) < 0.15
    assert abs(float(res.log_evidence) - 1.5 * np.log(2 * np.pi)) < 0.2
