"""Dense mass and its Cholesky helpers in the PyTorch port against the JAX
package.

Deterministic pieces on the same seeded inputs, within 1e-5 relative in
f32: every function of ``compute/cholesky.py``, Welford with ``cov_raw``,
``mass_from_welford("dense")`` with its shrinkage, and the dense
``velocity``, ``kinetic`` and momentum from a given z.  Then the
configurations that use them through the sampler: the 2-D ρ = 0.9
Gaussian of tests/test_sampler.py:81-108 under ``DenseMassMatrixTuner``
and HMC(8), and ``Model.sample`` with each mass and sampler the JAX
package accepts on one device.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import rainier_tpu_torch as rtt
from rainier_tpu.compute import cholesky as chol_j
from rainier_tpu.sampler import mass as mass_j
from rainier_tpu_torch.compute import cholesky as chol_t
from rainier_tpu_torch.sampler import (EHMC, HMC, NUTS, DenseMassMatrixTuner,
                                       SamplerConfig, StaticMassMatrix)
from rainier_tpu_torch.sampler import mass as mass_t
from rainier_tpu_torch.sampler.driver import run_sampling, run_warmup

torch.set_num_threads(2)
rtt.config.set_device("cpu")

RTOL = 1e-5


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def spd(rng, c, n):
    """(c, n, n) well-conditioned SPD matrices."""
    a = rng.normal(size=(c, n, n))
    return (a @ a.transpose(0, 2, 1) / n + np.eye(n)).astype(np.float32)


def test_packed_sizes_match_jax():
    for n in range(1, 12):
        assert chol_t.packed_size(n) == chol_j.packed_size(n)
        assert chol_t.matrix_size(chol_t.packed_size(n)) == n
    with pytest.raises(ValueError):
        chol_t.matrix_size(5)


def test_cholesky_helpers_match_jax():
    rng = np.random.default_rng(0)
    c, n = 6, 5
    a = spd(rng, c, n)
    b = rng.normal(size=(c, n)).astype(np.float32)
    at = torch.as_tensor(a)
    L_t = chol_t.cholesky_lower(at)
    L_j = np.asarray(chol_j.cholesky_lower(jnp.asarray(a)))
    close(L_t, L_j)
    packed_t = chol_t.pack_lower(L_t)
    packed_j = np.asarray(chol_j.pack_lower(jnp.asarray(L_j)))
    close(packed_t, packed_j)
    close(chol_t.unpack_lower(packed_t, n),
          chol_j.unpack_lower(jnp.asarray(packed_j), n))
    Lb = torch.as_tensor(b)
    close(chol_t.lower_triangular_solve(L_t, Lb),
          jax.vmap(chol_j.lower_triangular_solve)(jnp.asarray(L_j), b))
    U = L_t.transpose(-1, -2)
    close(chol_t.upper_triangular_solve(U, Lb),
          jax.vmap(chol_j.upper_triangular_solve)(
              jnp.asarray(L_j).transpose(0, 2, 1), b))
    close(chol_t.inverse_multiply(packed_t, Lb),
          jax.vmap(chol_j.inverse_multiply)(jnp.asarray(packed_j), b))
    # the JAX function sums every leading entry: compare one matrix a call
    for k in range(c):
        close(chol_t.log_determinant(packed_t[k]),
              chol_j.log_determinant(jnp.asarray(packed_j[k])))
    close(chol_t.log_determinant(packed_t),
          [np.linalg.slogdet(x.astype(np.float64))[1] for x in a], rtol=1e-4)


def test_cholesky_of_an_indefinite_matrix_is_nan_not_an_error():
    bad = torch.tensor([[[1.0, 2.0], [2.0, 1.0]], [[2.0, 0.0], [0.0, 2.0]]])
    L = chol_t.cholesky_lower(bad)
    assert torch.isfinite(L[1]).all()
    np.testing.assert_array_equal(L[0].numpy(), np.asarray(
        chol_j.cholesky_lower(jnp.asarray(bad[0].numpy()))))


def test_dense_welford_and_mass_match_jax():
    rng = np.random.default_rng(1)
    c, n, steps = 4, 6, 37
    xs = (rng.normal(size=(steps, c, n)) * [1, 2, 3, 0.5, 1, 4]).astype(
        np.float32)
    w_t = mass_t.welford_init((c, n), torch.float32, "cpu", dense=True)
    w_j = jax.vmap(lambda _: mass_j.welford_init(n, jnp.float32,
                                                 dense=True))(jnp.arange(c))
    upd = jax.vmap(mass_j.welford_update)
    for x in xs:
        w_t = mass_t.welford_update(w_t, torch.as_tensor(x))
        w_j = upd(w_j, jnp.asarray(x))
    close(w_t.mean, w_j.mean)
    close(w_t.raw, w_j.raw)
    close(w_t.cov_raw, w_j.cov_raw)
    close(mass_t.welford_covariance(w_t),
          jax.vmap(mass_j.welford_covariance)(w_j))
    m_t = mass_t.mass_from_welford(w_t, "dense")
    m_j = jax.vmap(lambda w: mass_j.mass_from_welford(w, "dense"))(w_j)
    close(m_t.cov, m_j.cov)
    close(m_t.chol, m_j.chol)
    assert m_t.diag is None and m_j.diag is None

    p = rng.normal(size=(c, n)).astype(np.float32)
    z = rng.normal(size=(c, n)).astype(np.float32)
    pt, zt = torch.as_tensor(p), torch.as_tensor(z)
    close(mass_t.velocity(m_t, pt), jax.vmap(mass_j.velocity)(m_j, p))
    close(mass_t.kinetic(m_t, pt), jax.vmap(mass_j.kinetic)(m_j, p))
    # p = L⁻ᵀz, the JAX package's sample_momentum after its normal draw
    want = jax.vmap(lambda L, zz: jax.scipy.linalg.solve_triangular(
        L.T, zz, lower=False))(m_j.chol, z)
    close(mass_t.momentum_from_normal(m_t, zt), want)
    # and its covariance is Σ̂⁻¹
    one = mass_t.MassState(cov=m_t.cov[:1].expand(20000, n, n),
                           chol=m_t.chol[:1].expand(20000, n, n))
    draws = mass_t.sample_momentum(one, torch.Generator().manual_seed(0),
                                   (20000, n), torch.float32, "cpu")
    prec = np.linalg.inv(m_t.cov[0].double().numpy())
    np.testing.assert_allclose(np.cov(draws.numpy().T), prec,
                               atol=0.05 * np.abs(prec).max())


def test_dense_mass_on_correlated_gaussian():
    """tests/test_sampler.py:81-108 on the port's sampler: the adapted
    dense Σ̂ captures ρ = 0.9, and the draws have unit scale."""
    rho = 0.9
    prec = torch.as_tensor(np.linalg.inv([[1.0, rho], [rho, 1.0]]),
                           dtype=torch.float32)

    def lpg(q):
        g = -q @ prec
        return 0.5 * torch.sum(q * g, dim=-1), g

    cfg = SamplerConfig(warmup_iterations=800, iterations=1500,
                        sampler=HMC(8), mass_matrix=DenseMassMatrixTuner())
    gen = torch.Generator().manual_seed(0)
    wp = run_warmup(lpg, 2, cfg, 2, gen, torch.float32, "cpu")
    samples, stats, _ = run_sampling(lpg, cfg, wp, gen)
    qs = samples.reshape(-1, 2).numpy()
    assert np.all(np.isfinite(qs))
    assert np.all(np.abs(qs.mean(axis=0)) < 0.3)
    assert np.all(np.abs(qs.var(axis=0) - 1.0) < 0.5), qs.var(axis=0)
    emp = np.cov(qs.T)
    assert abs(emp[0, 1] / np.sqrt(emp[0, 0] * emp[1, 1]) - rho) < 0.1
    cov = wp.mass.cov[0].numpy()
    assert wp.mass.cov.shape == (2, 2, 2)
    assert abs(cov[0, 1] / np.sqrt(cov[0, 0] * cov[1, 1]) - rho) < 0.25


def normal_observe(rt):
    data = list(np.random.default_rng(3).normal(1.5, 2.0, size=64))
    mu = rt.Normal(0, 10).latent()
    return rt.Model.observe(data, rt.Normal(mu, rt.Exponential(0.5).latent()))


@pytest.mark.parametrize("cfg", [
    SamplerConfig(30, 20),
    SamplerConfig(30, 20, sampler=NUTS(max_depth=5)),
    SamplerConfig(30, 20, sampler=EHMC(max_steps=32, synchronized=False)),
    SamplerConfig(30, 20, sampler=HMC(3),
                  mass_matrix=DenseMassMatrixTuner(10, 1.5, 5, 5)),
    SamplerConfig(30, 20, sampler=NUTS(max_depth=5),
                  mass_matrix=StaticMassMatrix(cov=[[1.0, 0.3], [0.3, 2.0]])),
    SamplerConfig(30, 20, mass_matrix=DenseMassMatrixTuner(10, 1.5, 5, 5),
                  pooled_adaptation=True),
], ids=["default-ehmc", "nuts", "ehmc-per-chain", "hmc-dense-tuner",
        "nuts-static-cov", "ehmc-dense-pooled"])
def test_every_single_device_config_samples(cfg):
    tr = normal_observe(rtt).sample(cfg, n_chains=3, seed=2)
    assert tr.chains.shape == (3, 20, 2) and np.all(np.isfinite(tr.chains))
    assert tr.stats.grad_evals.shape == (3,)
    assert tr.stats.grad_evals.dtype == np.int32
    assert np.all(tr.stats.grad_evals >= 20)
    if isinstance(cfg.mass_matrix, (DenseMassMatrixTuner, StaticMassMatrix)):
        assert tr.mass.cov.shape == (3, 2, 2) and tr.mass.diag is None
        assert tr.mass.chol.shape == (3, 2, 2)
        if cfg.pooled_adaptation:
            np.testing.assert_array_equal(tr.mass.cov, tr.mass.cov[:1].repeat(
                3, axis=0))
    if isinstance(cfg.mass_matrix, StaticMassMatrix):
        np.testing.assert_allclose(tr.mass.cov[0], [[1.0, 0.3], [0.3, 2.0]],
                                   rtol=1e-6)
