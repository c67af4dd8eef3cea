"""NUTS in the PyTorch port against the JAX package.

``_build_subtree`` from the same start points, depth, signed step and h0
at 256 lanes, against ``jax.vmap`` of the JAX function, with diagonal and
dense mass: the outputs that do not depend on the random take (the end
point, log-weight, summed acceptance, leaves, turning and divergence
flags) agree, the flags and leaves on at least 99% of lanes and the
values within 1e-4 relative on those.  Then NUTS with dense mass on eight
schools against an independent quadrature of its posterior, at a small
budget (8 chains) with bars of 0.25 posterior SD.
"""

import numpy as np
import pytest

import jax
import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu.sampler.nuts import _build_subtree as build_subtree_j
from rainier_tpu.sampler.nuts import _Point as Point_j
from rainier_tpu.sampler.mass import MassState as MassState_j
from rainier_tpu.sampler.mass import kinetic as kinetic_j
from rainier_tpu_torch.sampler import NUTS, DenseMassMatrixTuner, SamplerConfig
from rainier_tpu_torch.sampler.nuts import _build_subtree, _Point, nuts_step
from rainier_tpu_torch.sampler.leapfrog import ChainState
from rainier_tpu_torch.sampler.mass import MassState, dense_mass, kinetic
from rainier_tpu_torch.sampler.stats import COUNTS

from test_torch_ehmc import densities, eight_schools, rel_ok

torch.set_num_threads(2)
rtt.config.set_device("cpu")

EIGHT_Y = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
EIGHT_SIGMA = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]


def quadrature(n_mu=451, n_tau=2001):
    """(mean, SD) of mu, tau and theta_1 of eight schools, in numpy f64:
    theta integrated out (y_i | mu, tau ~ N(mu, sigma_i² + tau²)), a grid
    over mu in [-40, 50] and tau in [0, 200] of N(mu; 0, 5²) ·
    half-Cauchy(tau; 5) · Π_i N(y_i; mu, sigma_i² + tau²); theta_1 | mu,
    tau is normal with the precision-weighted mean."""
    mu = np.linspace(-40.0, 50.0, n_mu)[:, None]
    tau = np.linspace(0.0, 200.0, n_tau)[None, :]
    y, s2 = np.asarray(EIGHT_Y), np.asarray(EIGHT_SIGMA) ** 2
    logp = -0.5 * (mu / 5.0) ** 2 - np.log1p((tau / 5.0) ** 2)
    for yi, si2 in zip(y, s2):
        v = si2 + tau ** 2
        logp = logp - 0.5 * np.log(v) - 0.5 * (yi - mu) ** 2 / v
    w = np.exp(logp - logp.max())
    w /= w.sum()

    def moments(mean, var=0.0):
        m = float(np.sum(w * mean))
        return m, float(np.sqrt(np.sum(w * ((mean - m) ** 2 + var))))

    t2 = tau ** 2
    return {"mu": moments(np.broadcast_to(mu, w.shape)),
            "tau": moments(np.broadcast_to(tau, w.shape)),
            "theta_1": moments((y[0] * t2 + mu * s2[0]) / (t2 + s2[0]),
                               t2 * s2[0] / (t2 + s2[0]))}


def masses(kind, rng, c, n):
    if kind == "diag":
        d = rng.uniform(0.5, 2.0, size=(c, n)).astype(np.float32)
        return MassState(diag=torch.as_tensor(d)), MassState_j(diag=d)
    a = rng.normal(size=(c, n, n))
    cov = (0.3 * a @ a.transpose(0, 2, 1) / n + np.eye(n)).astype(np.float32)
    m = dense_mass(torch.as_tensor(cov))
    return m, MassState_j(cov=cov, chol=m.chol.numpy())


@pytest.mark.parametrize("depth", [2, 5])
@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_build_subtree_matches_vmapped_jax(kind, depth):
    lpg_j, lpg_t = densities()
    rng = np.random.default_rng(10 + depth)
    c, n, max_depth = 256, 10, 6
    q = (0.5 * rng.normal(size=(c, n))).astype(np.float32)
    p = rng.normal(size=(c, n)).astype(np.float32)
    eps = np.exp(rng.uniform(np.log(0.01), np.log(0.6), size=c))
    # a few lanes at a step far past stability, which diverge
    eps[rng.uniform(size=c) < 0.05] = 5.0
    eps = (eps * rng.choice([-1.0, 1.0], size=c)).astype(np.float32)
    m_t, m_j = masses(kind, rng, c, n)
    lp, g = lpg_t(torch.as_tensor(q))
    pt = torch.as_tensor(p)
    h0 = (-lp + kinetic(m_t, pt)).detach()
    z0 = _Point(torch.as_tensor(q), pt, lp, g)
    got = _build_subtree(
        torch.Generator().manual_seed(0), z0, depth, torch.as_tensor(eps),
        m_t, lpg_t, h0, max_depth, torch.ones(c, dtype=torch.bool))

    def one(key, q, p, eps, mass):
        lp, g = lpg_j(q)
        h0 = -lp + kinetic_j(mass, p)
        return build_subtree_j(key, Point_j(q, p, lp, g), depth, eps, mass,
                               lpg_j, h0, max_depth)

    want = jax.jit(jax.vmap(one))(jax.random.split(jax.random.PRNGKey(0), c),
                                  q, p, eps, m_j)
    flags = np.ones(c, dtype=bool)
    for f in ("leaves", "turning", "divergent"):
        flags &= getattr(got, f).numpy() == np.asarray(getattr(want, f))
    assert flags.mean() >= 0.99, flags.mean()
    leaves = got.leaves.numpy()
    # the lanes cover every way a subtree ends
    assert np.any(got.turning.numpy()) and np.any(got.divergent.numpy())
    assert np.any(leaves == 2 ** depth)
    for a, b in ((got.z_end.q, want.z_end.q), (got.z_end.p, want.z_end.p),
                 (got.z_end.lp, want.z_end.lp),
                 (got.z_end.grad, want.z_end.grad),
                 (got.log_w, want.log_w), (got.sum_alpha, want.sum_alpha)):
        ok = rel_ok(a.numpy(), b)
        assert ok[flags].all(), np.flatnonzero(flags & ~ok)


def test_nuts_step_counts_its_leaves():
    """n_grads is every leaf a chain built, the depth histogram counts one
    tree a chain, and the accept statistic is a probability."""
    _, lpg_t = densities()
    c, n = 64, 10
    rng = np.random.default_rng(5)
    q = torch.as_tensor((0.5 * rng.normal(size=(c, n))).astype(np.float32))
    lp, g = lpg_t(q)
    COUNTS.reset()
    res, extra, n_grads = nuts_step(
        NUTS(max_depth=6), torch.Generator().manual_seed(1),
        ChainState(q, -lp, g), torch.full((c,), 0.3), MassState(), (),
        lpg_t)
    assert extra == () and n_grads.dtype == torch.int32
    assert COUNTS.iterations == 1 and int(COUNTS.depths.sum()) == c
    depths = np.repeat(np.arange(7), COUNTS.depths.numpy())
    # a chain that doubled d times built at most 2**d - 1 leaves
    assert int(n_grads.max()) <= 2 ** int(depths.max()) - 1
    assert COUNTS.steps >= int(n_grads.max())
    alpha = torch.exp(res.log_accept)
    assert torch.all((alpha >= 0) & (alpha <= 1))
    assert torch.isfinite(res.state.q).all() and torch.isfinite(
        res.energy).all()


def test_nuts_dense_mass_eight_schools_matches_quadrature():
    """At 8 chains × (300 + 300) the Monte-Carlo error of each mean is
    near 0.05 posterior SD; the bars are 0.25 SD for the means of mu, tau
    (evaluated, not its Cauchy coordinate) and theta_1, and 25% for the
    SDs of mu and tau."""
    quad = quadrature()
    model, mu, tau, theta1 = eight_schools(rtt)
    cfg = SamplerConfig(300, 300, sampler=NUTS(max_depth=8),
                        mass_matrix=DenseMassMatrixTuner())
    tr = model.sample(cfg, n_chains=8, seed=0)
    assert tr.chains.shape == (8, 300, 10) and np.all(np.isfinite(tr.chains))
    assert tr.mass.cov.shape == (8, 10, 10)
    for name, expr in (("mu", mu), ("tau", tau), ("theta_1", theta1)):
        v = tr.evaluate(expr)
        m, sd = quad[name]
        assert abs(np.mean(v) - m) < 0.25 * sd, (name, np.mean(v), m, sd)
        if name != "theta_1":
            assert abs(np.std(v) / sd - 1.0) < 0.25, (name, np.std(v), sd)
