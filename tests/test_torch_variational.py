"""ADVI and auto_vip in the port (``rainier_tpu_torch/variational.py``,
``core/reparam.py::auto_vip``), held against the JAX package's
``rainier_tpu/variational.py`` and ``core/reparam.py``.

Checked here:

* the optimizer: ``variational.adam`` against ``optax.adam`` on 50 fixed
  gradients in f32, within 1e-5 absolute after each step: the two order
  the f32 operations of an update differently (torch divides by
  sqrt(v)/sqrt(1 − b2ᵗ) + eps and scales by lr/(1 − b1ᵗ), optax forms the
  bias-corrected moments first), a few ulps of parameters up to 1.4 a
  step, over 50 steps;
* the objective: ``neg_elbo_and_grad`` at fixed parameters and fixed
  draws against ``jax.value_and_grad`` of the JAX package's neg_elbo
  (variational.py:84-95, entropy without its constant) in f32, mean-field
  and full-rank, within 1e-5 relative;
* tests/test_variational.py's two fits under its bars;
* ``auto_vip`` on tests/test_reparam.py:101-113's funnel: lam 0.0, as
  the JAX package picks, every ELBO finite, and each within 2 nats of
  the JAX package's (the ELBO is a Monte-Carlo estimate from other
  draws);
* ``interop.variational_posterior_from_numpy``: the JAX fit's q carried
  over gives the same mean and, by its draws, the same scale within
  Monte-Carlo error.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu.core.reparam import auto_vip as auto_vip_j
from rainier_tpu.variational import advi as advi_j
from rainier_tpu_torch import interop, variational as vt

torch.set_num_threads(2)
rtt.config.set_device("cpu")


def test_adam_matches_optax():
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=7).astype(np.float32)
    grads = rng.normal(size=(50, 7)).astype(np.float32)
    pt = torch.as_tensor(p0.copy())
    opt = vt.adam([pt], 0.05)
    tx = optax.adam(0.05)
    pj = jnp.asarray(p0)
    state = tx.init(pj)
    for g in grads:
        pt.grad = torch.as_tensor(g)
        opt.step()
        upd, state = tx.update(jnp.asarray(g), state)
        pj = optax.apply_updates(pj, upd)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                                   atol=1e-5)
    assert np.max(np.abs(pt.numpy() - p0)) > 0.5


def normal_model(rt, n=300):
    data = np.random.default_rng(3).normal(2.0, 1.5, size=n)
    mu = rt.Normal(0, 10).latent()
    sigma = rt.Exponential(1.0).latent()
    return rt.Model.observe(list(data), rt.Normal(mu, sigma)), mu, sigma, data


def _neg_elbo_j(cd, p, eps, full_rank):
    """rainier_tpu/variational.py:61-95's neg_elbo at fixed draws."""
    cols = cd.column_values(jnp.float32)
    lp = cd.logp_fn()

    def draw_and_entropy(p, e):
        if full_rank:
            L = jnp.tril(p["l_off"], -1) + jnp.diag(jnp.exp(p["l_diag"]))
            return p["mu"] + L @ e, jnp.sum(p["l_diag"])
        return p["mu"] + jnp.exp(p["log_sigma"]) * e, jnp.sum(p["log_sigma"])

    def one(p, e):
        z, ent = draw_and_entropy(p, e)
        return lp(z, cols) + ent

    return -jnp.mean(jax.vmap(lambda e: one(p, e))(eps))


@pytest.mark.parametrize("full_rank", [False, True],
                         ids=["mean_field", "full_rank"])
def test_neg_elbo_and_grad_match_jax(full_rank):
    (mt, *_), (mj, *_) = normal_model(rtt, 40), normal_model(rtj, 40)
    cdt, cdj = mt.density(), mj.density()
    rng = np.random.default_rng(1)
    n = cdt.n_vars
    p = {"mu": rng.normal(0.5, 0.3, n)}
    if full_rank:
        p["l_off"] = 0.2 * rng.normal(size=(n, n))
        p["l_diag"] = rng.normal(-1.0, 0.2, n)
    else:
        p["log_sigma"] = rng.normal(-1.0, 0.2, n)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    eps = rng.normal(size=(8, n)).astype(np.float32)
    loss_j, g_j = jax.value_and_grad(
        lambda pp, e: _neg_elbo_j(cdj, pp, e, full_rank))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(eps))
    raw = cdt.batched_logp_and_grad_fn()
    cols = cdt.column_values(torch.float32, "cpu")
    loss_t, g_t = vt.neg_elbo_and_grad(
        lambda z: raw(z, cols), {k: torch.as_tensor(v) for k, v in p.items()},
        torch.as_tensor(eps))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert set(g_t) == set(g_j)
    for k in g_t:
        want = np.asarray(g_j[k])
        np.testing.assert_allclose(g_t[k].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_advi_mean_field_recovers_posterior():
    """tests/test_variational.py:9-18 through the port, its bars."""
    m, mu, sigma, data = normal_model(rtt)
    vp = rtt.advi(m, n_steps=1200, learning_rate=0.05, seed=0)
    assert abs(vp.mean(mu) - data.mean()) < 0.15
    assert abs(vp.mean(sigma) - data.std()) < 0.2
    assert vp.elbo_trace[-1] > vp.elbo_trace[0]
    # the loss every 50 steps and at the last
    assert len(vp.elbo_trace) == 1200 // 50 + 1


def test_advi_full_rank_captures_correlation():
    """tests/test_variational.py:21-33 through the port, its bars."""
    data = np.random.default_rng(1).normal(1.0, 0.5, size=50)
    a = rtt.Normal(0, 2).latent()
    b = rtt.Normal(0, 2).latent()
    m = rtt.Model.observe(list(data), rtt.Normal(a + b, 0.5))
    vp = rtt.advi(m, n_steps=1500, full_rank=True, seed=0)
    draws = vp.sample(4000)
    corr = np.corrcoef(draws[:, 0], draws[:, 1])[0, 1]
    assert corr < -0.5, corr
    s = vp.evaluate(a + b, n_draws=2000)
    assert abs(np.mean(s) - 1.0) < 0.2


def funnel_build(rt):
    def build(lam):
        log_tau = rt.Normal(0.0, 3.0).latent()
        thetas = rt.vip_latent_vec(0.0, log_tau.exp(), 4, lam=lam)
        return rt.Model.track_([log_tau] + [thetas[i] for i in range(4)])
    return build


def test_auto_vip_picks_noncentred_on_funnel_as_jax():
    got = rtt.auto_vip(funnel_build(rtt), candidates=(0.0, 1.0),
                       n_steps=400, seed=0)
    want = auto_vip_j(funnel_build(rtj), candidates=(0.0, 1.0), n_steps=400,
                      seed=0)
    assert got.lam == want.lam == 0.0, (got, want)
    assert all(np.isfinite(got.elbos))
    np.testing.assert_allclose(got.elbos, want.elbos, atol=2.0)
    assert "lam=0.0" in repr(got)


@pytest.mark.parametrize("full_rank", [False, True],
                         ids=["mean_field", "full_rank"])
def test_interop_carries_the_jax_fit(full_rank):
    """The JAX fit's q in the port: mu equal, and 20,000 of the port's
    draws with the JAX fit's mean and covariance within 5 Monte-Carlo
    SE; ``mean`` of sigma against the JAX fit's by the same bound."""
    mj, _, sigma_j, _ = normal_model(rtj)
    vj = advi_j(mj, n_steps=300, learning_rate=0.05, full_rank=full_rank,
                seed=0)
    mt, _, sigma_t, _ = normal_model(rtt)
    vt_ = interop.variational_posterior_from_numpy(
        np.asarray(vj.mu), None if full_rank else np.asarray(vj.log_sigma),
        np.asarray(vj.chol) if full_rank else None, model=mt,
        elbo_trace=vj.elbo_trace)
    np.testing.assert_array_equal(vt_.mu.numpy(), np.asarray(vj.mu))
    cov = (np.asarray(vj.chol) @ np.asarray(vj.chol).T if full_rank
           else np.diag(np.exp(2 * np.asarray(vj.log_sigma))))
    n = 20_000
    draws = vt_.sample(n, seed=1).astype(np.float64)
    sd = np.sqrt(np.diag(cov))
    assert np.all(np.abs(draws.mean(0) - np.asarray(vj.mu))
                  < 5 * sd / np.sqrt(n))
    assert np.all(np.abs(draws.var(0) / np.diag(cov) - 1) < 5 * np.sqrt(2 / n))
    st, sj = vt_.evaluate(sigma_t, n), np.asarray(vj.evaluate(sigma_j, n))
    assert abs(st.mean() - sj.mean()) < 5 * np.sqrt(
        (st.var() + sj.var()) / n)
