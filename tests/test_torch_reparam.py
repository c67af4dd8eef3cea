"""VIP latents in the port (``rainier_tpu_torch/core/reparam.py``), held
against the JAX package's ``rainier_tpu/core/reparam.py``.

Every model is built through both packages by one ``build(rt, ...)`` and
evaluated at the same numpy-seeded points in f32.  Checked here:

* ``vip_latent`` and ``vip_latent_vec`` at lam 0, 0.5 and 1, for Normal,
  Cauchy and Laplace: logp and gradient against ``jax.value_and_grad``;
* the σ >= 0 and 0 <= λ <= 1 checks, and the location-scale family
  check, raise as in the JAX package;
* lam 0 has the density of ``Normal(mu, s).latent_vec(k)``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu.compute import real as Rj
from rainier_tpu_torch.compute import real as Rt

torch.set_num_threads(2)
rtt.config.set_device("cpu")

K = 6


def _R(rt):
    return Rj if rt is rtj else Rt


def _family(rt, name):
    return {"normal": rt.Normal, "cauchy": rt.Cauchy,
            "laplace": rt.Laplace}[name]


def vip_model(rt, lam, family, vec):
    """A hierarchy whose group effects are VIP latents at weight `lam`:
    mu ~ N(0, 1), s ~ Exp(1), effects ~ family(mu, s), observed through a
    Normal likelihood of 3 rows per effect, gathered by an IntColumn (the
    shape of benchmarks/models.py::glmm_large)."""
    R = _R(rt)
    fam = _family(rt, family)
    mu = rt.Normal(0, 1).latent()
    s = rt.Exponential(1.0).latent()
    y = np.random.default_rng(3).normal(0.5, 1.0, size=3 * K)
    if vec:
        effects = rt.vip_latent_vec(mu, s, K, lam=lam, family=fam)
        mean = R.Gather(effects.element, R.IntColumn(np.repeat(
            np.arange(K), 3)))
        return rt.Model.likelihood(R.RowSum(
            rt.Normal(mean, 0.7).log_density_at(R.Column(y)), 3 * K))
    effects = [rt.vip_latent(mu, s, lam=lam, family=fam) for _ in range(K)]
    return rt.Model.likelihoods([
        rt.Normal(e, 0.7).log_density(list(y[3 * i:3 * i + 3]))
        for i, e in enumerate(effects)])


@pytest.mark.parametrize("vec", [False, True], ids=["scalar", "vec"])
@pytest.mark.parametrize("family", ["normal", "cauchy", "laplace"])
@pytest.mark.parametrize("lam", [0.0, 0.5, 1.0])
def test_vip_matches_jax(lam, family, vec):
    """logp and gradient at 4 seeded points against jax.value_and_grad of
    the JAX package's model: the same f32 terms (at most 18 rows and 8
    priors) summed in other orders, so rtol 1e-5 / atol 1e-5·(1 + |lp|)
    and gradients within 1e-5 of max |g|."""
    cdt = vip_model(rtt, lam, family, vec).density()
    cdj = vip_model(rtj, lam, family, vec).density()
    assert cdt.n_vars == cdj.n_vars == K + 2
    q = (np.random.default_rng(1).normal(size=(4, cdt.n_vars)) * 0.5
         ).astype(np.float32)
    lp_t, g_t = cdt.batched_logp_and_grad_fn()(
        torch.as_tensor(q), cdt.column_values(torch.float32, "cpu"))
    lp_j, g_j = jax.vmap(jax.value_and_grad(cdj.logp_fn()),
                         in_axes=(0, None))(jnp.asarray(q),
                                            cdj.column_values(jnp.float32))
    lp_j, g_j = np.asarray(lp_j), np.asarray(g_j)
    np.testing.assert_allclose(lp_t.numpy(), lp_j, rtol=1e-5,
                               atol=1e-5 * (1 + np.abs(lp_j).max()))
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0,
                               atol=1e-5 * np.abs(g_j).max())


@pytest.mark.parametrize("args,kw,err", [
    ((0.0, -1.0), {}, ValueError),             # σ < 0
    ((0.0, 1.0), {"lam": 1.5}, ValueError),    # λ > 1
    ((0.0, 1.0), {"lam": -0.1}, ValueError),   # λ < 0
    ((0.0, 1.0), {"family": "exponential"}, TypeError),
])
@pytest.mark.parametrize("vec", [False, True], ids=["scalar", "vec"])
def test_vip_checks_raise_as_in_jax(args, kw, err, vec):
    for rt in (rtt, rtj):
        kwargs = dict(kw)
        if kwargs.get("family") == "exponential":
            kwargs["family"] = rt.Exponential(1.0)
        with pytest.raises(err):
            if vec:
                rt.vip_latent_vec(*args, 3, **kwargs)
            else:
                rt.vip_latent(*args, **kwargs)


def test_lam_zero_is_the_non_centred_latent_vec():
    """vip_latent_vec(mu, s, k, lam=0) has the density and gradient of
    Normal(mu, s).latent_vec(k) (raw ~ N(0, 1), x = mu + s·raw): the same
    f32 operations up to the order of two folded constants, so within
    1e-6 relative."""
    def build(vip):
        mu = rtt.Normal(0, 1).latent()
        s = rtt.Exponential(1.0).latent()
        x = (rtt.vip_latent_vec(mu, s, K, lam=0.0) if vip
             else rtt.Normal(mu, s).latent_vec(K))
        y = np.random.default_rng(5).normal(size=K)
        return rtt.Model.likelihood(Rt.RowSum(rtt.Normal(
            Rt.Gather(x.element, Rt.IntColumn(np.arange(K))), 1.0)
            .log_density_at(Rt.Column(y)), K))

    a, b = build(True).density(), build(False).density()
    q = torch.as_tensor(np.random.default_rng(2).normal(size=(5, K + 2)),
                        dtype=torch.float32)
    lp_a, g_a = a.batched_logp_and_grad_fn()(q, a.column_values())
    lp_b, g_b = b.batched_logp_and_grad_fn()(q, b.column_values())
    torch.testing.assert_close(lp_a, lp_b, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(g_a, g_b, rtol=1e-6, atol=1e-6)
