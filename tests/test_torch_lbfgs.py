"""L-BFGS MAP in the port (``rainier_tpu_torch/optimizer/lbfgs.py``),
held against the JAX package's ``rainier_tpu/optimizer/lbfgs.py``.

Checked here, in float64 on both sides unless said otherwise:

* ``_two_loop`` on fixed histories, at several ring positions at once
  (one start a row): within 1e-12 relative;
* ``_wolfe_line_search`` and ``minimize`` on Rosenbrock (4-d), a 10-d
  quadratic of condition number 100 and the README regression's negative
  log density (the port's, for both): the same step or iteration count and flags, x and f within
  1e-9 relative.  These functions never exhaust the zoom
  (``COUNTS.fallbacks`` is 0), where the two packages differ (C2.5);
* ``Model.optimize`` on tests/test_sampler.py:187-193's model in f32,
  within 1e-4 of the JAX package's;
* batched starts: a start that stopped keeps its state while the others
  go on;
* ROADMAP C2.5: on a function with a kink the zoom runs out; both
  packages fall back to the same point ``lo``, and the port returns the
  gradient there where the JAX package returns the start's.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu.optimizer import lbfgs as lbj
from rainier_tpu_torch.optimizer import lbfgs as lbt

torch.set_num_threads(2)
rtt.config.set_device("cpu")

REL = 1e-9


@pytest.fixture
def jax_f64():
    jax.config.update("jax_enable_x64", True)
    rtj.config.set_dtype(jnp.float64)
    yield
    rtj.config.set_dtype(jnp.float32)
    jax.config.update("jax_enable_x64", False)


def _tensor(x):
    return torch.as_tensor(np.array(x))


def _close(a, b, rel, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0))
    assert err <= rel, (what, err, a, b)


def test_two_loop_matches_jax(jax_f64):
    """Ring positions k = 0, 2, 5, 7, 11 with m = 5, one start a row of
    the port's batch, each against the JAX package's single state."""
    rng = np.random.default_rng(0)
    m, n, ks = 5, 6, [0, 2, 5, 7, 11]
    B = len(ks)
    s = rng.normal(size=(B, m, n))
    y = s + 0.3 * rng.normal(size=(B, m, n))
    rho = 1.0 / np.einsum("bmn,bmn->bm", s, y)
    g = rng.normal(size=(B, n))
    t = torch.as_tensor
    st = lbt.LBFGSState(
        x=t(np.zeros((B, n))), f=t(np.zeros(B)), g=t(g), s_hist=t(s),
        y_hist=t(y), rho=t(rho), k=t(np.array(ks)),
        converged=t(np.zeros(B, bool)), failed=t(np.zeros(B, bool)))
    got = lbt._two_loop(st).numpy()
    for b, k in enumerate(ks):
        sj = lbj.LBFGSState(
            x=jnp.zeros(n), f=jnp.zeros(()), g=jnp.asarray(g[b]),
            s_hist=jnp.asarray(s[b]), y_hist=jnp.asarray(y[b]),
            rho=jnp.asarray(rho[b]), k=jnp.asarray(k, jnp.int32),
            converged=jnp.asarray(False), failed=jnp.asarray(False))
        _close(got[b], lbj._two_loop(sj), 1e-12, ("two loop", k))


# -- test functions: (name, jax f, port batched f, x0) -----------------------


def rosenbrock_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def rosenbrock_t(x):
    return torch.sum(100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2
                     + (1.0 - x[:, :-1]) ** 2, dim=-1)


def _quadratic():
    rng = np.random.default_rng(1)
    q, _ = np.linalg.qr(rng.normal(size=(10, 10)))
    a = q @ np.diag(np.logspace(0, 2, 10)) @ q.T
    return a, rng.normal(size=10)


def quadratic_j(x):
    a, b = _quadratic()
    return 0.5 * x @ jnp.asarray(a) @ x - jnp.asarray(b) @ x


def quadratic_t(x):
    a, b = (torch.as_tensor(v) for v in _quadratic())
    return 0.5 * torch.sum((x @ a) * x, dim=-1) - x @ b


def readme(rt):
    """The README regression (benchmarks/models.py:30-41) at 60 rows."""
    rng = np.random.default_rng(0)
    xs = [tuple(r) for r in rng.normal(size=(60, 3))]
    ys = [float(np.dot(x, [1.0, -2.0, 0.5]) + 0.7 + 0.3 * rng.normal())
          for x in xs]
    sigma = rt.Exponential(1).latent()
    alpha = rt.Normal(0, 1).latent()
    betas = rt.Normal(0, 1).latent_vec(3)
    return rt.Model.observe(ys, rt.Vec.from_(xs).map(
        lambda t: rt.Normal(alpha + rt.Vec.of(*t).dot(betas), sigma)))


def _fg_j(f):
    vg = jax.value_and_grad(f)
    return vg


def _fg_t(f):
    def fg(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            v = f(x)
            (g,) = torch.autograd.grad(v.sum(), x)
        return v.detach(), g
    return fg


def _readme_fgs():
    """The port's README density in f64, for both optimizers: the JAX
    side calls it through ``jax.pure_callback``.  (The JAX package's own
    f64 README density moves by up to 4e-6 in a gradient coordinate
    between its jitted and eager forms, more than REL allows; the two
    packages' densities are held to each other in
    tests/test_torch_density.py.)"""
    cdt = readme(rtt).density()
    cols = cdt.column_values(torch.float64, "cpu")
    lpt = cdt.batched_logp_and_grad_fn()

    def fgt(x):
        lp, g = lpt(x, cols)
        return -lp, -g

    def host(x):
        f, g = fgt(torch.as_tensor(np.array(x))[None])
        return f[0].numpy(), g[0].numpy()

    n = cdt.n_vars

    def fgj(x):
        return jax.pure_callback(
            host, (jax.ShapeDtypeStruct((), jnp.float64),
                   jax.ShapeDtypeStruct((n,), jnp.float64)), x)
    return fgj, fgt, n


def _functions():
    fgj_r, fgt_r, n_r = _readme_fgs()
    return {"rosenbrock": (_fg_j(rosenbrock_j), _fg_t(rosenbrock_t),
                           np.array([-1.2, 1.0, -0.5, 0.8])),
            "quadratic": (_fg_j(quadratic_j), _fg_t(quadratic_t),
                          np.linspace(-2.0, 2.0, 10)),
            "readme": (fgj_r, fgt_r, np.zeros(n_r))}


@pytest.mark.parametrize("name", ["rosenbrock", "quadratic", "readme"])
def test_line_search_matches_jax(name, jax_f64):
    """The first search from x0 along −g: alpha, f and g equal within
    REL, both ok."""
    fgj, fgt, x0 = _functions()[name]
    f0, g0 = fgj(jnp.asarray(x0))
    d = -g0
    aj, fj, gj, okj = jax.jit(lambda x, f, g, dd: lbj._wolfe_line_search(
        fgj, x, f, g, dd))(jnp.asarray(x0), f0, g0, d)
    t = _tensor
    lbt.COUNTS.reset()
    at, ft, gt, okt = lbt._wolfe_line_search(
        fgt, t(x0)[None], t(f0)[None], t(g0)[None], t(d)[None])
    assert lbt.COUNTS.fallbacks == 0
    assert bool(okt[0]) == bool(okj) is True
    _close(at[0], aj, REL, "alpha")
    _close(ft[0], fj, REL, "f")
    _close(gt[0], gj, REL, "g")


@pytest.mark.parametrize("name", ["rosenbrock", "quadratic", "readme"])
def test_minimize_matches_jax(name, jax_f64):
    """minimize from x0: the same iteration count and flags, x and f
    within REL."""
    fgj, fgt, x0 = _functions()[name]
    sj = jax.jit(lambda x: lbj.minimize(fgj, x, max_iters=200))(
        jnp.asarray(x0))
    lbt.COUNTS.reset()
    st = lbt.minimize(fgt, torch.as_tensor(x0)[None], max_iters=200)
    assert lbt.COUNTS.fallbacks == 0
    assert int(st.k[0]) == int(sj.k), (int(st.k[0]), int(sj.k))
    assert bool(st.converged[0]) == bool(sj.converged) is True
    assert bool(st.failed[0]) == bool(sj.failed)
    _close(st.x[0], sj.x, REL, "x")
    _close(st.f[0], sj.f, REL, "f")


def test_optimize_map_matches_jax():
    """tests/test_sampler.py:187-193 in both packages at the default f32:
    the MAP of mu within 1e-4 of JAX's and of the data mean within the
    reference test's 0.05."""
    def build(rt):
        data = np.random.default_rng(5).normal(3.0, 1.0, size=500)
        mu = rt.Normal(0, 100).latent()
        return rt.Model.observe(list(data), rt.Normal(mu, 1.0)), mu, data

    mt, mut, data = build(rtt)
    mj, muj, _ = build(rtj)
    got, want = float(mt.optimize(mut)), float(mj.optimize(muj))
    assert abs(got - want) < 1e-4, (got, want)
    assert abs(got - data.mean()) < 0.05
    # the flat vector, and several starts (the origin first)
    x = mt.optimize(n_starts=4, seed=2)
    assert x.shape == (1,) and abs(float(x[0]) * 100 - got) < 1e-4
    assert lbt.COUNTS.last.x.shape == (4, 1)


def test_stopped_start_does_not_move(jax_f64):
    """Three starts on the quadratic, one at the optimum's doorstep: it
    stops first, and its state after the others' further iterations is
    what it was when it stopped, bit for bit."""
    _, fgt, x0 = _functions()["quadratic"]
    a, b = _quadratic()
    xs = np.linalg.solve(a, b)
    starts = torch.as_tensor(np.stack([xs + 1e-9, x0, -x0]))
    full = lbt.minimize(fgt, starts, max_iters=200)
    k0 = int(full.k[0])
    assert bool(full.converged.all())
    assert k0 < int(full.k[1:].min()), full.k
    at_stop = lbt.minimize(fgt, starts, max_iters=k0)
    assert int(at_stop.k[0]) == k0 and bool(at_stop.converged[0])
    for f_full, f_stop in zip(full, at_stop):
        assert torch.equal(f_full[0], f_stop[0])
    assert not torch.equal(full.x[1], at_stop.x[1])


def kink_j(x):
    return 10.0 * jnp.abs(x[0] - 0.3) + 0.5 * x[1] ** 2


def kink_t(x):
    return 10.0 * torch.abs(x[:, 0] - 0.3) + 0.5 * x[:, 1] ** 2


def test_c2_5_zoom_fallback_returns_the_gradient_at_lo(jax_f64):
    """From (0, 1) along −g = (10, −1) the kink at x₀ = 0.3 lies at
    alpha = 0.03, where |φ'| is about 101 on the left and 99 on the right
    of it, never within C2·|φ'(0)|: the zoom bisects toward the kink
    and runs out.  Both fall back to the same lo (with the same f); the
    port returns ∇f at lo, the JAX package ∇f at the start."""
    x0 = np.array([0.0, 1.0])
    fgj, fgt = _fg_j(kink_j), _fg_t(kink_t)
    f0, g0 = fgj(jnp.asarray(x0))
    aj, fj, gj, okj = lbj._wolfe_line_search(fgj, jnp.asarray(x0), f0, g0,
                                             -g0)
    t = _tensor
    lbt.COUNTS.reset()
    at, ft, gt, okt = lbt._wolfe_line_search(
        fgt, t(x0)[None], t(f0)[None], t(g0)[None], -t(g0)[None])
    assert lbt.COUNTS.fallbacks == 1
    assert bool(okt[0]) and bool(okj)
    _close(at[0], aj, REL, "alpha")
    _close(ft[0], fj, REL, "f")
    lo = float(at[0])
    assert abs(lo - 0.03) < 1e-6
    x_lo = x0 - lo * np.asarray(g0)
    true_g = np.asarray(fgj(jnp.asarray(x_lo))[1])
    np.testing.assert_allclose(gt[0].numpy(), true_g, rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(gj), np.asarray(g0))
    assert abs(true_g[1] - float(g0[1])) > 1e-2   # the two differ
