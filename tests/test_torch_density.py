"""Parity of the PyTorch port's density layer with the JAX package.

The same model is built through both packages by one ``build(rt)``
function; inputs come from numpy seeds.  Checked here:

* logp and gradient of ``CompiledDensity`` against ``jax.value_and_grad``
  (f32; rtol 1e-5, atol 1e-5·(1+|logp|)) on the funnel, the README
  regression, every continuous family and a LogSumExp/Select/Lookup graph;
* ``logp_lanes_fn`` (chains-last block) against the scalar ``logp_fn``;
* the C source of ``compute/emit_cuda.py``, compiled for the host with
  g++, against torch autograd and ``jax.grad`` — including the digamma
  adjoint of lgamma, min/max ties, abs at 0 and pow with base <= 0 —
  and what it still refuses (a Gather across rows, an IntColumn used
  as a value);
* that the port imports neither jax nor rainier_tpu.
"""

import ctypes
import hashlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu_torch.compute import emit_cuda
from rainier_tpu_torch.ops import fused_hmc as F

torch.set_num_threads(2)
rtt.config.set_device("cpu")


# -- models, built the same way through either package ---------------------


def funnel(rt):
    y = rt.Normal(0.0, 3.0).latent()
    xv = rt.Normal(0.0, (y / 2).exp()).latent_vec(9)
    return rt.Model.track_({y} | set(xv.to_list()))


def readme_regression(rt):
    rng = np.random.default_rng(42)
    xs = [tuple(r) for r in rng.normal(size=(200, 3))]
    ys = [float(np.dot(x, [1.0, -2.0, 0.5]) + 0.7 + 0.3 * rng.normal())
          for x in xs]
    sigma = rt.Exponential(1).latent()
    alpha = rt.Normal(0, 1).latent()
    betas = rt.Normal(0, 1).latent_vec(3)
    return rt.Model.observe(ys, rt.Vec.from_(xs).map(
        lambda t: rt.Normal(alpha + rt.Vec.of(*t).dot(betas), sigma)))


def _data(seed, n=40, lo=None):
    d = np.random.default_rng(seed).normal(1.0, 1.5, size=n)
    return list(np.abs(d) + 0.1) if lo == 0 else list(d)


FAMILIES = {
    "normal": lambda rt: rt.Model.observe(
        _data(1), rt.Normal(rt.Normal(0, 10).latent(),
                            rt.Exponential(0.5).latent())),
    "cauchy": lambda rt: rt.Model.observe(
        _data(2), rt.Cauchy(rt.Normal(0, 5).latent(), 2.0)),
    "laplace": lambda rt: rt.Model.observe(
        _data(3), rt.Laplace(rt.Laplace(0, 3).latent(), 1.5)),
    "gamma": lambda rt: rt.Model.observe(
        _data(4, lo=0), rt.Gamma(rt.Gamma(2.0, 1.0).latent(),
                                 rt.Exponential(1.0).latent())),
    "exponential": lambda rt: rt.Model.observe(
        _data(5, lo=0), rt.Exponential(rt.Gamma(2.0, 0.5).latent())),
    "beta": lambda rt: rt.Model.observe(
        list(np.random.default_rng(6).uniform(0.05, 0.95, 30)),
        rt.Beta(rt.Exponential(1.0).latent(), rt.Gamma(2, 1).latent())),
    "lognormal": lambda rt: rt.Model.observe(
        _data(7, lo=0), rt.LogNormal(rt.Normal(0, 1).latent(),
                                     rt.Exponential(1.0).latent())),
    "uniform": lambda rt: rt.Model.observe(
        _data(8), rt.Normal(rt.Uniform(-1.0, 3.0).latent(), 1.0)),
    "mixture": lambda rt: rt.Model.observe(
        _data(9), rt.Mixture({rt.Normal(-2, 1): rt.Beta(2, 2).latent(),
                              rt.Normal(2, 1): 0.5})),
}


def lse_select_lookup(rt):
    a = rt.Normal(0, 1).latent()
    b = rt.Normal(0.5, 2).latent()
    v = rt.Normal(0, 1).latent_vec(3)
    c = v.to_list()
    lse = rt.log_sum_exp([a, b * 2.0, c[1] - 1.0])
    sel = rt.gt(a, b, a * a, b.exp())
    look = rt.lookup(rt.gt(a, 0.0, 1.0, 0.0), [a * 3.0, b - a])
    return rt.Model.likelihoods([lse, sel, look, rt.compare(a, b) * b])


MODELS = {"funnel": funnel, "readme_regression": readme_regression,
          "lse_select_lookup": lse_select_lookup, **FAMILIES}


def _points(n_vars, seed, k=3):
    return np.random.default_rng(seed).normal(size=(k, n_vars)) * 0.7


def _jax_value_and_grad(model, q):
    cd = model.density()
    cols = cd.column_values(jnp.float32)
    f = jax.value_and_grad(lambda qq: cd.logp_fn()(qq, cols))
    lp, g = f(jnp.asarray(q, jnp.float32))
    return float(lp), np.asarray(g)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_logp_and_grad_match_jax(name):
    mj, mt = MODELS[name](rtj), MODELS[name](rtt)
    cdt = mt.density()
    assert cdt.n_vars == mj.density().n_vars
    for q in _points(cdt.n_vars, seed=len(name)):
        lp_j, g_j = _jax_value_and_grad(mj, q)
        lp_t, g_t = cdt.logp_and_grad(q, device="cpu")
        atol = 1e-5 * (1 + abs(lp_j))
        np.testing.assert_allclose(float(lp_t), lp_j, rtol=1e-5, atol=atol)
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_lanes_match_scalar_logp(name):
    cd = MODELS[name](rtt).density()
    qs = torch.as_tensor(_points(cd.n_vars, seed=7, k=6), dtype=torch.float32)
    cols = cd.column_values(device="cpu")
    lanes = cd.logp_lanes_fn()(qs.T, cols)
    scalar = torch.stack([cd.logp_fn()(q, cols) for q in qs])
    np.testing.assert_allclose(lanes.numpy(), scalar.numpy(), rtol=2e-5,
                               atol=1e-4)


def test_batched_grad_matches_per_chain_grad():
    cd = readme_regression(rtt).density()
    qs = torch.as_tensor(_points(cd.n_vars, seed=3, k=4), dtype=torch.float32)
    cols = cd.column_values(device="cpu")
    lp, g = cd.batched_logp_and_grad_fn()(qs, cols)
    for i, q in enumerate(qs):
        lp1, g1 = cd.logp_and_grad_fn()(q, cols)
        np.testing.assert_allclose(float(lp[i]), float(lp1), rtol=1e-5)
        np.testing.assert_allclose(g[i].numpy(), g1.numpy(), rtol=1e-5,
                                   atol=1e-4)


def test_port_matches_numpy_oracle():
    """The port's numpy oracle (interp.evaluate) and its torch backend
    agree in f64 on the README regression."""
    from rainier_tpu_torch.compute import interp

    cd = readme_regression(rtt).density()
    q = _points(cd.n_vars, seed=5, k=1)[0]
    env = cd.layout.env_for(q)
    for c in cd.columns:
        env[c.id] = c.values
    vals = interp.evaluate(cd.roots, env, interp.NUMPY_BACKEND, np.float64)
    oracle = vals[-1] + sum(np.sum(v) for v in vals[:-1])
    rtt.config.set_dtype(torch.float64)
    try:
        lp = float(cd.logp(q, device="cpu"))
    finally:
        rtt.config.set_dtype(torch.float32)
    assert lp == pytest.approx(float(oracle), rel=1e-12)


# -- the CUDA emitter, compiled for the host --------------------------------


def _compile_host(cd, tmp_path):
    """g++ build of the kernel template + the emitted rt_model.h (the
    host branch of csrc/fused_hmc.cu; a chain over a slot on its 32 lanes,
    emulated) → ctypes function q, g -> lp."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the emitted C source cannot be "
                    "compiled for the host")
    em = emit_cuda.emit(cd)
    # one directory per model: dlopen returns a cached handle for a path
    # it has already loaded
    inc = tmp_path / hashlib.sha256(em.source.encode()).hexdigest()[:16]
    inc.mkdir()
    (inc / emit_cuda.HEADER_NAME).write_text(em.source)
    so = inc / "host.so"
    res = subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
         "-I", str(inc), "-I", str(F.CSRC), "-o", str(so),
         str(F.CSRC / "fused_hmc.cu")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    fn = lib.rt_logp_grad_host
    fn.argtypes = F.LOGP_GRAD_ARGTYPES
    no_cols = (ctypes.c_void_p * 1)()
    ws = np.zeros(max(em.workspace, 1), np.float32)
    threads = emit_cuda.LANES if em.workspace else 1

    def lpg(q):
        q = np.ascontiguousarray(q, dtype=np.float32)
        g = np.zeros_like(q)
        lp = np.zeros(1, np.float32)
        fn(1, q.ctypes.data, lp.ctypes.data, g.ctypes.data, no_cols, 0,
           ws.ctypes.data, threads, 0)
        return float(lp[0]), g

    return lpg, em


def _unary_zoo(rt):
    """Every unary op at an in-domain point, each on its own latent."""
    ps = [rt.parameter() for _ in range(20)]
    t = [ps[0].exp(), ps[1].log(), ps[2].abs(), ps[3].sqrt(), ps[4].sin(),
         ps[5].cos(), ps[6].tan(), ps[7].asin(), ps[8].acos(), ps[9].atan(),
         ps[10].sinh(), ps[11].cosh(), ps[12].tanh(), ps[13].logistic(),
         ps[14].logit(), ps[15].log1p(), ps[16].expm1(),
         ps[17].softplus(), -ps[18], ps[19].lgamma()]
    return rt.Model.likelihoods([x * (i + 1.0) for i, x in enumerate(t)])


UNARY_POINT = [0.3, 1.7, -0.8, 2.2, 0.4, -1.1, 0.6, 0.2, -0.3, 1.5, -0.7,
               0.9, -1.3, 3.0, 0.35, 0.8, -0.4, -2.5, 1.2, 0.45]


def _binary_zoo(rt):
    a, b, c = rt.parameter(), rt.parameter(), rt.parameter()
    v = rt.Normal(0, 1).latent_vec(3).to_list()
    return rt.Model.likelihoods([
        a + b, a - c, a * b * c, a / b, b.pow(c), a.min(c), b.max(c),
        rt.sum_([a, b, c]) * v[0], rt.log_sum_exp([a, v[1], c * 2.0]),
        rt.lt(a, c, b * b, c), rt.lookup(rt.gte(b, 0.0, 1.0, 0.0),
                                         [v[2], a * b]), v[1] / 2.0])


EDGE_CASES = {
    # lgamma: the digamma adjoint at small, mid, large and negative x
    "digamma": (lambda rt: rt.Model.likelihoods(
        [p.lgamma() for p in [rt.parameter() for _ in range(5)]]),
        [0.3, 2.5, 7.0, 31.0, -0.5]),
    # min/max ties split the adjoint (jax's balanced rule)
    "ties": (lambda rt: (lambda a, b: rt.Model.likelihoods(
        [a.min(b) * 3.0, a.max(b) * 5.0]))(rt.parameter(), rt.parameter()),
        [1.25, 1.25]),
    "abs_at_zero": (lambda rt: rt.Model.likelihood(
        rt.parameter().abs() * 2.0), [0.0]),
    # pow with base <= 0: a NaN exponent adjoint below 0, 0 at 0
    "pow_nonpositive_base": (lambda rt: (lambda a, b, c: rt.Model.likelihoods(
        [a.pow(b), c.pow(2.0)]))(rt.parameter(), rt.parameter(),
                                 rt.parameter()), [-1.5, 2.0, 0.0]),
    "pow_zero_base": (lambda rt: (lambda a, b: rt.Model.likelihood(
        a.pow(b)))(rt.parameter(), rt.parameter()), [0.0, 2.0]),
    "saturating": (lambda rt: rt.Model.likelihoods(
        [p.softplus() + p.logistic() for p in
         [rt.parameter() for _ in range(4)]]), [-40.0, 40.0, -90.0, 0.0]),
}


def _emitter_cases():
    rng = np.random.default_rng(0)
    return {
        "funnel": (funnel, list(rng.normal(size=10) * 0.8)),
        "unary_zoo": (_unary_zoo, UNARY_POINT),
        "binary_zoo": (_binary_zoo, [0.7, -1.2, 1.9, 0.3, -0.4, 1.1]),
        "lse_select_lookup": (lse_select_lookup,
                              [0.4, -0.9, 0.2, 1.3, -0.6]),
        **EDGE_CASES,
    }


@pytest.mark.parametrize("name", sorted(_emitter_cases()))
def test_emitted_c_matches_autograd_and_jax(name, tmp_path):
    build, point = _emitter_cases()[name]
    mt, mj = build(rtt), build(rtj)
    cd = mt.density()
    q = np.asarray(point, np.float32)
    assert cd.n_vars == q.size
    lpg_c, em = _compile_host(cd, tmp_path)
    lp_c, g_c = lpg_c(q)
    lp_t, g_t = cd.logp_and_grad(q, device="cpu")
    lp_j, g_j = _jax_value_and_grad(mj, q)
    atol = 1e-5 * (1 + abs(lp_j))
    for lp, g in ((lp_c, g_c), (float(lp_t), g_t.numpy())):
        np.testing.assert_allclose(lp, lp_j, rtol=1e-5, atol=atol)
        np.testing.assert_allclose(g, g_j, rtol=1e-5, atol=atol,
                                   equal_nan=True)
    assert em.ops > 0


def test_edge_case_adjoints_are_jax_conventions(tmp_path):
    """Spot values the emitter must produce (jax.grad's conventions)."""
    lpg, _ = _compile_host(EDGE_CASES["ties"][0](rtt).density(), tmp_path)
    _, g = lpg(np.asarray([1.25, 1.25]))
    np.testing.assert_allclose(g, [0.5 * 3 + 0.5 * 5] * 2)
    lpg, _ = _compile_host(EDGE_CASES["abs_at_zero"][0](rtt).density(),
                           tmp_path)
    assert lpg(np.zeros(1))[1][0] == 2.0   # d|x|/dx = 1 at 0, as jax
    lpg, _ = _compile_host(EDGE_CASES["digamma"][0](rtt).density(),
                           tmp_path)
    from scipy.special import digamma

    xs = np.asarray(EDGE_CASES["digamma"][1])
    # f32 against scipy's f64: a few ulp, absolute near digamma's root
    np.testing.assert_allclose(lpg(xs)[1], digamma(xs), rtol=2e-6, atol=1e-6)


def gather_by_int_column(rt, R, source=None, index_as_value=False,
                         source_in_row=False):
    """benchmarks/models.py:111-142's structure at small size: latent
    effects gathered by an integer index column.  `source(idx)` replaces
    the gathered vector, which `source_in_row` also adds to the mean;
    `index_as_value` also adds the index to the mean."""
    effects = rt.Normal(0, 1).latent_vec(4)
    idx = R.IntColumn(np.repeat(np.arange(4), 3))
    y = np.random.default_rng(8).normal(size=12)
    src = effects.element if source is None else source(idx)
    mean = R.Gather(src, idx)
    if source_in_row:
        mean = mean + src
    if index_as_value:
        mean = mean + idx * effects[0]
    return rt.Model.likelihood(R.RowSum(rt.Normal(mean, 1.0).log_density_at(
        R.Column(y)), 12))


def test_emitter_refuses_data_columns():
    """What stays outside the emitter raises, naming the node: an
    IntColumn used as a value rather than as an index.  The gather of a
    row-invariant vector by an IntColumn is emitted, so is a gather from
    a column that no row reads row by row, which is read whole, and so is
    a Gather whose source varies by row, which the row rebuilds at the
    index from the source's column, loaded into the tile at that row."""
    from rainier_tpu_torch.compute import real as R

    def column_source(idx):
        return R.Column(np.arange(12.0)) * rtt.Normal(0, 1).latent()

    assert "rt_clampi" in emit_cuda.emit(
        gather_by_int_column(rtt, R).density()).source
    whole = gather_by_int_column(rtt, R, source=column_source)
    assert "RT_WHOLE_COLS" in emit_cuda.emit(whole.density()).source
    across = gather_by_int_column(rtt, R, source=column_source,
                                  source_in_row=True)
    src = emit_cuda.emit(across.density()).source
    assert "j0[u] = rt_clampi(cols.c" in src and "RT_ROW_COLS" not in src
    as_value = gather_by_int_column(rtt, R, index_as_value=True)
    with pytest.raises(emit_cuda.UnsupportedNode,
                       match="IntColumn used other than as the index"):
        emit_cuda.emit(as_value.density())


# -- import guard ------------------------------------------------------------


def test_port_imports_no_jax_and_no_rainier_tpu():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['rainier_tpu'] = None; "
            "sys.modules['goldset_zoo'] = None; "
            "import rainier_tpu_torch, rainier_tpu_torch.interop, "
            "rainier_tpu_torch.ops.fused_hmc, "
            "rainier_tpu_torch.core.mvnormal, "
            "rainier_tpu_torch.core.discrete, "
            "rainier_tpu_torch.core.multinomial, "
            "rainier_tpu_torch.core.generator, "
            "rainier_tpu_torch.core.sbc, rainier_tpu_torch.core.trace, "
            "rainier_tpu_torch.tools.kernel_ab, "
            "rainier_tpu_torch.sampler.nuts, "
            "rainier_tpu_torch.compute.cholesky, "
            "rainier_tpu_torch.compute.evaluator, "
            "rainier_tpu_torch.core.marginal, "
            "rainier_tpu_torch.optimizer.lbfgs, "
            "rainier_tpu_torch.variational, "
            "rainier_tpu_torch.sampler.smc, "
            "rainier_tpu_torch.sampler.progress, "
            "rainier_tpu_torch.parallel, "
            "rainier_tpu_torch.parallel.checkpoint, "
            "rainier_tpu_torch.parallel.distributed, chip_smoke; "
            "chip_smoke.zoo(rainier_tpu_torch); "
            "bad = [m for m, v in sys.modules.items() if v is not None "
            "and m.split('.')[0] in ('jax', 'jaxlib', 'rainier_tpu', "
            "'goldset_zoo', 'tests')]; "
            "assert not bad, bad")
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
