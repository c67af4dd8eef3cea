"""``Trace.evaluate`` in the port against the JAX package's, at the same
draws: an expression that reads a data column (bound whole, whether or
not a likelihood reads it) and an ``MVNormal`` latent element, whose
value reads its Cholesky factor through a ``MatColumn``.  The same shape,
and values in f64 within 1e-10 of the JAX package's, run with x64 on and
f64 as its dtype, as its own oracle tests run — and of its f64 numpy
evaluator draw by draw, since its ``MatVec`` accumulates in f32 even
then (``preferred_element_type``), where it is held within 1e-6."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu.compute import interp as interp_j
from rainier_tpu.core.trace import Trace as TraceJ
from rainier_tpu_torch.core.trace import Trace as TraceT

rtt.config.set_device("cpu")

X = np.linspace(-1.0, 2.0, 7)


def column_model(rt):
    """a ~ Normal(0, 1) observed on 7 rows; the expression a + 2·x reads
    a column that no likelihood reads."""
    a = rt.Normal(0, 1).latent()
    ys = np.random.default_rng(0).normal(size=7)
    model = rt.Model.observe(list(ys), rt.Normal(a, 1.0))
    return model, a + 2 * rt.Column(X)


def mvnormal_model(rt):
    cov = np.array([[2.0, 0.6, 0.1], [0.6, 1.0, 0.3], [0.1, 0.3, 1.5]])
    lat = rt.MVNormal([0.5, -1.0, 0.0], cov).latent_vec()
    return rt.Model.track_(set(lat.to_list())), lat[2]


@pytest.fixture
def jax_f64():
    jax.config.update("jax_enable_x64", True)
    rtj.config.set_dtype(jnp.float64)
    yield
    rtj.config.set_dtype(jnp.float32)
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("build,shape", [(column_model, (10, 7)),
                                         (mvnormal_model, (10,))])
def test_evaluate_matches_jax(build, shape, jax_f64):
    (mt, et), (mj, ej) = build(rtt), build(rtj)
    cdt, cdj = mt.density(), mj.density()
    draws = np.random.default_rng(1).normal(size=(2, 5, cdt.n_vars))
    got = TraceT(draws, mt, cdt, None).evaluate(et)
    want = np.asarray(TraceJ(jnp.asarray(draws), mj, cdj, None).evaluate(ej))
    assert got.shape == want.shape == shape
    f64 = np.stack([interp_j.evaluate(
        [ej], cdj.layout.env_for(q), interp_j.NUMPY_BACKEND, np.float64)[0]
        for q in draws.reshape(-1, cdt.n_vars)])
    np.testing.assert_allclose(got, f64, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got, want, rtol=0, atol=(
        1e-10 if want.dtype == np.float64 else 1e-6))
