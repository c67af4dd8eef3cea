"""The four density forms the fused kernel's emitter once refused, held
against the JAX package's lanes evaluator, which its kernel runs
(``rainier_tpu/ops/hmc_pallas.py:293-304``: ``jax.grad`` of
``logp_lanes_fn``):

* a ``MatVec`` of a matrix read whole by a vector past ``UNROLL_MAX``
  (an ``MVNormal`` latent of 17 dimensions; a latent Gaussian process
  over 24 inputs, its chain state in the lanes, and over 40, in a slot),
  the product held in the density's scratch and its transpose run there;
* an ``IntColumn`` read outside the rows (a nested ``RowSum`` of a gather
  by it), its gather's adjoint scattered into the source's;
* a per-row value of vector width n (a vector of the rows' length times
  a column), read at the row's index;
* a ``Gather`` whose source varies by row, the source rebuilt at the
  row of the index.

Every model is built through both packages by one ``build(rt)`` from the
same numpy data, at a small size.  Checked, with the tolerance and its
reason at each assertion: the g++ host build of the emitted density and
the plain version against JAX's ``logp_lanes_fn`` and ``jax.grad``; the
host-built kernel against its plain version with explicit noise; and
``Model.sample(kernel="fused!")`` on the CPU against the JAX package's
``kernel="pallas!"`` run interpreted.
"""

import numpy as np
import pytest

import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu.compute import real as Rj
from rainier_tpu_torch.compute import emit_cuda
from rainier_tpu_torch.compute import real as Rt
from rainier_tpu_torch.ops import fused_hmc as F
from rainier_tpu_torch.sampler import HMC, SamplerConfig
from rainier_tpu_torch.sampler.driver import _verify_split
from test_torch_columns import _host_library, _host_logp_grad, _run_host
from test_torch_untiled import (_density_bars, _inputs, _jax_lp_grad,
                                _mean_and_se, _points)

torch.set_num_threads(2)
rtt.config.set_device("cpu")


def _R(rt):
    return Rj if rt is rtj else Rt


def _ys(n, seed=6):
    return np.random.default_rng(seed).normal(size=n)


def vector_per_row(rt, n=3, seed=6):
    """A vector of the rows' length times a column, summed over the rows:
    element i at row i."""
    R = _R(rt)
    b = rt.Normal(0, 1).latent_vec(n)
    w = np.random.default_rng(seed).uniform(0.5, 1.5, size=n)
    return rt.Model.likelihood(R.RowSum(b.element * R.Column(w), n))


def index_read_whole(rt, n=8, k=3, seed=6):
    """An IntColumn read whole, outside the rows: the mean of every row
    sums a gather of a 3-vector by it."""
    R = _R(rt)
    ys = _ys(n, seed)
    b = rt.Normal(0, 1).latent_vec(k)
    a = rt.Normal(0, 1).latent()
    idx = R.IntColumn(np.arange(n) % k)
    return rt.Model.observe(list(ys), rt.Normal(
        a + R.RowSum(R.Gather(b.element, idx), n) / float(n), 1.0))


def gather_source_per_row(rt, n=8, k=3, seed=6):
    """A Gather whose source varies by row: each row reads y·a at the
    row of its index."""
    R = _R(rt)
    ys = _ys(n, seed)
    a = rt.Normal(0, 1).latent()
    y = R.Column(ys)
    ya = y * a
    idx = R.IntColumn((np.arange(n) * 5 + 1) % n)
    return rt.Model.likelihood(R.RowSum(rt.Normal(
        R.Gather(ya, idx) + ya, 1.0).log_density_at(y), n))


def mvnormal_past_16(rt, k=17, seed=6):
    """An MVNormal latent of 17 dimensions (an AR(1) covariance), its
    first element the mean of 8 rows."""
    i = np.arange(k)
    cov = 0.5 ** np.abs(i[:, None] - i[None, :])
    return rt.Model.observe(list(_ys(8, seed)), rt.Normal(
        rt.MVNormal([0.0] * k, cov).latent_vec()[0], 1.0))


def gp_data(n, seed=0, sigma=0.3, length=1.0, jitter=1e-6):
    """n inputs evenly spaced on [0, 10], a squared-exponential K of
    amplitude 1 and length scale `length` with `jitter` on the diagonal,
    and y = sin(x) + N(0, sigma²) from `seed`."""
    x = np.linspace(0.0, 10.0, n)
    K = np.exp(-0.5 * ((x[:, None] - x[None, :]) / length) ** 2)
    K += jitter * np.eye(n)
    y = np.sin(x) + sigma * np.random.default_rng(seed).normal(size=n)
    return x, K, y


def latent_gp(rt, n=24, seed=0, sigma=0.3):
    """Latent Gaussian-process regression: f ~ MVNormal(0, K), y_i ~
    Normal(f_i, sigma) with sigma fixed, so the posterior of f is the
    Gaussian K(K + σ²I)⁻¹y, K − K(K + σ²I)⁻¹K."""
    _, K, y = gp_data(n, seed, sigma)
    f = rt.MVNormal([0.0] * n, K).latent_vec()
    return rt.Model.observe(list(y), f.map(lambda fi: rt.Normal(fi, sigma)))


def gather_expression(rt, n=300, k=3, seed=6):
    """An index column read whole gathering from an expression of the
    parameters, not a parameter: the source is buffered in the scratch
    (unrolled at 3 elements, a loop at 40) and its adjoint taken back."""
    R = _R(rt)
    ys = _ys(n, seed)
    b = rt.Normal(0, 1).latent_vec(k)
    a = rt.Normal(0, 1).latent()
    idx = R.IntColumn((np.arange(n) * 3) % k)
    src = (b.element * a).exp()
    return rt.Model.observe(list(ys), rt.Normal(
        a + R.RowSum(R.Gather(src, idx), n) / float(n), 1.0))


def gather_source_per_row_ws(rt, n=300, k=40, seed=6):
    """The rebuilt source itself gathers from a 40-vector by a second
    index column (read at the row of the first): past LANE_STATE_MAX, so
    the state is in the workspace and both gathers hand their adjoints
    back to the warp."""
    R = _R(rt)
    ys = _ys(n, seed)
    a = rt.Normal(0, 1).latent()
    b = rt.Normal(0, 1).latent_vec(k)
    y = R.Column(ys)
    src = y * a + R.Gather(b.element, R.IntColumn(np.arange(n) % k))
    idx = R.IntColumn((np.arange(n) * 7 + 3) % n)
    return rt.Model.likelihood(R.RowSum(rt.Normal(
        R.Gather(src, idx) + src, 1.0).log_density_at(y), n))


def mvnormal_logistic(rt, n=300, p=32, seed=5):
    """chip_smoke.py's MVNormal logistic at 32 features: betas = L·z held
    once per density call among the row-invariant values."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p))
    ys = rng.uniform(size=n) < 1 / (1 + np.exp(-(x @ rng.normal(size=p))))
    i = np.arange(p)
    cov = 25.0 * 0.5 ** np.abs(i[:, None] - i[None, :])
    alpha = rt.Normal(0, 5).latent()
    betas = rt.MVNormal([0.0] * p, cov).latent_vec()
    return rt.Model.observe(list(ys.astype(float)), rt.Vec.from_(
        [tuple(r) for r in x]).map(lambda t: rt.Bernoulli(
            (alpha + rt.Vec.of(*t).dot(betas)).logistic())))


FORMS = {"vector_per_row": vector_per_row,
         "index_read_whole": index_read_whole,
         "gather_source_per_row": gather_source_per_row,
         "mvnormal_past_16": mvnormal_past_16}
MODELS = {**FORMS, "gp_24": lambda rt: latent_gp(rt, 24),
          "gp_40": lambda rt: latent_gp(rt, 40),
          # past LANE_STATE_MAX: the state in the workspace
          "vector_per_row_ws": lambda rt: vector_per_row(rt, 40),
          "index_read_whole_ws": lambda rt: index_read_whole(rt, 300, 40),
          "gather_source_per_row_ws": gather_source_per_row_ws,
          "gather_expression": gather_expression,
          "gather_expression_ws": lambda rt: gather_expression(rt, k=40),
          "mvnormal_logistic_32": mvnormal_logistic}


def test_gp_layouts():
    """The GP at 24 inputs keeps its state in the lanes, at 40 in a
    shared-memory slot; both hold L·z in the scratch."""
    em24 = emit_cuda.emit(latent_gp(rtt, 24).density())
    em40 = emit_cuda.emit(latent_gp(rtt, 40).density())
    assert em24.workspace == 0 and em24.scratch == 2 * 24
    assert em40.workspace and em40.shared and em40.scratch == 2 * 40
    assert "RT_SCRATCH" in em24.source and "RT_WARP_SYNC" in em40.source


# -- each form emits ----------------------------------------------------------


# what marks each form in the emitted header
MARKS = {"vector_per_row": "rt_int_bits(row0 + i)",
         "index_read_whole": "rt_clampi(cols.c",
         "gather_source_per_row": "j0[u] = rt_clampi(cols.c1[r], 0, 7);",
         "mvnormal_past_16": "#define RT_SCRATCH 34"}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_form_emits(form):
    """Each form the emitter refused before emits, with what carries it
    in the header, and the row split takes it."""
    cd = FORMS[form](rtt).density()
    em = emit_cuda.emit(cd)
    assert MARKS[form] in em.source
    assert em.n_vars == cd.n_vars


# -- the emitted density against JAX's logp_lanes_fn --------------------------


@pytest.mark.parametrize("name", sorted(MODELS))
def test_emitted_density_matches_jax_lanes(name, tmp_path):
    """The kernel's density function (g++ host build) and the plain
    version (density_lanes) against JAX's logp_lanes_fn and jax.grad at
    the same q, with density_check's bars."""
    cd, cdj = MODELS[name](rtt).density(), MODELS[name](rtj).density()
    q = _points(cd.n_vars, 3, 6).astype(np.float32)
    lp_ref, g_ref = _jax_lp_grad(cdj, q)
    lib, em = _host_library(cd, tmp_path)
    cols = cd.column_values(torch.float32, "cpu")
    qt = torch.as_tensor(q)
    lp, g = _host_logp_grad(lib, em, qt, cols)
    _density_bars(lp.numpy(), g.numpy(), lp_ref, g_ref)
    lp_p, g_p = F.logp_grad_reference(cd, qt)
    _density_bars(lp_p.numpy(), g_p.numpy(), lp_ref, g_ref)


@pytest.mark.parametrize("name", ["vector_per_row", "gather_source_per_row",
                                  "index_read_whole"])
def test_split_identity_at_any_tile(name):
    """base + Σ over tiles == the whole density at tiles of 256, 3 and 1
    rows, and of the rows of a rebuilt source's space
    (TILE_ROWS_MAX): a vector of the rows' length and a source
    rebuilt at the index are sliced by the tiles in the plain version as
    in the kernel."""
    cd = MODELS[name](rtt).density()
    cols = cd.column_values(torch.float32, "cpu")
    for tile in (256, 3, 1, emit_cuda.TILE_ROWS_MAX):
        assert _verify_split(cd, cols, tile), tile


def test_forms_at_more_rows_match_jax(tmp_path):
    """The row forms at 300 rows (several tiles of 256 in the kernel, two
    lanes' steps): host build against JAX, density_check's bars."""
    for build in (lambda rt: vector_per_row(rt, 300),
                  lambda rt: index_read_whole(rt, 300, 7),
                  lambda rt: gather_source_per_row(rt, 300)):
        cd, cdj = build(rtt).density(), build(rtj).density()
        q = _points(cd.n_vars, 4, 5).astype(np.float32)
        lp_ref, g_ref = _jax_lp_grad(cdj, q)
        lib, em = _host_library(cd, tmp_path)
        lp, g = _host_logp_grad(lib, em, torch.as_tensor(q),
                                cd.column_values(torch.float32, "cpu"))
        _density_bars(lp.numpy(), g.numpy(), lp_ref, g_ref)


# -- the kernel's loop against the plain version -----------------------------


@pytest.mark.parametrize("name", sorted(MODELS))
def test_host_kernel_matches_plain_version(name, tmp_path):
    """The kernel's loop (g++ host build, 37 chains: a ragged last block)
    against the plain version with explicit noise: the two sum in other
    orders, so ≥ 90% of chains end within 1e-3 (a flipped borderline
    accept sends a chain away) and accept rates agree within 0.05 on
    average, the bar of test_torch_columns.py."""
    model = MODELS[name](rtt)
    cd = model.density()
    em = emit_cuda.emit(cd)
    lanes = None if em.spaces else F.lanes_per_chain(em, 37)
    lib, em = _host_library(cd, tmp_path, lanes)
    q0, kw, nz = _inputs(cd, model, 37, 25, "explicit")
    cols = cd.column_values(torch.float32, "cpu")
    got = _run_host(lib, cd, q0, kw, nz, cols)
    ref = F.fused_hmc_reference(cd, q0, noise=nz, **kw)
    rel = ((got[0] - ref[0]).abs() / ref[0].abs().clamp(min=1.0)).amax(0)
    assert float((rel <= 1e-3).float().mean()) >= 0.9, rel
    assert float((got[2] - ref[2]).abs().mean()) < 0.05


# -- Model.sample(kernel="fused!") against the JAX package's "pallas!" -------


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fused_sample_matches_pallas_sample(name):
    """Model.sample(kernel="fused!", device="cpu") (the kernel's plain
    version on CPU tensors) against the JAX package's kernel="pallas!"
    (interpreted): 16 chains × (200 warmup + 300 draws) of HMC(5) each;
    every coordinate's mean within 5 Monte-Carlo standard errors of the
    two runs combined."""
    cfg_t = SamplerConfig(200, 300, sampler=HMC(5))
    cfg_j = rtj.SamplerConfig(200, 300, sampler=rtj.HMC(5))
    tr_t = MODELS[name](rtt).sample(cfg_t, n_chains=16, seed=0,
                                    kernel="fused!", device="cpu")
    tr_j = MODELS[name](rtj).sample(cfg_j, n_chains=16, seed=0,
                                    kernel="pallas!")
    (m_t, se_t), (m_j, se_j) = _mean_and_se(tr_t), _mean_and_se(tr_j)
    z = np.abs(m_t - m_j) / np.sqrt(se_t ** 2 + se_j ** 2)
    assert np.all(z < 5.0), z
    assert np.all(np.isfinite(tr_t.chains))
    assert float(np.mean(tr_t.accept_rate())) > 0.5
