"""The Bernoulli-logit rows of the CUDA emitter, and the row spaces' fold.

A logistic regression's row reads softplus(v) and softplus(-v) of one
linear predictor v (the Bernoulli's two branches, a select by y).  The
emitter shares exp(-|v|) and its log1p between the two and takes both
derivatives σ(±v) from them and one reciprocal (``emit_cuda.
_softplus_groups``, ``rt_recip`` in ``csrc/rt_math.cuh``), where each
softplus called expf and log1pf and each adjoint expf again.  Checked:

* the emitted ``rt_row`` and ``rt_row_step`` (or a space's ``row`` and
  ``step``) of every logistic model of the tests call one ``expf``, one
  ``log1pf`` and one ``rt_recip`` a row, and no ``rt_softplus``;
* a g++ build of a row of the emitted header, over a grid of v that
  holds ±0, ±1e-30, ±20, ±88 and ±1e30: lp has the bits of two
  ``rt_softplus`` calls, ``rt_row_step`` the bits of ``rt_row``, and the
  gradient y − σ(v) is within 2 f32 ulps of the exact σ everywhere and of
  the old ``expf(±v - softplus(±v))`` at those points;
* which softplus nodes share (a neg or a product with -1, per-row only);
* the logistic in three row spaces (301, 77 and 1 rows), past the two
  that the fold over the spaces (``rt_spaces_rows``) replaced a
  recursion for: the host build against JAX's density, the host kernel
  against its plain version, and streamed against synchronous bit for
  bit.
"""

import ctypes
import importlib
import re
import shutil
import subprocess

import numpy as np
import pytest

import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu_torch.compute import emit_cuda
from rainier_tpu_torch.compute import real as Rt
from rainier_tpu_torch.compute.compiler import kernel_rows
from rainier_tpu_torch.ops import fused_hmc as F
from test_torch_columns import _host_library, _host_logp_grad, _run_host
from test_torch_untiled import (_R, _density_bars, _inputs, _jax_lp_grad,
                                _logistic_data, _points)

torch.set_num_threads(2)
rtt.config.set_device("cpu")

# the logistic models of the tests: (module, function, arguments)
LOGIT_MODELS = {
    "columns logistic": ("test_torch_columns", "logistic", ()),
    "lanes small logistic": ("test_torch_lanes", "small_logistic", ()),
    "untiled logistic blocks": ("test_torch_untiled", "logistic_blocks", ()),
    "untiled mvnormal logistic": ("test_torch_untiled", "mvnormal_logistic",
                                  ()),
    "forms mvnormal logistic 32": ("test_torch_forms", "mvnormal_logistic",
                                   ()),
}


def _functions(src, one, many):
    """The bodies of the header's functions whose signature starts with
    `one` (a header of one row space) or `many` (each RtSpace<s>'s)."""
    out = []
    for head, end in ((one, "\n}\n"), (many, "\n  }\n")):
        for m in re.finditer(re.escape(head), src):
            out.append(src[m.start():src.index(end, m.start())])
    return out


@pytest.mark.parametrize("name", sorted(LOGIT_MODELS))
def test_logit_rows_call_one_exp_and_one_log1p(name):
    """Each row function evaluates one exponential, one log1pf and one
    reciprocal a row; a step function of k rows k of each."""
    module, make, args = LOGIT_MODELS[name]
    model = getattr(importlib.import_module(module), make)(rtt, *args)
    src = emit_cuda.emit(model.density()).source
    rows = _functions(src, "RT_HD float rt_row(", "static RT_HD float row(")
    steps = _functions(src, "RT_HD void rt_row_step(",
                       "static RT_HD void step(")
    assert rows
    for body, k in [(b, 1) for b in rows] + [
            (b, b.count("const float* x_R")) for b in steps]:
        assert "rt_softplus(" not in body
        assert body.count("log1pf(") == k
        assert len(re.findall(r"\bexpf\(", body)) == k
        assert body.count("rt_recip(") == k


# -- a row of the emitted header, compiled for the host ------------------------

# v on the grid: the points the old form is held at, then moderate ones
GRID_POINTS = (0.0, -0.0, 1e-30, -1e-30, 20.0, -20.0, 88.0, -88.0, 1e30,
               -1e30)
GRID = np.concatenate([GRID_POINTS, np.linspace(-30.0, 30.0, 2001)]).astype(
    np.float32)

_HARNESS = r"""
#include "rt_math.cuh"
#include "rt_model.h"
#include <vector>

// every row of the columns: rt_row's lp and adjoint of inv[0], the
// steps' lp and the adjoint summed over each step's rows (rt_row in turn
// beside it), and the form of two rt_softplus calls with its adjoints
// expf(±v - softplus(±v)), at v the row's data column (alpha = -0)
extern "C" void rows(const void* const* colp, int n, const float* v,
                     const float* y, const float* q, float* lp, float* g,
                     float* lp_step, float* g_step, float* g_rows,
                     float* lp_old, float* g_old) {
  RtCols cols = rt_cols(colp);
  std::vector<float> tile((size_t)n * RT_ROW_W);
  rt_fill_tile(tile.data(), cols, 0, n, 0, 1);
  float inv[RT_NINV_ALLOC];
  rt_rows_pre(q, inv);
  for (int i = 0; i < n; ++i) {
    float a[RT_NINV_ALLOC] = {};
    lp[i] = rt_row(&tile[(size_t)i * RT_ROW_W], inv, a);
    g[i] = a[0];
    const float s = y[i] == 0.0f ? v[i] : -v[i];
    lp_old[i] = -rt_softplus(s);
    g_old[i] = (y[i] == 0.0f ? -1.0f : 1.0f) * expf(s - rt_softplus(s));
  }
  for (int i = 0; i + RT_ROW_STEP <= n; i += RT_ROW_STEP) {
    float a[RT_NINV_ALLOC] = {}, b[RT_NINV_ALLOC] = {};
    rt_row_step(&tile[(size_t)i * RT_ROW_W], RT_ROW_W, inv, a, &lp_step[i]);
    for (int k = 0; k < RT_ROW_STEP; ++k)
      rt_row(&tile[(size_t)(i + k) * RT_ROW_W], inv, b);
    g_step[i] = a[0];
    g_rows[i] = b[0];
  }
}
"""


def _grid_model(rt, v, y):
    """Bernoulli(logistic(alpha + v_i)) at y_i: alpha a latent, v a data
    column, so that at alpha = -0 the row's linear predictor is v_i."""
    R = _R(rt)
    alpha = rt.Normal(0, 1).latent()
    return rt.Model.likelihood(R.RowSum(rt.Bernoulli(
        (alpha + R.Column(v.astype(np.float64))).logistic()).log_density_at(
            R.Column(y)), len(v)))


@pytest.fixture(scope="module")
def grid_rows(tmp_path_factory):
    """The harness over GRID twice, y = 0 then y = 1: numpy arrays of
    what ``rows`` returns, with v and y."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the emitted row cannot be "
                    "compiled for the host")
    v = np.concatenate([GRID, GRID])
    y = np.repeat([0.0, 1.0], len(GRID))
    cd = _grid_model(rtt, v, y).density()
    old = emit_cuda.ROW_STEP_OPS
    emit_cuda.ROW_STEP_OPS = 0          # a step function for any row
    try:
        em = emit_cuda.emit(cd)
    finally:
        emit_cuda.ROW_STEP_OPS = old
    assert "#define RT_ROW_STEP 4" in em.source
    assert len(re.findall(r"const float p\d+_e(?:_R\d)? = expf",
                          em.source)) == 5
    d = tmp_path_factory.mktemp("logit_row")
    (d / emit_cuda.HEADER_NAME).write_text(em.source)
    (d / "harness.cc").write_text(_HARNESS)
    res = subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
         str(d), "-I", str(F.CSRC), "-o", str(d / "harness.so"),
         str(d / "harness.cc")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(d / "harness.so"))
    n = len(v)
    cols = cd.column_values(torch.float32, "cpu")
    ptrs, _held = F.column_pointers(em, cols)
    vf, yf = v.astype(np.float32), y.astype(np.float32)
    q = np.array([-0.0], np.float32)
    out = {k: np.full(n, np.nan, np.float32) for k in (
        "lp", "g", "lp_step", "g_step", "g_rows", "lp_old", "g_old")}
    p = (lambda a: a.ctypes.data_as(ctypes.c_void_p))
    lib.rows(ptrs, ctypes.c_int(n), p(vf), p(yf), p(q),
             *(p(out[k]) for k in ("lp", "g", "lp_step", "g_step",
                                   "g_rows", "lp_old", "g_old")))
    return dict(out, v=vf, y=yf)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _ulps(a, b):
    """Distance in f32 ulps: the floats' places in one ordered line."""
    def line(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(line(a) - line(b))


def test_shared_softplus_keeps_the_bits_of_two_calls(grid_rows):
    """lp = -softplus(±v) from the shared exp(-|v|) and log1p has the bits
    of rt_softplus(±v) at every v, ±0 and ±1e30 included; the step
    function's rows have the bits of rt_row's, lp and adjoints."""
    r = grid_rows
    assert np.array_equal(_bits(r["lp"]), _bits(r["lp_old"]))
    done = ~np.isnan(r["lp_step"])
    assert done.sum() == len(r["v"]) // 4 * 4
    assert np.array_equal(_bits(r["lp_step"][done]), _bits(r["lp"][done]))
    whole = ~np.isnan(r["g_step"])
    assert np.array_equal(_bits(r["g_step"][whole]),
                          _bits(r["g_rows"][whole]))


def test_shared_sigmoid_is_within_two_ulps(grid_rows):
    """The gradient y − σ(v) from e = exp(-|v|) and r = 1 / (1 + e): within
    2 f32 ulps of σ in f64 at every v; within 2 ulps of the old
    expf(±v − softplus(±v)) at GRID_POINTS; and nowhere further from σ
    than the old form's largest distance.  Between those points the old
    form is itself up to 8 ulps from σ (v - softplus(v) cancels: glibc's
    expf and log1pf, g++ -O2), so the bar against it is held where it is
    exact to an ulp, and the bar against σ everywhere."""
    r = grid_rows
    v, y = r["v"].astype(np.float64), r["y"]
    with np.errstate(over="ignore"):        # exp(±1e30): σ is 0 or 1
        exact = np.where(y == 0, -1.0 / (1.0 + np.exp(-v)),
                         1.0 / (1.0 + np.exp(v))).astype(np.float32)
    assert np.all(np.isfinite(r["g"]))
    assert _ulps(r["g"], exact).max() <= 2
    at = np.tile(np.arange(len(GRID)) < len(GRID_POINTS), 2)
    assert _ulps(r["g"][at], r["g_old"][at]).max() <= 2
    assert _ulps(r["g"], exact).max() <= _ulps(r["g_old"], exact).max()


# -- which softplus nodes share --------------------------------------------


def _row_groups(model):
    """The softplus groups of each row space of `model`, as the emitter
    finds them (node id → key)."""
    cd = model.density()
    out = []
    for space in cd.row_split().spaces:
        ks = kernel_rows(space, cd.columns)
        order = Rt.topological(list(ks.roots))
        out.append(emit_cuda._softplus_groups(order, ks.dep))
    return out


@pytest.mark.parametrize("form", ["neg", "times -1", "alone", "invariant"])
def test_softplus_groups(form):
    """softplus(v) and softplus(-v) of a per-row v share whether -v is a
    neg or a product with -1; a softplus alone, or a pair of row-invariant
    values (computed once a call, outside the rows), does not."""
    x, ys = _logistic_data(50, 2)
    a = rtt.Normal(0, 1).latent()
    b = rtt.Normal(0, 1).latent_vec(2)
    v = a + Rt.MatVec(Rt.MatColumn(x), b.element)
    if form == "invariant":
        v = a * 1.0
    neg = {"neg": Rt.Unary(v, "neg"), "times -1": v * -1.0}.get(form)
    term = Rt.Unary(v, "softplus") * Rt.Column(ys)
    if neg is not None:
        term = term + Rt.Unary(neg, "softplus")
    if form == "invariant":
        term = term + Rt.Unary(Rt.Unary(v, "neg"), "softplus") \
            + Rt.Column(ys)
    groups = _row_groups(rtt.Model.likelihood(Rt.RowSum(-term, len(ys))))
    sizes = [len(g) for g in groups]
    assert sizes == ([2] if form in ("neg", "times -1") else [0])


# -- three row spaces: the fold over the spaces --------------------------------

THREE_CUTS = (301, 378)


def three_spaces(rt):
    """The logistic regression of 379 rows × 3 features observed as three
    blocks of 301, 77 and 1 rows under one set of parameters."""
    R = _R(rt)
    x, ys = _logistic_data(379, 3, seed=4)
    alpha = rt.Normal(0, 5).latent()
    betas = rt.Normal(0, 5).latent_vec(3)
    bounds = [0, *THREE_CUTS, len(ys)]
    return rt.Model.likelihoods([R.RowSum(rt.Bernoulli(
        (alpha + R.MatVec(R.MatColumn(x[a:b]), betas.element)).logistic())
        .log_density_at(R.Column(ys[a:b])), b - a)
        for a, b in zip(bounds, bounds[1:])])


def test_three_spaces_density_matches_jax(tmp_path):
    """The host build's density over three spaces (the fold runs each
    space's tile loop in turn) against JAX's logp_lanes_fn and jax.grad,
    density_check's bars."""
    cd, cdj = three_spaces(rtt).density(), three_spaces(rtj).density()
    em = emit_cuda.emit(cd)
    assert "#define RT_SPACES 3" in em.source
    assert [s.n_rows for s in em.spaces] == [301, 77, 1]
    q = _points(cd.n_vars, 6, 7).astype(np.float32)
    lp_ref, g_ref = _jax_lp_grad(cdj, q)
    lib, em = _host_library(cd, tmp_path)
    lp, g = _host_logp_grad(lib, em, torch.as_tensor(q),
                            cd.column_values(torch.float32, "cpu"))
    _density_bars(lp.numpy(), g.numpy(), lp_ref, g_ref)


def test_three_spaces_host_kernel_matches_plain_version(tmp_path):
    """The host kernel over three spaces against the plain version with
    explicit noise, 37 chains: test_torch_untiled.py's bar (≥ 90% of
    chains within 1e-3, accept rates within 0.05 on average)."""
    model = three_spaces(rtt)
    cd = model.density()
    lib, em = _host_library(cd, tmp_path)
    q0, kw, nz = _inputs(cd, model, 37, 20, "explicit")
    cols = cd.column_values(torch.float32, "cpu")
    got = _run_host(lib, cd, q0, kw, nz, cols)
    ref = F.fused_hmc_reference(cd, q0, noise=nz, **kw)
    rel = ((got[0] - ref[0]).abs() / ref[0].abs().clamp(min=1.0)).amax(0)
    assert float((rel <= 1e-3).float().mean()) >= 0.9, rel
    assert float((got[2] - ref[2]).abs().mean()) < 0.05


@pytest.mark.parametrize("noise", ["explicit", "philox"])
def test_three_spaces_stream_bit_identically(noise, tmp_path):
    """Streamed, the three-space kernel gives the synchronous kernel's
    final q, draws, accept rates and divergences exactly, and so does
    its density alone: every thread commits one copy group a tile of
    each space, whichever loop runs."""
    model = three_spaces(rtt)
    cd = model.density()
    lib, em = _host_library(cd, tmp_path)
    q0, kw, nz = _inputs(cd, model, 37, 12, noise)
    cols = cd.column_values(torch.float32, "cpu")
    sync = _run_host(lib, cd, q0, kw, nz, cols)
    streamed = _run_host(lib, cd, q0, kw, nz, cols, stream=True)
    for a, b in zip(sync, streamed):
        assert torch.equal(a, b)
    q = q0[:, :9].contiguous()
    for a, b in zip(_host_logp_grad(lib, em, q, cols),
                    _host_logp_grad(lib, em, q, cols, stream=True)):
        assert torch.equal(a, b)
