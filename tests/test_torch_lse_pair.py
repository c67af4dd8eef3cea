"""The LogSumExp of two terms in a row, as the CUDA emitter writes it.

A row's ``LogSumExp`` of two terms x, y (the zero-inflated geometric's
point mass and count, the marginalized mixture's two components) takes
m = max(x, y), one exponential e = exp((x − m) + (y − m)) and s = 1 + e,
m + log(s); the terms' shares are 1 / s and e / s from one reciprocal of s
and a correction each (``emit_cuda._lse_pair``, ``rt_recip`` and
``rt_lse_pair_share`` in ``csrc/rt_math.cuh``), where the pairwise form
took two exponentials and divided each in f64 (``rt_lse_share``).
Checked:

* the emitted rows and row steps of both models take one ``expf`` and one
  reciprocal a row and no ``double``; a ``LogSumExp`` of three terms, or
  outside the rows, keeps the pairwise form;
* a g++ build of the emitted row over a grid of (x, y) that holds ±0,
  ±∞, NaN, equal terms and gaps of 1e-30 to 1e30: the value and both
  shares have the bits of the pairwise form (NaN where it is NaN), and a
  step of rows the bits of its rows one after another;
* both models through the host build against the JAX package's density
  and ``jax.grad``, and the host kernel against its plain version.

The card's shares are held to the IEEE quotient for every f32 e in [0, 1]
by ``chip_smoke.py``'s phase "LogSumExp pair shares".
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
from rainier_tpu_torch.ops import fused_hmc as F
from test_torch_columns import _host_library, _host_logp_grad, _run_host
from test_torch_untiled import (_R, _density_bars, _inputs, _jax_lp_grad,
                                _points)

torch.set_num_threads(2)
rtt.config.set_device("cpu")

# the models whose rows hold a LogSumExp of two terms: (module, function,
# arguments)
PAIR_MODELS = {
    "zero-inflated geometric": ("test_torch_discrete", "LIKELIHOODS",
                                "zero_inflated_geometric"),
    "marginalized mixture": ("test_torch_row_loop", "mixture", 5000),
}


def _pair_model(name, rt):
    module, attr, arg = PAIR_MODELS[name]
    found = getattr(importlib.import_module(module), attr)
    if isinstance(found, dict):
        return found[arg](rt)
    return found(rt, arg)[0]


def _functions(src, head):
    """The bodies of the header's functions whose signature starts with
    `head`."""
    return [src[m.start():src.index("\n}\n", m.start())]
            for m in re.finditer(re.escape(head), src)]


@pytest.mark.parametrize("name", sorted(PAIR_MODELS))
def test_pair_rows_take_one_exp_and_no_double(name):
    """Each row function evaluates one expf and one reciprocal a row, its
    adjoints read the forward's exponential, and nothing in it is f64;
    a step function of k rows k of each."""
    src = emit_cuda.emit(_pair_model(name, rtt).density()).source
    rows = _functions(src, "RT_HD float rt_row(")
    steps = _functions(src, "RT_HD void rt_row_step(")
    assert rows and (steps or name.startswith("zero"))
    for body, k in [(b, 1) for b in rows] + [
            (b, b.count("const float* x_R")) for b in steps]:
        assert len(re.findall(r"\bexpf\(", body)) == k
        assert body.count("rt_recip(") == k
        assert "double" not in body and "rt_lse_share" not in body
        rev = body[body.index("+= 1.0f;"):]
        assert "expf(" not in rev


def _three_terms(rt, n=300, seed=5):
    """A row's LogSumExp of three terms: each keeps its exponential and
    its f64 share."""
    R = _R(rt)
    ys = np.random.default_rng(seed).normal(size=n)
    a, b = rt.Normal(0, 1).latent(), rt.Normal(0, 1).latent()
    col = R.Column(ys)
    return rt.Model.likelihood(R.RowSum(R.LogSumExp(
        [a * col, b * col, (a + b) * col]), n))


def test_three_terms_keep_the_pairwise_form():
    """Past two terms the row keeps the pairwise form: an exponential a
    term, each share divided by rt_lse_share."""
    src = emit_cuda.emit(_three_terms(rtt).density()).source
    (row,) = _functions(src, "RT_HD float rt_row(")
    assert len(re.findall(r"\bexpf\(", row)) == 3
    assert row.count("rt_lse_share(") == 3 and "rt_recip" not in row


# -- the emitted pair, compiled for the host ----------------------------------

SPECIAL = (0.0, -0.0, 1e-30, -1e-30, 1.0, -1.0, 20.0, -20.0, 88.0, -88.0,
           1e30, -1e30, np.inf, -np.inf, np.nan)
GAPS = [10.0 ** k for k in range(-30, 31)]


def _grid():
    """(x, y) pairs: every pair of SPECIAL, and x, x ± d (both orders)
    for x in a few values and d every power of ten from 1e-30 to 1e30."""
    pairs = [(x, y) for x in SPECIAL for y in SPECIAL]
    for x in (0.0, 1.0, -3.5, 100.0, -7e3):
        for d in GAPS:
            pairs += [(x, x + d), (x + d, x), (x, x - d), (x - d, x)]
    return np.array(pairs, np.float32)


_HARNESS = r"""
#include "rt_math.cuh"
#include "rt_model.h"
#include <vector>

// every row of the columns (x, y): rt_row's value and the adjoints of
// its two terms, the pairwise form's value and shares (the emitter's text
// before the pair: two exponentials, each share e / s), and the value and
// adjoints of the rows through rt_row_step, 4 at a time, beside rt_row's
// in turn; out holds 11 floats a row
extern "C" void rows(const void* const* colp, int n, const float* q,
                     float* out) {
  RtCols cols = rt_cols(colp);
  std::vector<float> tile((size_t)n * RT_ROW_W);
  rt_fill_tile(tile.data(), cols, 0, n, 0, 1);
  float inv[RT_NINV_ALLOC];
  rt_rows_pre(q, inv);
  for (int i = 0; i < n; ++i) {
    float* o = out + 11 * (size_t)i;
    const float* x = &tile[(size_t)i * RT_ROW_W];
    float a[RT_NINV_ALLOC] = {};
    o[0] = rt_row(x, inv, a);
    o[1] = a[0];
    o[2] = a[1];
    const float v0 = inv[0] + x[0], v1 = inv[1] + x[1];
    const float m = fmaxf(v0, v1);
    const float e0 = expf(v0 - m), e1 = expf(v1 - m);
    const float s = e0 + e1;
    o[3] = m + logf(s);
    o[4] = 1.0f * (e0 / s);
    o[5] = 1.0f * (e1 / s);
  }
  for (int i = 0; i + RT_ROW_STEP <= n; i += RT_ROW_STEP) {
    float a[RT_NINV_ALLOC] = {}, b[RT_NINV_ALLOC] = {}, v[RT_ROW_STEP];
    rt_row_step(&tile[(size_t)i * RT_ROW_W], RT_ROW_W, inv, a, v);
    for (int k = 0; k < RT_ROW_STEP; ++k) {
      out[11 * (size_t)(i + k) + 6] = v[k];
      rt_row(&tile[(size_t)(i + k) * RT_ROW_W], inv, b);
    }
    float* o = out + 11 * (size_t)i;
    o[7] = a[0];
    o[8] = a[1];
    o[9] = b[0];
    o[10] = b[1];
  }
}
"""


@pytest.fixture(scope="module")
def grid_pair(tmp_path_factory):
    """The harness over _grid(): the row's inputs are alpha + x and beta
    + y at alpha = beta = -0, so exactly x and y.  Returns ((x, y), out
    (rows, 11))."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the emitted row cannot be "
                    "compiled for the host")
    xy = _grid()
    n = len(xy)
    R = _R(rtt)
    cx, cy = R.Column(np.zeros(n)), R.Column(np.zeros(n))
    alpha, beta = rtt.Normal(0, 1).latent(), rtt.Normal(0, 1).latent()
    cd = rtt.Model.likelihood(R.RowSum(R.LogSumExp(
        [alpha + cx, beta + cy]), n)).density()
    assert [c is cx for c in cd.columns] == [True, False]
    old = emit_cuda.ROW_STEP_OPS
    emit_cuda.ROW_STEP_OPS = 0          # a step function for any row
    try:
        em = emit_cuda.emit(cd)
    finally:
        emit_cuda.ROW_STEP_OPS = old
    assert "#define RT_ROW_STEP 4" in em.source
    d = tmp_path_factory.mktemp("lse_pair")
    (d / emit_cuda.HEADER_NAME).write_text(em.source)
    (d / "harness.cc").write_text(_HARNESS)
    res = subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
         str(d), "-I", str(F.CSRC), "-o", str(d / "harness.so"),
         str(d / "harness.cc")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(d / "harness.so"))
    # the grid's columns, NaN and ±∞ included, bound in the density's
    # column order
    cols = (torch.as_tensor(xy[:, 0].copy()), torch.as_tensor(xy[:, 1].copy()))
    ptrs, _held = F.column_pointers(em, cols)
    q = np.array([-0.0, -0.0], np.float32)
    out = np.full((n, 11), np.nan, np.float32)
    p = (lambda a: a.ctypes.data_as(ctypes.c_void_p))
    lib.rows(ptrs, ctypes.c_int(n), p(q), p(out))
    return xy, out


def _same(a, b):
    """Equal bits, or both NaN."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return (a.view(np.uint32) == b.view(np.uint32)) | (np.isnan(a)
                                                       & np.isnan(b))


@pytest.mark.parametrize("what,new,old", [("value", 0, 3),
                                          ("first share", 1, 4),
                                          ("second share", 2, 5)])
def test_pair_keeps_the_pairwise_bits(grid_pair, what, new, old):
    """The row's value and each term's share have the pairwise form's
    bits at every (x, y) of the grid: NaN exactly where it is NaN (an
    infinite max or a NaN term), its value where one term is −∞."""
    xy, out = grid_pair
    same = _same(out[:, new], out[:, old])
    assert same.all(), (what, xy[~same][:5], out[~same][:5])
    assert np.isnan(out[:, new]).any() and np.isfinite(out[:, new]).any()


def test_pair_step_keeps_the_bits_of_its_rows(grid_pair):
    """rt_row_step's values have rt_row's bits, row by row, and the
    adjoints it adds over 4 rows are those of the rows one after
    another."""
    xy, out = grid_pair
    steps = len(xy) // 4 * 4
    assert _same(out[:steps, 6], out[:steps, 0]).all()
    lead = out[:steps:4]
    assert _same(lead[:, 7], lead[:, 9]).all()
    assert _same(lead[:, 8], lead[:, 10]).all()


# -- the models through the host build -----------------------------------------


@pytest.mark.parametrize("name", sorted(PAIR_MODELS))
def test_pair_density_matches_jax(name, tmp_path):
    """The kernel's density function (g++ host build, lanes emulated)
    against JAX's logp_lanes_fn and jax.grad, and the plain version
    against it, with chip_smoke.py's density_check bars: the rows' f32
    sums in other orders differ by rounding."""
    cd, cdj = (_pair_model(name, pkg).density() for pkg in (rtt, rtj))
    q = _points(cd.n_vars, 3, 6).astype(np.float32)
    lp_ref, g_ref = _jax_lp_grad(cdj, q)
    lib, em = _host_library(cd, tmp_path)
    qt = torch.as_tensor(q)
    lp, g = _host_logp_grad(lib, em, qt, cd.column_values(torch.float32,
                                                          "cpu"))
    _density_bars(lp.numpy(), g.numpy(), lp_ref, g_ref)
    lp_p, g_p = F.logp_grad_reference(cd, qt)
    _density_bars(lp_p.numpy(), g_p.numpy(), lp_ref, g_ref)


@pytest.mark.parametrize("name", sorted(PAIR_MODELS))
def test_pair_host_kernel_matches_plain_version(name, tmp_path):
    """The kernel's loop (g++ host build, 37 chains: a ragged last block)
    against the plain version with explicit noise, at
    test_torch_forms.py's bar: ≥ 90% of chains within 1e-3 and accept
    rates within 0.05 on average."""
    model = _pair_model(name, rtt)
    cd = model.density()
    q0, kw, nz = _inputs(cd, model, 37, 25, "explicit")
    lib, _ = _host_library(cd, tmp_path)
    cols = cd.column_values(torch.float32, "cpu")
    got = _run_host(lib, cd, q0, kw, nz, cols)
    ref = F.fused_hmc_reference(cd, q0, noise=nz, **kw)
    rel = ((got[0] - ref[0]).abs() / ref[0].abs().clamp(min=1.0)).amax(0)
    assert float((rel <= 1e-3).float().mean()) >= 0.9, rel
    assert float((got[2] - ref[2]).abs().mean()) < 0.05
