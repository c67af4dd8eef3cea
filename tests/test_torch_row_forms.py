"""The two row forms of the fused kernel's density as the H100 runs them,
held against the JAX package's lanes evaluator
(``rainier_tpu/ops/hmc_pallas.py:293-304``: ``jax.grad`` of
``logp_lanes_fn``) and against the kernel's plain version:

* an ``IntColumn`` read whole (a nested ``RowSum`` of a gather by it): its
  loops split their elements over a chain's 32 lanes even when the state
  is in registers, and the gather's adjoints are summed by source entry
  in f64 in each lane's own array (up to ``emit_cuda.ENTRY_LOCAL_MAX``
  entries) or in the lanes' copies in the slot (past it), the lanes'
  sums met in the butterfly's order: no atomics;
* a vector of the rows' length read at the row's own index: its adjoint
  goes straight to its entry (no hand-back through ``sidx``/``sval``),
  and where it is a parameter vector or an elementwise function of one,
  the row reads the parameter from the chain's state and adds its
  adjoint to ``g``, with no copy in ``inv``/``ainv``.

Every model is built through both packages by one ``build(rt)`` from the
same numpy data, at rows that are not a multiple of 32.  The g++ host
build emulates the 32 lanes in the card's summation order, so it checks
the split and the order without a card.  Models without these forms emit
the header they did before the forms were redesigned.
"""

import hashlib
import importlib
import re

import numpy as np
import pytest

import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu_torch.compute import emit_cuda
from rainier_tpu_torch.ops import fused_hmc as F
from test_torch_columns import _host_library, _host_logp_grad, _run_host
from test_torch_forms import _R, _ys, index_read_whole, vector_per_row
from test_torch_untiled import _density_bars, _inputs, _jax_lp_grad, _points

torch.set_num_threads(2)
rtt.config.set_device("cpu")


def index_wide(rt, n=301, k=3, extra=40, seed=6):
    """The index column read whole with a 3-entry source, and `extra`
    more parameters with a prior of their own: past LANE_STATE_MAX, so
    the state is in the workspace and the adjoint sums in each lane's
    array."""
    z = rt.Normal(0, 1).latent_vec(extra)
    return index_read_whole(rt, n, k, seed).merge(
        rt.Model.track_([z.element]))


def vector_fn_per_row(rt, n=69, seed=6):
    """A vector of the rows' length that is an elementwise function of a
    parameter vector: row i's mean is exp(b_i / 2)."""
    R = _R(rt)
    b = rt.Normal(0, 1).latent_vec(n)
    y = R.Column(_ys(n, seed))
    mean = ((b.element * 0.5).exp() - 1.0)
    return rt.Model.likelihood(R.RowSum(
        rt.Normal(mean, 1.0).log_density_at(y), n))


def vector_scaled_per_row(rt, n=69, seed=6):
    """A vector of the rows' length that depends on a scalar parameter
    too (b_i · s): it stays among the row-invariant values, its adjoint
    added at the row's entry of ainv."""
    R = _R(rt)
    b = rt.Normal(0, 1).latent_vec(n)
    s = rt.Normal(1, 0.1).latent()
    y = R.Column(_ys(n, seed))
    return rt.Model.likelihood(R.RowSum(
        rt.Normal(b.element * s, 1.0).log_density_at(y), n))


def vector_and_rebuilt(rt, n=69, seed=6):
    """A vector of the rows' length read at the row and again inside a
    source that the row rebuilds at another row (a Gather whose source
    varies by row): another row may share its entry, so its adjoint is
    handed back to the warp there, not added at the row."""
    R = _R(rt)
    b = rt.Normal(0, 1).latent_vec(n)
    y = R.Column(_ys(n, seed))
    src = y * 0.5 + b.element
    idx = R.IntColumn((np.arange(n) * 7 + 3) % n)
    return rt.Model.likelihood(R.RowSum(rt.Normal(
        R.Gather(src, idx) + src, 1.0).log_density_at(y), n))


# index column read whole: (rows, source entries) and the layout each
# takes: registers with the sums in each lane's array ("local"), or the
# workspace with the sums there or in the lanes' copies in the slot
# ("slot", one source entry past ENTRY_LOCAL_MAX)
PAST_CAP = emit_cuda.ENTRY_LOCAL_MAX + 1
INDEX = {"index 3 entries, 37 rows": (lambda rt: index_read_whole(rt, 37, 3),
                                      False, "local"),
         "index 3 entries, 301 rows": (
             lambda rt: index_read_whole(rt, 301, 3), False, "local"),
         "index 20 entries, 301 rows": (
             lambda rt: index_read_whole(rt, 301, 20), False, "local"),
         f"index {PAST_CAP} entries, 301 rows": (
             lambda rt: index_read_whole(rt, 301, PAST_CAP), True, "slot"),
         "index 3 entries, 301 rows, workspace": (index_wide, True, "local")}
# vector per row: the builder and whether the vector is read from the
# chain's state (a parameter vector or a function of one)
VECTOR = {"vector 37 rows": (lambda rt: vector_per_row(rt, 37), True),
          "vector 69 rows": (lambda rt: vector_per_row(rt, 69), True),
          "vector exp(b/2) 69 rows": (vector_fn_per_row, True),
          "vector b*s 69 rows": (vector_scaled_per_row, False),
          "vector at its row and rebuilt, 69 rows": (vector_and_rebuilt,
                                                     None)}
MODELS = {**{k: v[0] for k, v in INDEX.items()},
          **{k: v[0] for k, v in VECTOR.items()}}


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The g++ build of each model's kernel, one per header in the
    module."""
    root, built = tmp_path_factory.mktemp("row_forms"), {}

    def get(cd):
        em = emit_cuda.emit(cd)
        if em.source not in built:
            built[em.source] = _host_library(cd, root)
        return built[em.source]
    return get


# -- the emitted text ---------------------------------------------------------


def _function(src, name):
    """The text of the emitted function `name`."""
    start = src.index(f" {name}(")
    return src[start:src.index("\n}\n", start)]


@pytest.mark.parametrize("name", sorted(INDEX))
def test_index_read_whole_splits_over_lanes(name):
    """The loops over the index column split over the lanes, lane l from
    l in steps of RT_LSTEP, in rt_rows_pre and rt_rows_post alike; the
    gather's adjoints go to each lane's own sums, summed over the lanes
    in the butterfly, and no atomic add is emitted."""
    build, ws, mode = INDEX[name]
    cd = build(rtt).density()
    em = emit_cuda.emit(cd)
    n = cd.columns[0].n_rows
    src = em.source
    assert bool(em.workspace) == ws
    assert "atomic" not in src
    head = f"for (int i = RT_LANE; i < {n}; i += RT_LSTEP)"
    assert head in _function(src, "rt_rows_pre")
    assert _function(src, "rt_rows_post").count(head) == 2
    assert "#define RT_LANES 32" in src
    if mode == "local":
        assert "RT_EADD(" in src and "RT_ESUM(" in src
        assert "RT_EADD_SLOT(" not in src
    else:
        assert "RT_EADD_SLOT(" in src and "rt_lane_tree<RT_LANES>(" in src
        assert "RT_EADD(" not in src


@pytest.mark.parametrize("name", sorted(VECTOR))
def test_vector_per_row_adds_at_its_entry(name):
    """The row adds its element's adjoint at its own entry, with no
    sidx/sval hand-back; a parameter vector or a function of one is read
    from the chain's state q at the row's index, its adjoint added to g
    there, with no inv/ainv copy: the workspace shrinks by 2n floats a
    chain."""
    build, state = VECTOR[name]
    cd = build(rtt).density()
    em = emit_cuda.emit(cd)
    n = cd.columns[0].n_rows
    row = _function(em.source, "rt_row")
    assert em.workspace
    if state is None:       # read by a rebuilt source: handed back
        assert row.count("sidx[") == 2 and "cainv" not in row
        assert "#define RT_GATHERS 2" in em.source
        return
    assert "sidx[" not in row and "sval[" not in row
    assert "#define RT_GATHERS 0" in em.source
    assert "#define RT_ROW_STATE 1" in em.source
    if state:
        assert em.n_inv == 0 and "inv[" not in row
        assert "q[0 + rix]" in row and "g[0 + rix] +=" in row
        assert em.workspace == emit_cuda.workspace_floats(
            cd.n_vars, em.n_inv, True, scratch=em.scratch)
        assert emit_cuda.workspace_floats(cd.n_vars, n, True) \
            - em.workspace == 2 * n - 2
    else:
        assert f"cainv[{em.n_inv - n} + rix] +=" in row


# -- against JAX and the plain version ---------------------------------------


@pytest.mark.parametrize("name", sorted(MODELS))
def test_emitted_density_matches_jax_lanes(name, host):
    """The kernel's density function (g++ host build, lanes emulated) and
    the plain version against JAX's logp_lanes_fn and jax.grad at the
    same q, with chip_smoke.py's density_check bars (two f32 sums of the
    same terms in other orders differ by rounding)."""
    cd, cdj = MODELS[name](rtt).density(), MODELS[name](rtj).density()
    q = _points(cd.n_vars, 3, 6).astype(np.float32)
    lp_ref, g_ref = _jax_lp_grad(cdj, q)
    lib, em = host(cd)
    qt = torch.as_tensor(q)
    lp, g = _host_logp_grad(lib, em, qt, cd.column_values(torch.float32,
                                                          "cpu"))
    _density_bars(lp.numpy(), g.numpy(), lp_ref, g_ref)
    lp_p, g_p = F.logp_grad_reference(cd, qt)
    _density_bars(lp_p.numpy(), g_p.numpy(), lp_ref, g_ref)


_INPUTS = {}


def _kernel_inputs(name):
    """(model, density, q0, keywords, explicit noise) of 37 chains × 25
    iterations from a short scan-path warmup, made once per model."""
    if name not in _INPUTS:
        model = MODELS[name](rtt)
        cd = model.density()
        _INPUTS[name] = (model, cd, *_inputs(cd, model, 37, 25, "explicit"))
    return _INPUTS[name]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_host_kernel_matches_plain_version(name, host):
    """The kernel's loop (g++ host build, 37 chains: a ragged last block)
    against the plain version with explicit noise, at
    test_torch_forms.py's bar: the two sum in other orders, so ≥ 90% of
    chains end within 1e-3 (a flipped borderline accept sends a chain
    away) and accept rates agree within 0.05 on average."""
    _, cd, q0, kw, nz = _kernel_inputs(name)
    lib, _ = host(cd)
    cols = cd.column_values(torch.float32, "cpu")
    got = _run_host(lib, cd, q0, kw, nz, cols)
    ref = F.fused_hmc_reference(cd, q0, noise=nz, **kw)
    rel = ((got[0] - ref[0]).abs() / ref[0].abs().clamp(min=1.0)).amax(0)
    assert float((rel <= 1e-3).float().mean()) >= 0.9, rel
    assert float((got[2] - ref[2]).abs().mean()) < 0.05


@pytest.mark.parametrize("name", ["index 3 entries, 301 rows",
                                  f"index {PAST_CAP} entries, 301 rows",
                                  "index 3 entries, 301 rows, workspace",
                                  "vector 69 rows",
                                  "vector exp(b/2) 69 rows"])
def test_host_kernel_repeats_its_bits(name, host):
    """Two runs of the kernel's loop from one input give the same bits:
    every sum has a fixed order."""
    _, cd, q0, kw, nz = _kernel_inputs(name)
    lib, _ = host(cd)
    cols = cd.column_values(torch.float32, "cpu")
    a = _run_host(lib, cd, q0, kw, nz, cols)
    b = _run_host(lib, cd, q0, kw, nz, cols)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# -- every other model emits the header it did -----------------------------


def _canonical(src):
    """The header with every run of digits after a letter or an
    underscore (node ids, a rebuilt source's tags among them) numbered by
    first appearance: the text does not depend on how many nodes the
    process built before."""
    ids = {}
    return re.sub(r"(?<=[a-z_])(\d+)", lambda m: str(
        ids.setdefault(m.group(1), len(ids))), src)


# (test module, builder, arguments) of a model of each test file that has
# neither form, and the sha256 of its canonical header as the parent of
# this redesign emitted it; the two models with a row-varying gather and
# the two workspace models with a product pass are pinned to the headers
# of those forms' own redesign (the source's columns loaded into the
# tile at the gathered row; L read where _mat_layout puts it)
KEPT = {
    "columnfree funnel": ("test_torch_columnfree", "funnel", ()),
    "columnfree funnel 300": ("test_torch_columnfree", "funnel", (300,)),
    "columnfree matvec": ("test_torch_columnfree", "matvec_model", ()),
    "columns readme": ("test_torch_columns", "readme_regression", ()),
    "columns logistic": ("test_torch_columns", "logistic", ()),
    "columns matrix views": ("test_torch_columns", "matrix_views", ()),
    "columns base with columns": ("test_torch_columns", "base_with_columns",
                                  ()),
    "dense_mass normal": ("test_torch_dense_mass", "normal_observe", ()),
    "density lse select lookup": ("test_torch_density", "lse_select_lookup",
                                  ()),
    "ehmc eight schools": ("test_torch_ehmc", "eight_schools", ()),
    "forms gather source per row": ("test_torch_forms",
                                    "gather_source_per_row", ()),
    "forms gather source per row ws": ("test_torch_forms",
                                       "gather_source_per_row_ws", ()),
    "forms mvnormal past 16": ("test_torch_forms", "mvnormal_past_16", ()),
    "forms gp 40": ("test_torch_forms", "latent_gp", (40,)),
    "forms mvnormal logistic 32": ("test_torch_forms", "mvnormal_logistic",
                                   ()),
    "forms vector per row 3": ("test_torch_forms", "vector_per_row", ()),
    "gather glmm 10x6": ("test_torch_gather", "glmm_poisson", (10, 6)),
    "gather glmm 30x11": ("test_torch_gather", "glmm_poisson", (30, 11)),
    "gather clamped": ("test_torch_gather", "clamped_gather", ()),
    "gather lookup": ("test_torch_gather", "lookup_by_int_column", ()),
    "lanes small logistic": ("test_torch_lanes", "small_logistic", ()),
    "large glmm 300": ("test_torch_large_models", "glmm_large", (300,)),
    "marginal mixture": ("test_torch_marginal", "mixture", ()),
    "progress regression": ("test_torch_progress", "regression", ()),
    "sampler gather": ("test_torch_sampler", "gather_by_int_column", ()),
    "trace column": ("test_torch_trace", "column_model", ()),
    "trace mvnormal": ("test_torch_trace", "mvnormal_model", ()),
    "untiled mvnormal logistic": ("test_torch_untiled", "mvnormal_logistic",
                                  ()),
    "untiled data vec dot": ("test_torch_untiled", "data_vec_dot", ()),
    "untiled two blocks": ("test_torch_untiled", "two_blocks", ()),
    "untiled logistic blocks": ("test_torch_untiled", "logistic_blocks", ()),
    "variational normal": ("test_torch_variational", "normal_model", ()),
}
KEPT_HEADERS = {
    "columnfree funnel": "d51980fe6dd331f31654",
    "columnfree funnel 300": "69a6c58c863453c2c45e",
    "columnfree matvec": "5cf954660acfd2a2d2e8",
    "columns base with columns": "f68d4fdb880a430b58e1",
    "columns logistic": "9d31c3d09507d73c925b",
    "columns matrix views": "0d834d93515150391895",
    "columns readme": "985026ac5a7dc60d6de1",
    "dense_mass normal": "ce52c192e67c874d6eb5",
    "density lse select lookup": "d517c83c12811a7a87c1",
    "ehmc eight schools": "a72f808d17008132a2eb",
    "forms gather source per row": "cd3e447e78c7e5d12f93",
    "forms gather source per row ws": "3cb12cb8ba70d28635b8",
    "forms gp 40": "04edbb9497e5bcc8ee44",
    "forms mvnormal logistic 32": "654f7f88fa2c73237e59",
    "forms mvnormal past 16": "39dd171e46eabd68b1fb",
    "forms vector per row 3": "11f883fe2a847eaf70a1",
    "gather clamped": "f049dc054160a7130fcc",
    "gather glmm 10x6": "db25dd0b3cec65c52b3e",
    "gather glmm 30x11": "e1757fbea241ca51a6ad",
    "gather lookup": "eab98bba675f1a74f432",
    "lanes small logistic": "49074704951da9801b7a",
    "large glmm 300": "ce512ce5ecab793359e0",
    "marginal mixture": "88b2c406b95d507430b6",
    "progress regression": "86772ac83c95f6967495",
    "sampler gather": "2c92d089255cc36da2fe",
    "trace column": "a7c4f1b812ab1aaa8b20",
    "trace mvnormal": "afe5804f1ec2616449ca",
    "untiled data vec dot": "5b0a8ee42351a61dd212",
    "untiled logistic blocks": "920cc3fa4030533a2bd3",
    "untiled mvnormal logistic": "083d67d65a94e4c5765b",
    "untiled two blocks": "2b1e60e20eec0fa59bec",
    "variational normal": "b92c3476001ed3bcb723",
}


@pytest.mark.parametrize("name", sorted(KEPT))
def test_other_models_emit_their_header_unchanged(name):
    """A model with neither form emits, byte for byte once its node ids
    are numbered by first appearance, the rt_model.h it did before."""
    module, builder, args = KEPT[name]
    model = getattr(importlib.import_module(module), builder)(rtt, *args)
    model = model[0] if isinstance(model, tuple) else model
    src = emit_cuda.emit(model.density()).source
    assert hashlib.sha256(_canonical(src).encode()).hexdigest()[:20] == \
        KEPT_HEADERS[name]
