"""The two density forms redesigned for the H100's memory, as the host
build runs them, held against the JAX package's lanes evaluator
(``rainier_tpu/ops/hmc_pallas.py:293-304``: ``jax.grad`` of
``logp_lanes_fn``) and against the kernel's plain version:

* a ``Gather`` whose source varies by row: the tile loader reads each
  row's index, clamps it (``mode="clip"``) and loads the source's columns
  at that row into fields of the tile after the row's own, so the row
  reads only the tile; the space's tiles are up to
  ``emit_cuda.TILE_ROWS_MAX`` rows;
* the product pass of a workspace model (L·z of an ``MVNormal`` past 16
  dimensions held in the scratch): L staged in the block's shared memory
  at a row stride of p + 1 floats (``rt_stage_mats``), or, where it does
  not fit (a GP of 256 inputs), read by the forward pass from a
  transposed copy bound after the columns; the models whose L fits are
  also emitted with a staging budget of 0 bytes, so that the kernel's
  loop runs the transposed layout on them too.

Every model is built through both packages by one ``build(rt)`` from the
same numpy data.  The g++ host build stages L into a host buffer, walks
the tiles and emulates the 32 lanes in the card's summation order.
"""

import numpy as np
import pytest

import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu_torch.compute import emit_cuda
from rainier_tpu_torch.ops import fused_hmc as F
from rainier_tpu_torch.sampler.driver import _verify_split
from test_torch_columns import _host_library, _host_logp_grad, _run_host
from test_torch_forms import (_R, _ys, gather_source_per_row,
                              gather_source_per_row_ws, latent_gp,
                              mvnormal_logistic)
from test_torch_untiled import _density_bars, _inputs, _jax_lp_grad, _points

torch.set_num_threads(2)
rtt.config.set_device("cpu")

# rows past one tile of the gather's space and not a multiple of it
PAST_TILE = emit_cuda.TILE_ROWS_MAX + 1037


def gather_clamped(rt, n=301, seed=6):
    """gather_source_per_row with indices past both ends (−1, n and
    further), which the gather clamps to rows 0 and n − 1."""
    R = _R(rt)
    ys = _ys(n, seed)
    a = rt.Normal(0, 1).latent()
    y = R.Column(ys)
    ya = y * a
    idx = (np.arange(n) * 5 + 1) % n
    idx[:4] = (-1, n, n + 100, -50)
    return rt.Model.likelihood(R.RowSum(rt.Normal(
        R.Gather(ya, R.IntColumn(idx)) + ya, 1.0).log_density_at(y), n))


def gather_nested(rt, n=301, seed=6):
    """A row-varying gather inside the source of another: the outer's
    source is rebuilt at its row from the tile, the inner's, at the row
    its index there names, from the columns' device pointers."""
    R = _R(rt)
    ys = _ys(n, seed)
    a = rt.Normal(0, 1).latent()
    y = R.Column(ys)
    ya = y * a
    inner = R.Gather(ya, R.IntColumn((np.arange(n) * 5 + 1) % n)) + y
    outer = R.Gather(inner, R.IntColumn((np.arange(n) * 7 + 3) % n))
    # both sources read at the row too, so both vary by row
    return rt.Model.likelihood(R.RowSum(rt.Normal(
        outer + inner + ya, 1.0).log_density_at(y), n))


# the gather form: (builder, whether the state is in the workspace,
# whether a rebuilt source holds a gather of its own)
GATHER = {
    f"gather {PAST_TILE} rows": (
        lambda rt: gather_source_per_row(rt, PAST_TILE), False, False),
    "gather 301 rows": (lambda rt: gather_source_per_row(rt, 301), False,
                        False),
    "gather clamped, 301 rows": (gather_clamped, False, False),
    f"gather ws {PAST_TILE} rows": (
        lambda rt: gather_source_per_row_ws(rt, PAST_TILE), True, False),
    "gather ws 300 rows": (gather_source_per_row_ws, True, False),
    "gather nested, 301 rows": (gather_nested, False, True),
}
# the product pass: (builder, L's rows and columns), L fitting beside
# the slots or tiles
PRODUCT = {"gp 40": (lambda rt: latent_gp(rt, 40), 40),
           "gp 64": (lambda rt: latent_gp(rt, 64), 64),
           "mvnormal logistic 32": (mvnormal_logistic, 32)}
# L in shared memory, as the emitter chooses, or a transposed copy in
# device memory, emitted with a staging budget of 0 bytes
LAYOUTS = {"staged": None, "transposed": 0}
# a GP whose L (256 x 257 floats, 263 KB) does not fit: the transposed
# copy by its size (its density alone: each sampling step of its plain
# version on the CPU costs 256 scalar terms)
WIDE = "gp 256"
CASES = {**{name: (build, None) for name, (build, _, _) in GATHER.items()},
         **{f"{name}, {layout}": (build, budget)
            for name, (build, _) in PRODUCT.items()
            for layout, budget in LAYOUTS.items()},
         WIDE: (lambda rt: latent_gp(rt, 256), None)}
LOOPS = sorted(set(CASES) - {WIDE})


def _model(name, rt):
    """The case's model through package `rt`, the port's emitted with its
    layout's staging budget where it has one."""
    build, budget = CASES[name]
    model = build(rt)
    if rt is rtt and budget is not None:
        emit_cuda.emit(model.density(), stage_budget=budget)
    return model


_MODELS = {}


def _case(name):
    """(model, density, emitted) of the port's side of a case, made once."""
    if name not in _MODELS:
        model = _model(name, rtt)
        cd = model.density()
        _MODELS[name] = (model, cd, emit_cuda.emit(cd))
    return _MODELS[name]


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The g++ build of each case's kernel, one per header."""
    root, built = tmp_path_factory.mktemp("forms_tiles"), {}

    def get(cd):
        em = emit_cuda.emit(cd)
        if em.source not in built:
            built[em.source] = _host_library(cd, root)
        return built[em.source]
    return get


# -- the emitted text ---------------------------------------------------------


@pytest.mark.parametrize("name", sorted(GATHER))
def test_gather_reads_its_source_from_the_tile(name):
    """The row reads the rebuilt source's columns from the tile, not from
    their device pointers (no RT_ROW_COLS), but where a gather inside a
    rebuilt source reads them at the row that its index there names;
    the loader loads them at the clamped index, every copy of each row
    once (its copies fill every float of the row), the batch's indices
    loaded before any copy; the space's tile is
    TILE_ROWS_MAX rows, or the power of two that holds every row,
    and two of them fit the shared memory."""
    _, cd, em = _case(name)
    _, ws, nested = GATHER[name]
    src = em.source
    (tile,) = em.spaces
    n = tile.n_rows
    assert ("#define RT_ROW_COLS 1" in src) == nested
    row = src[src.index("rt_row("):src.index("rt_rows_post")]
    assert ("cols." in row) == nested
    assert src.count("rt_copy_async(&tile[i * RT_ROW_W + ") == tile.row_width
    loads = src[src.index("rt_fill_tile("):]
    assert loads.count("[u] = rt_clampi(cols.c") == 1 + nested
    assert tile.tile_rows == min(emit_cuda.TILE_ROWS_MAX,
                                 1 << (n - 1).bit_length())
    assert 2 * 4 * tile.tile_rows * tile.row_width <= \
        emit_cuda.SMEM_BYTES_MAX
    assert bool(em.workspace) == ws


@pytest.mark.parametrize("name", sorted(PRODUCT))
def test_product_pass_layouts(name):
    """Staged: L at a row stride of p + 1 floats in the block's shared
    memory, RT_SMEM_MATS floats, both passes through RT_MAT0; transposed:
    the forward pass reads cols.t0 (the copy the wrapper binds after the
    columns), the transpose cols.c0; in both the inner loops unrolled by
    eight."""
    p = PRODUCT[name][1]
    _, _, em_t = _case(f"{name}, transposed")
    (c,) = em_t.transposed
    assert em_t.staged == 0
    assert f"cols.t{c}[(j) * {p} + (r)]" in em_t.source
    assert "RT_SMEM_MATS" not in em_t.source
    _, _, em = _case(f"{name}, staged")
    assert em.staged == p * (p + 1) and em.transposed == ()
    assert f"cols.s{c}[(r) * {p + 1} + (j)]" in em.source
    assert f"#define RT_SMEM_MATS {p * (p + 1)}" in em.source
    assert "rt_stage_mats(RtCols& cols" in em.source
    for src in (em.source, em_t.source):
        # the forward pass may come again where a reverse pass needs it
        assert src.count(f"acc += RT_MAT{c}(r, j) * ") >= 1
        assert src.count(f"acc += RT_MAT{c}_T(r, j) * ") == 1
        for v in ("j", "r"):
            assert f"#pragma unroll 8\n    for (int {v} = 0; {v} < {p}; " \
                f"++{v})" in src


def test_wide_matrix_takes_the_transposed_copy():
    """Where L does not fit beside the block's slots, the emitter itself
    binds the transposed copy: the 256-input GP's 256 × 257 floats are
    over the 227 KB that a block may use."""
    _, _, em = _case(WIDE)
    (c,) = em.transposed
    assert em.staged == 0 and 4 * 256 * 257 > emit_cuda.SMEM_BYTES_MAX
    assert "cols.t%d[(j) * 256 + (r)]" % c in em.source
    assert "RT_SMEM_MATS" not in em.source


@pytest.mark.parametrize("block", [0, 4 * 4 * 576])
def test_mat_layout_stages_up_to_its_budget(block):
    """_mat_layout stages L where the block's bytes and L at a row stride
    of p + 1 floats fit the budget, to the byte, and binds the transposed
    copy past it."""
    products = {2: (64, 64)}
    need = block + 4 * 64 * 65
    lines, staged, transposed = emit_cuda._mat_layout(products, block, need)
    assert staged == 64 * 65 and transposed == ()
    assert "#define RT_MAT2(r, j) cols.s2[(r) * 65 + (j)]" in lines
    assert "#define RT_SMEM_MATS 4160" in lines
    lines, staged, transposed = emit_cuda._mat_layout(products, block,
                                                      need - 1)
    assert staged == 0 and transposed == (2,)
    assert lines == ["#define RT_MAT2(r, j) cols.t2[(j) * 64 + (r)]",
                     "#define RT_MAT2_T(r, j) cols.c2[(r) * 64 + (j)]"]
    assert emit_cuda._mat_layout({}, block) == ([], 0, ())


# -- against JAX and the plain version ---------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_emitted_density_matches_jax_lanes(name, host):
    """The kernel's density function (g++ host build, lanes emulated) and
    the plain version against JAX's logp_lanes_fn and jax.grad at the
    same q, with chip_smoke.py's density_check bars (two f32 sums of the
    same terms in other orders differ by rounding)."""
    _, cd, _ = _case(name)
    cdj = _model(name, rtj).density()
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
    """(q0, keywords, explicit noise) of 37 chains × 25 iterations from a
    short scan-path warmup, made once per case."""
    if name not in _INPUTS:
        model, cd, _ = _case(name)
        _INPUTS[name] = _inputs(cd, model, 37, 25, "explicit")
    return _INPUTS[name]


@pytest.mark.parametrize("name", LOOPS)
def test_host_kernel_matches_plain_version(name, host):
    """The kernel's loop (g++ host build, 37 chains: a ragged last block)
    against the plain version with explicit noise, at
    test_torch_forms.py's bar: the two sum in other orders, so ≥ 90% of
    chains end within 1e-3 (a flipped borderline accept sends a chain
    away) and accept rates agree within 0.05 on average."""
    _, cd, _ = _case(name)
    q0, kw, nz = _kernel_inputs(name)
    lib, _ = host(cd)
    cols = cd.column_values(torch.float32, "cpu")
    got = _run_host(lib, cd, q0, kw, nz, cols)
    ref = F.fused_hmc_reference(cd, q0, noise=nz, **kw)
    rel = ((got[0] - ref[0]).abs() / ref[0].abs().clamp(min=1.0)).amax(0)
    assert float((rel <= 1e-3).float().mean()) >= 0.9, rel
    assert float((got[2] - ref[2]).abs().mean()) < 0.05


@pytest.mark.parametrize("name", LOOPS)
def test_host_kernel_repeats_its_bits(name, host):
    """Two runs of the kernel's loop from one input give the same bits;
    a gather's streamed tile loop (the asynchronous loader) gives the
    synchronous one's; and the two layouts of L give the same bits, since
    each product sums in one order."""
    _, cd, _ = _case(name)
    q0, kw, nz = _kernel_inputs(name)
    lib, _ = host(cd)
    cols = cd.column_values(torch.float32, "cpu")
    a = _run_host(lib, cd, q0, kw, nz, cols)
    runs = [_run_host(lib, cd, q0, kw, nz, cols)]
    if name in GATHER:
        runs.append(_run_host(lib, cd, q0, kw, nz, cols, stream=True))
    if name.endswith("transposed"):
        other = name.replace("transposed", "staged")
        lib_s, _ = host(_case(other)[1])
        runs.append(_run_host(lib_s, _case(other)[1], q0, kw, nz, cols))
    for b in runs:
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("name", sorted(GATHER))
def test_split_identity_at_the_gather_tile(name):
    """base + Σ over tiles == the whole density at the gather space's own
    tile and at TILE_ROWS_MAX rows: the rebuilt source sliced by
    the tiles in the plain version as in the kernel."""
    _, cd, em = _case(name)
    cols = cd.column_values(torch.float32, "cpu")
    for tile in (em.tile_rows, emit_cuda.TILE_ROWS_MAX):
        assert _verify_split(cd, cols, tile), tile

