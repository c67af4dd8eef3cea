"""The kernel's row loop as it is laid out for the H100, on the two models
whose rows it was redesigned for, held on the g++ host build of
``csrc/fused_hmc.cu`` against JAX's lanes evaluator
(``rainier_tpu/ops/hmc_pallas.py:293-304``: ``jax.grad`` of
``logp_lanes_fn``) and against the kernel's plain version:

* the 32-feature MVNormal logistic (``test_torch_forms.py``'s, 33 floats
  a row, its state in the workspace and its 33 row-invariant values in
  registers), in tiles of 512 rows;
* the marginalized mixture (``test_torch_marginal.py``'s, one float a
  row, a two-term ``LogSumExp``), in tiles of up to 4096 rows, four rows
  a lane's step (``emit_cuda.row_step``), the adjoint of the
  ``LogSumExp`` reading the forward pass's exponentials.

Tiles take the most rows that two of them fit in a block's shared
memory (``emit_cuda.tile_rows``), each lane adds its rows of a tile to
sums of its own, and the lanes' sums meet in one butterfly a density
call, in f64.  Each model runs at three row counts: fewer rows than its
tile, a count that is not a multiple of its tile, and several tiles.
The host build sums in the card's order, so two launches, the streamed
and the synchronous tile loops, any chains a block, and any rows a step
give the same bits.
"""

import re
from fractions import Fraction

import numpy as np
import pytest

import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu_torch.compute import emit_cuda
from rainier_tpu_torch.ops import fused_hmc as F
from test_torch_columns import _host_library, _host_logp_grad, _run_host
from test_torch_forms import _R, mvnormal_logistic
from test_torch_marginal import mixture
from test_torch_untiled import _density_bars, _inputs, _jax_lp_grad, _points

torch.set_num_threads(2)
rtt.config.set_device("cpu")

# (the model from (package, rows), rows per tile, row counts:
# within one tile, past one and not a multiple, several tiles)
MODELS = {
    "mvnormal_logistic": (lambda rt, n: mvnormal_logistic(rt, n), 512,
                          (300, 700, 2100)),
    "mixture": (lambda rt, n: mixture(rt, n)[0], 4096, (1000, 5000, 13000)),
}
CASES = [(name, n) for name, (_, _, counts) in MODELS.items()
         for n in counts]
IDS = [f"{name}-{n}" for name, n in CASES]


def wide_logistic(rt, n=2348, p=10, seed=4):
    """A logistic regression whose design is one MatColumn of p floats a
    row (the 100k logistic's form), at n rows: a 2048-row tile and a last
    one of 300, whose second batch of the loader's (2 rows a thread, 256
    rows at 128 threads) holds fewer rows than the block has threads."""
    R = _R(rt)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p))
    ys = (rng.uniform(size=n) < 1 / (1 + np.exp(-(x @ rng.normal(size=p)))))
    alpha = rt.Normal(0, 5).latent()
    betas = rt.Normal(0, 5).latent_vec(p)
    lin = alpha + R.MatVec(R.MatColumn(x), betas.element)
    return rt.Model.likelihood(R.RowSum(rt.Bernoulli(
        lin.logistic()).log_density_at(R.Column(ys.astype(float))), n))


def _case(name, n, pkg=rtt):
    return MODELS[name][0](pkg, n)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(model, density, host library, emitted) of each case, built once."""
    cache = {}

    def get(name, n):
        if (name, n) not in cache:
            model = _case(name, n)
            cd = model.density()
            lib, em = _host_library(cd, tmp_path_factory.mktemp("row_loop"))
            cache[name, n] = (model, cd, lib, em)
        return cache[name, n]

    return get


@pytest.mark.parametrize("name,n", CASES, ids=IDS)
def test_tiles_take_what_shared_memory_holds(name, n, built):
    """The case's tile is the size rule's, its rows fall where the case
    says (within one tile, ragged past one, several tiles), and two
    tiles fit a block's shared memory."""
    _, tile, counts = MODELS[name]
    _, cd, _, em = built(name, n)
    (space,) = em.spaces
    assert space.n_rows == n
    assert space.tile_rows == emit_cuda.tile_rows(space.row_width, n)
    assert space.tile_rows == min(tile, 1 << (n - 1).bit_length())
    where = counts.index(n)
    if where == 0:
        assert n < space.tile_rows
    else:
        assert n > space.tile_rows and n % space.tile_rows
        assert (n > 3 * space.tile_rows) == (where == 2)
    assert 2 * 4 * space.tile_rows * space.row_width <= \
        emit_cuda.SMEM_BYTES_MAX


@pytest.mark.parametrize("name,n", CASES, ids=IDS)
def test_density_matches_jax_and_plain_version(name, n, built):
    """The kernel's density through its tile loops, synchronous and
    streamed (the host build), and the plain version against JAX's
    logp_lanes_fn and jax.grad at the same q, with density_check's bars
    (test_torch_forms.py's); the mixture also within
    test_torch_marginal.py's bar against JAX (relative 1e-5, and 1e-5 of
    the largest |lp| and |g|)."""
    _, cd, lib, em = built(name, n)
    cdj = _case(name, n, rtj).density()
    q = _points(cd.n_vars, 3, 6).astype(np.float32)
    lp_ref, g_ref = _jax_lp_grad(cdj, q)
    cols = cd.column_values(torch.float32, "cpu")
    qt = torch.as_tensor(q)
    for stream in (False, True):
        lp, g = _host_logp_grad(lib, em, qt, cols, stream=stream)
        _density_bars(lp.numpy(), g.numpy(), lp_ref, g_ref)
        if name == "mixture":
            np.testing.assert_allclose(
                lp.numpy(), lp_ref, rtol=1e-5,
                atol=1e-5 * (1 + np.abs(lp_ref).max()))
            np.testing.assert_allclose(
                g.numpy(), g_ref, rtol=1e-5,
                atol=1e-5 * (1 + np.abs(g_ref).max()))
    lp_p, g_p = F.logp_grad_reference(cd, qt)
    _density_bars(lp_p.numpy(), g_p.numpy(), lp_ref, g_ref)
    _density_bars(lp.numpy(), g.numpy(), lp_p.numpy(), g_p.numpy())


@pytest.mark.parametrize("name,n", CASES, ids=IDS)
def test_host_kernel_matches_plain_version(name, n, built):
    """The kernel's loop (37 chains in blocks of 4, a warp each: a ragged
    block) against the plain version with explicit noise, with
    test_torch_forms.py's bar: the two sum rows in other orders, so at
    least 90% of chains end within 1e-3 and the accept rates agree
    within 0.05 on average."""
    model, cd, lib, _ = built(name, n)
    q0, kw, nz = _inputs(cd, model, 37, 8, "explicit")
    cols = cd.column_values(torch.float32, "cpu")
    got = _run_host(lib, cd, q0, kw, nz, cols)
    ref = F.fused_hmc_reference(cd, q0, noise=nz, **kw)
    rel = ((got[0] - ref[0]).abs() / ref[0].abs().clamp(min=1.0)).amax(0)
    assert float((rel <= 1e-3).float().mean()) >= 0.9, rel
    assert float((got[2] - ref[2]).abs().mean()) < 0.05


@pytest.mark.parametrize("name,n", CASES, ids=IDS)
def test_launches_repeat_and_stream_bit_for_bit(name, n, built):
    """Two launches from the same inputs give the same bits, and so does
    the streamed tile loop (the card's default): final q, draws, accept
    rates, divergences, and the density alone."""
    model, cd, lib, em = built(name, n)
    q0, kw, _ = _inputs(cd, model, 13, 4, "philox")
    cols = cd.column_values(torch.float32, "cpu")
    a = _run_host(lib, cd, q0, kw, None, cols)
    b = _run_host(lib, cd, q0, kw, None, cols)
    s = _run_host(lib, cd, q0, kw, None, cols, stream=True)
    for x, y, z in zip(a, b, s):
        assert torch.equal(x, y) and torch.equal(x, z)
    lp, g = _host_logp_grad(lib, em, q0, cols)
    lp_s, g_s = _host_logp_grad(lib, em, q0, cols, stream=True)
    assert torch.equal(lp, lp_s) and torch.equal(g, g_s)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_results_do_not_depend_on_chains_per_block(name, built,
                                                   monkeypatch):
    """A chain's arithmetic is its warp's alone (test_torch_lanes.py's
    case, on these two models past one tile): at 2, 4 and 8 chains a
    block the final q, draws, accept rates and divergences are the same
    bits."""
    n = MODELS[name][2][1]
    model, cd, lib, em = built(name, n)
    q0, kw, _ = _inputs(cd, model, 13, 4, "philox")
    cols = cd.column_values(torch.float32, "cpu")
    outs = []
    for w in (2, 4, 8):
        monkeypatch.setattr(F, "chains_per_block", lambda em, n, w=w: w)
        assert F.threads_per_block(em, 13) == 32 * w
        outs.append(_run_host(lib, cd, q0, kw, None, cols))
    for other in outs[1:]:
        for x, y in zip(outs[0], other):
            assert torch.equal(x, y)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_rows_a_step_give_one_row_at_a_time_bits(name, built, monkeypatch,
                                                 tmp_path):
    """A lane's rows summed 1, 2 and 4 at a step (ROW_STEP forced for the
    emission, whatever the row's width and operations) give the same
    bits: the step's
    reverse passes add every adjoint in row order, and the rows' values
    are added in row order."""
    n = MODELS[name][2][1]
    model, cd, _, _ = built(name, n)
    q0, kw, _ = _inputs(cd, model, 13, 3, "philox")
    outs = []
    for r in (1, 2, 4):
        monkeypatch.setattr(emit_cuda, "ROW_STEP", r)
        monkeypatch.setattr(emit_cuda, "ROW_STEP_FLOATS", 1 << 30)
        monkeypatch.setattr(emit_cuda, "ROW_STEP_OPS", 0)
        cd_r = _case(name, n).density()
        lib, em = _host_library(cd_r, tmp_path)
        assert ("rt_row_step" in em.source) == (r > 1)
        assert (f"#define RT_ROW_STEP {r}" in em.source) == (r > 1)
        outs.append(_run_host(lib, cd_r, q0, kw, None,
                              cd_r.column_values(torch.float32, "cpu")))
    for other in outs[1:]:
        for x, y in zip(outs[0], other):
            assert torch.equal(x, y)


@pytest.mark.parametrize("threads", [32, 128, 256])
def test_loader_fills_every_float_of_a_ragged_tile(threads, tmp_path,
                                                   monkeypatch):
    """The batched loader's share of a tile a thread: every thread walks
    every batch of rows, so that a wide column's floats of a batch whose
    rows end before the block's threads do are all loaded.  The host build
    runs each thread's share of a block of `threads` (the launch's blocks
    at 1, 4 and 8 chains a block) in turn: its density, synchronous and
    streamed, against the plain version with density_check's bars."""
    cd = wide_logistic(rtt).density()
    lib, em = _host_library(cd, tmp_path)
    (space,) = em.spaces
    assert (space.row_width, space.tile_rows) == (11, 2048)
    monkeypatch.setattr(F, "chains_per_block",
                        lambda em, n, w=threads // 32: w)
    q = torch.as_tensor(_points(cd.n_vars, 3, 5), dtype=torch.float32)
    cols = cd.column_values(torch.float32, "cpu")
    lp_p, g_p = F.logp_grad_reference(cd, q)
    for stream in (False, True):
        lp, g = _host_logp_grad(lib, em, q, cols, stream=stream)
        _density_bars(lp.numpy(), g.numpy(), lp_p.numpy(), g_p.numpy())


def test_emitted_rows():
    """The mixture's row: each shifted exponential of its LogSumExp is
    computed once and its adjoint reads it (two expf a row, none in the
    reverse pass) and divides it by the sum without a branch
    (rt_lse_share), and four rows make a step whose forward passes come
    before their reverse passes; the 32-feature MVNormal logistic's
    33-float row is summed one row at a time, too wide for a step's
    registers."""
    em = emit_cuda.emit(_case("mixture", 5000).density())
    src = em.source
    row = src[src.index("RT_HD float rt_row("):src.index("#define RT_ROW_STEP")]
    assert row.count("expf(") == 2 and row.count("logf(") == 1
    rev = row[row.index("+= 1.0f;"):]
    assert "expf(" not in rev and rev.count("rt_lse_share(e") == 2
    assert emit_cuda.row_step(em.row_width, em.row_ops) == 4
    assert em.row_ops >= emit_cuda.ROW_STEP_OPS
    assert "#define RT_ROW_STEP 4" in src
    step = src[src.index("RT_HD void rt_row_step("):]
    lines = step[:step.index("\n}\n")].splitlines()
    fwd_end = max(i for i, line in enumerate(lines)
                  if line.startswith("  const float v") and "_R3 =" in line)
    adds = [(i, line) for i, line in enumerate(lines)
            if line.startswith("  ainv[")]
    assert adds and min(i for i, _ in adds) > fwd_end
    for k in range(4):      # each entry's adds in row order
        entry = [re.search(r"_R(\d)", line).group(1) for _, line in adds
                 if line.startswith(f"  ainv[{k}]")]
        assert entry == sorted(entry) and len(entry) == 4
    em = emit_cuda.emit(_case("mvnormal_logistic", 700).density())
    assert em.row_width == 33 and em.row_ops >= emit_cuda.ROW_STEP_OPS
    assert emit_cuda.row_step(em.row_width, em.row_ops) == 1
    assert "rt_row_step" not in em.source and em.workspace


def _fma(a, b, c):
    """a·b + c in f64, rounded once (exactly, through rationals)."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _lse_share(e, s, seed):
    """rt_lse_share's arithmetic on the card (csrc/rt_math.cuh): from the
    reciprocal's seed, two Newton steps, the quotient and one correction
    in f64, rounded to f32 once."""
    r = seed(s)
    r = _fma(r, _fma(-s, r, 1.0), r)
    r = _fma(r, _fma(-s, r, 1.0), r)
    q = float(e) * r
    return np.float32(_fma(r, _fma(-s, q, float(e)), q))


@pytest.mark.parametrize("seed", ["f32", "f16"])
def test_lse_share_gives_the_f32_quotient(seed):
    """The card's LogSumExp share has the bits of the IEEE f32 division
    e / s over its domain (e in [0, 1], s >= 1): zero, one, normals,
    tiny normals and subnormals for e, sums just past 1 and up to 64 for
    s; from a reciprocal seed as coarse as f16's 11 bits (rcp.approx's is
    finer)."""
    rng = np.random.default_rng(17)
    tiny = np.float32(2.0) ** -126
    es = np.concatenate([
        np.float32([0.0, 1.0, tiny, tiny / 2, np.float32(2.0) ** -149,
                    np.float32(2.0) ** -140, 0.5, np.nextafter(np.float32(1),
                                                               np.float32(0))]),
        np.exp(rng.uniform(-110.0, 0.0, 3000)).astype(np.float32),
        rng.uniform(0.0, 1.0, 1000).astype(np.float32)])
    ss = np.concatenate([
        np.float32([1.0, np.nextafter(np.float32(1), np.float32(2)), 2.0, 3.0,
                    64.0]),
        (1.0 + np.exp(rng.uniform(-30.0, 0.0, 200))).astype(np.float32),
        rng.uniform(1.0, 64.0, 100).astype(np.float32)])
    pick = {"f32": lambda s: float(np.float32(1.0) / np.float32(s)),
            "f16": lambda s: float(np.float16(1.0 / s))}[seed]
    pairs = [(e, s) for e in es[:8] for s in ss] + list(zip(
        es, rng.choice(ss, es.size)))
    for e, s in pairs:
        want = np.float32(e) / np.float32(s)
        got = _lse_share(e, float(s), pick)
        assert got.view(np.uint32) == want.view(np.uint32), (e, s, got, want)
