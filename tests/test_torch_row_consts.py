"""The rows' data-only terms summed once a launch, not in every row.

A row's additive summands that read the columns and literals alone (the
count likelihoods' ``lgamma(y + 1)`` and ``lgamma(n + y)``, their
normalizing literals) are the same in every density call of a launch.
``compiler.RowSpace`` lists them for each root (``consts``) beside the
roots without them (``kept``), the emitter writes the rows without them
and ``rt_row_const`` with them, and the kernel sums that over each
space's rows once a launch into a double a space, which every density
call adds to its rows' f64 sum.  Checked here on the CPU:

* the summands, family by family, against their closed forms in scipy,
  and what stays in the row (the binomial's ``(10 - y)·log(1 - p)``, the
  zero-inflated geometric's ``LogSumExp``, a Normal's literal);
* the emitted rows of every count family hold no ``lgammaf``;
* with g++, the host build of ``csrc/fused_hmc.cu`` (the card's order of
  sums) against the JAX package's density at seeded points: the
  families, GLMMPoisson2 at 10 sites, and the same through the streamed
  tile loop, two row spaces and the workspace (GLMMPoisson2 at 30 sites,
  glmm_large at 300 groups), within the density bars of the other host
  tests (lp within rtol 1e-5 / atol 1e-5·(1 + |lp|), gradients within
  1e-5 of max |g|), and within twice the plain version's distance from
  f64;
* after ``Model.with_data`` under one build, the constant follows the new
  data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import gammaln

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu_torch.compute import emit_cuda
from rainier_tpu_torch.compute import interp
from rainier_tpu_torch.compute import real as Rt
from rainier_tpu_torch.compute.compiler import kernel_rows
from rainier_tpu_torch.ops import fused_hmc as F
from test_torch_columns import _host_library, _host_logp_grad
from test_torch_gather import glmm_poisson
from test_torch_large_models import _points as large_points
from test_torch_large_models import glmm_large

torch.set_num_threads(2)
rtt.config.set_device("cpu")

N_ROWS = 1000


def _counts(name, seed=0):
    rng = np.random.default_rng(sum(map(ord, name)) + seed)
    if name == "neg_binomial":
        return rng.negative_binomial(10, 0.7, N_ROWS).astype(float)
    if name == "binomial":
        return rng.binomial(10, 0.3, N_ROWS).astype(float)
    if name == "poisson":
        return rng.poisson(3.5, N_ROWS).astype(float)
    if name == "large_poisson":
        return rng.poisson(100.0, N_ROWS).astype(float)
    if name == "zero_inflated_geometric":
        v = rng.geometric(0.3, N_ROWS) - 1.0
        return np.where(rng.uniform(size=N_ROWS) < 0.3, 0.0, v)
    if name == "normal":
        return rng.normal(1.0, 2.0, N_ROWS)
    raise KeyError(name)


# name: (build(rt, data) of a model whose likelihood is the family over the
# rows, the row's data-only part as a numpy f64 function of the data, or
# None where the row keeps every term): the zoo's families
# (chip_smoke.zoo) with their priors
FAMILIES = {
    "neg_binomial": (
        lambda rt, y: rt.Model.observe(
            y, rt.NegativeBinomial(rt.Uniform(0, 1).latent(), 10.0)),
        lambda y: gammaln(10.0 + y) - gammaln(y + 1.0) - gammaln(10.0)),
    "binomial": (
        lambda rt, y: rt.Model.observe(
            y, rt.Binomial(rt.Beta(1.0, 1.0).latent(), 10.0)),
        lambda y: gammaln(11.0) - gammaln(y + 1.0) - gammaln(11.0 - y)),
    "poisson": (
        lambda rt, y: rt.Model.observe(
            y, rt.Poisson(rt.Gamma(2.0, 2.0).latent())),
        lambda y: -gammaln(y + 1.0)),
    "large_poisson": (
        lambda rt, y: rt.Model.observe(
            y, rt.Poisson(rt.Gamma(2.0, 50.0).latent())),
        lambda y: -gammaln(y + 1.0)),
    "zero_inflated_geometric": (
        lambda rt, y: rt.Model.observe(
            y, rt.Geometric(rt.Uniform(0, 1).latent()).zero_inflated(0.3)),
        None),
    "normal": (
        lambda rt, y: rt.Model.observe(
            y, rt.Normal(rt.Normal(0, 1).latent(),
                         rt.Exponential(1.0).latent())),
        None),
}
COUNT_FAMILIES = sorted(k for k, (_, part) in FAMILIES.items() if part)


def _family(rt, name, seed=0):
    return FAMILIES[name][0](rt, _counts(name, seed))


# the GLMMs: (build(rt), the column of counts their Poisson reads)
GLMMS = {
    "glmm 10x6": lambda rt: glmm_poisson(rt, 10, 6)[0],
    "glmm 30x11": lambda rt: glmm_poisson(rt, 30, 11)[0],
    "glmm_large 300": lambda rt: glmm_large(rt, 300),
}


def _summands_f64(cd, space):
    """Each root's data-only summands, signed and summed, as numpy f64 over
    the space's rows (the port's lanes evaluator in f64)."""
    env = {}
    for c in cd.columns:
        env[c.id] = torch.as_tensor(
            c.values, dtype=torch.int32 if isinstance(c, Rt.IntColumn)
            else torch.float64).reshape((-1, 1) if isinstance(c, Rt.Column)
                                        else c.values.shape)
    terms = [t for root in space.consts for t in root]
    vals = interp.evaluate_lanes([n for _, n in terms], env,
                                 interp.torch_backend("cpu"), torch.float64)
    total = np.zeros(space.n_rows)
    for (sign, _), v in zip(terms, vals):
        total += sign * np.broadcast_to(v.numpy().reshape(-1), total.shape)
    return total


def _has_lgamma(nodes):
    return any(isinstance(n, Rt.Unary) and n.op == "lgamma"
               for n in Rt.topological(list(nodes)))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_summands_are_the_data_only_terms(name):
    """Each family's summands sum to its closed-form data-only part at
    every row, within 1e-9 relative in f64 (the negative binomial: both
    lgamma terms and its literal lgamma(10); the binomial: lgamma(11) and
    its two lgamma terms; the Poissons: lgamma(y + 1)), and what the row
    keeps calls no lgamma; the zero-inflated geometric (a LogSumExp) and
    a Normal (a literal alone) keep every term."""
    cd = _family(rtt, name).density()
    (space,) = cd.row_split().spaces
    part = FAMILIES[name][1]
    if part is None:
        assert space.consts == () and space.kept == ()
        assert kernel_rows(space, cd.columns) is space
        return
    y = cd.columns[0].values
    np.testing.assert_allclose(_summands_f64(cd, space), part(y),
                               rtol=1e-9, atol=1e-9)
    assert _has_lgamma(space.roots) and not _has_lgamma(space.kept)
    rows = kernel_rows(space, cd.columns)
    assert rows.roots == space.kept and rows.consts == ()
    assert rows.columns == space.columns


def test_binomial_keeps_its_data_only_factor():
    """The binomial's (10 - y), a data-only subtree under a multiply by
    log(1 - p), stays in the row: only additive summands leave it."""
    cd = _family(rtt, "binomial").density()
    (space,) = cd.row_split().spaces
    factors = [n for n in Rt.topological(list(space.kept))
               if isinstance(n, Rt.Binary) and n.op == "mul"
               and any(isinstance(k, Rt.Binary) and k.op == "sub"
                       and isinstance(k.left, Rt.Constant)
                       and isinstance(k.right, Rt.Column)
                       for k in (n.left, n.right))]
    assert factors
    (summands,) = space.consts
    assert len(summands) == 1 and summands[0][0] == 1


@pytest.mark.parametrize("name", sorted(GLMMS))
def test_glmm_summands_are_lgamma_of_the_counts(name):
    """GLMMPoisson2 and glmm_large: -lgamma(y + 1) of the counts leaves
    the row; the year polynomial's data-only y² and y³, factors of the
    effects, stay."""
    cd = GLMMS[name](rtt).density()
    (space,) = cd.row_split().spaces
    counts = [c for c in cd.columns if isinstance(c, Rt.Column)
              and np.all(c.values == np.round(c.values))
              and c.values.max() > 1][-1]
    np.testing.assert_allclose(_summands_f64(cd, space),
                               -gammaln(counts.values + 1.0), rtol=1e-9)
    assert not _has_lgamma(space.kept)
    if name.startswith("glmm "):
        cubes = [n for n in Rt.topological(list(space.kept))
                 if isinstance(n, Rt.Binary) and n.op == "mul"
                 and isinstance(n.left, Rt.Binary)
                 and isinstance(n.right, Rt.Column)]
        assert cubes


@pytest.mark.parametrize("name", [*COUNT_FAMILIES, *sorted(GLMMS)])
def test_emitted_rows_call_no_lgammaf(name):
    """The row functions of every count family and GLMM call no lgammaf;
    rt_row_const holds them, and the header says so."""
    model = GLMMS[name](rtt) if name in GLMMS else _family(rtt, name)
    em = emit_cuda.emit(model.density())
    src = em.source
    assert "#define RT_ROW_CONSTS 1" in src
    row = src[src.index("RT_HD float rt_row("):]
    row = row[:row.index("\n}\n")]
    const = src[src.index("RT_HD float rt_row_const("):]
    const = const[:const.index("\n}\n")]
    assert "lgammaf" not in row and "lgammaf" in const
    assert "rt_row_step" not in src or "lgammaf" not in src[
        src.index("RT_HD void rt_row_step("):src.index(
            "RT_HD float rt_row_const(")]
    assert em.spaces[0].const_ops > 0
    assert em.const_ops() == em.spaces[0].n_rows * em.spaces[0].const_ops


@pytest.mark.parametrize("name", ["zero_inflated_geometric", "normal"])
def test_rows_without_summands_emit_no_pass(name):
    em = emit_cuda.emit(_family(rtt, name).density())
    assert "RT_ROW_CONSTS" not in em.source
    assert "rt_row_const" not in em.source and em.const_ops() == 0


# -- the host build ------------------------------------------------------------


def _points(n_vars, k, seed):
    return np.random.default_rng(seed).normal(
        scale=0.5, size=(n_vars, k)).astype(np.float32)


def _jax_lp_grad(cdj, q):
    """The JAX package's lanes density and its gradient at the columns of
    q (dim, k), f32."""
    lanes, cols = cdj.logp_lanes_fn(), cdj.column_values(jnp.float32)
    qj = jnp.asarray(q)
    lp = lanes(qj, cols)
    g = jax.grad(lambda qq: lanes(qq, cols).sum())(qj)
    return np.asarray(lp), np.asarray(g)


def _f64_lp(cd, q):
    cols = cd.column_values(torch.float32, "cpu")
    cols64 = tuple(c.double() if c.is_floating_point() else c for c in cols)
    return F._lp_grad_fn(cd, cols64)(torch.as_tensor(q).double())[0].numpy()


def _check(lp, g, lp_ref, g_ref):
    np.testing.assert_allclose(lp, lp_ref, rtol=1e-5,
                               atol=1e-5 * (1 + np.abs(lp_ref).max()))
    np.testing.assert_allclose(g, g_ref, rtol=0,
                               atol=1e-5 * np.abs(g_ref).max())


def _host_against_jax(build, tmp_path, seed, stream=False, scale=None):
    """The host build's lp and g at 5 seeded points against the JAX
    package's density and the plain version's distance from f64; returns
    the host build's (lp, g) and the emitted density."""
    cd, cdj = build(rtt).density(), build(rtj).density()
    lib, em = _host_library(cd, tmp_path)
    q = _points(cd.n_vars, 5, seed) if scale is None else scale(cd.n_vars)
    cols = cd.column_values(torch.float32, "cpu")
    lp, g = _host_logp_grad(lib, em, torch.as_tensor(q), cols, stream)
    lp_j, g_j = _jax_lp_grad(cdj, q)
    _check(lp.numpy(), g.numpy(), lp_j, g_j)
    lp_p = F.logp_grad_reference(cd, torch.as_tensor(q), cols)[0].numpy()
    lp_64 = _f64_lp(cd, q)
    # what the rows keep summed in f64 every 8 rows (the terms that
    # cancelled in them summed once): within twice the plain version's
    # distance from f64, and four f32 ulps of lp
    ulp = np.spacing(np.abs(lp_64).astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(lp.numpy() - lp_64)
                  <= 2 * np.abs(lp_p - lp_64) + 4 * ulp), (lp, lp_64)
    return lp, g, em


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_host_density_matches_jax(name, tmp_path):
    """Each family through the kernel's density function and tile loop,
    with its data-only terms from the pass once a launch."""
    _host_against_jax(lambda rt: _family(rt, name), tmp_path, 1)


@pytest.mark.parametrize("name", ["neg_binomial", "binomial",
                                  "large_poisson"])
def test_host_density_streamed_matches_synchronous_and_jax(name, tmp_path):
    """The streamed tile loop: the synchronous loop's bits, and JAX's
    density within the bars."""
    build = (lambda rt: _family(rt, name))
    lp_s, g_s, _ = _host_against_jax(build, tmp_path, 2, stream=True)
    lp, g, _ = _host_against_jax(build, tmp_path, 2)
    assert torch.equal(lp_s, lp) and torch.equal(g_s, g)


def _two_spaces(rt):
    """A negative binomial over 300 rows and a large Poisson over 700, one
    latent each: two row spaces, each with its own data-only terms."""
    nb = _counts("neg_binomial")[:300]
    lp = _counts("large_poisson")[:700]
    return rt.Model.observe(
        nb, rt.NegativeBinomial(rt.Uniform(0, 1).latent(), 10.0)).merge(
        rt.Model.observe(lp, rt.Poisson(rt.Gamma(2.0, 50.0).latent())))


def test_host_density_over_two_row_spaces_matches_jax(tmp_path):
    lp, _, em = _host_against_jax(_two_spaces, tmp_path, 3)
    assert len(em.spaces) == 2 and all(s.const_ops for s in em.spaces)
    assert "static RT_HD float row_const(" in em.source
    assert "#define RT_SPACES 2" in em.source


@pytest.mark.parametrize("name", sorted(GLMMS))
def test_host_glmm_density_matches_jax(name, tmp_path):
    """GLMMPoisson2 at 10 sites (state in registers) and 30 (the
    workspace), and glmm_large at 300 groups (the workspace, near its
    data)."""
    if name.startswith("glmm_large"):
        def scale(n):
            return large_points(300, 5, 2)
    else:
        def scale(n):
            return _points(n, 5, 4) * np.float32(0.3)
    lp, g, em = _host_against_jax(GLMMS[name], tmp_path, 4, scale=scale)
    assert bool(em.workspace) == (name != "glmm 10x6")
    assert torch.isfinite(lp).all() and torch.isfinite(g).all()


def _counts_column(cd):
    """The column of counts a family's or a GLMM's Poisson reads: the last
    float column of whole numbers past 1."""
    return [c for c in cd.columns if not isinstance(c, (Rt.IntColumn,
                                                         Rt.MatColumn))
            and np.all(np.asarray(c.values) == np.round(c.values))
            and np.asarray(c.values).max() > 1][-1]


@pytest.mark.parametrize("name", ["neg_binomial", "glmm 30x11"])
def test_constant_follows_with_data_under_one_build(name, tmp_path):
    """Model.with_data swaps the counts under one build: the same library,
    its pass over the rows reading the new counts, against the JAX
    package's model conditioned on the same new counts."""
    build = GLMMS[name] if name in GLMMS else (
        lambda rt: _family(rt, name))
    model, model_j = build(rtt), build(rtj)
    cd = model.density()
    lib, em = _host_library(cd, tmp_path)
    q = _points(cd.n_vars, 4, 5) * (0.3 if name in GLMMS else 1.0)
    q = torch.as_tensor(q)
    lp0, _ = _host_logp_grad(lib, em, q, cd.column_values(torch.float32,
                                                          "cpu"))
    counts = _counts_column(cd)
    rng = np.random.default_rng(11)
    new = rng.permutation(counts.values) + rng.integers(0, 3, counts.n_rows)
    model.with_data({counts: new})
    model_j.with_data({_counts_column(model_j.density()): new})
    assert emit_cuda.emit(cd).source == em.source
    lp1, g1 = _host_logp_grad(lib, em, q, cd.column_values(torch.float32,
                                                           "cpu"))
    lp_j, g_j = _jax_lp_grad(model_j.density(), q.numpy())
    _check(lp1.numpy(), g1.numpy(), lp_j, g_j)
    assert not torch.allclose(lp0, lp1)
