"""Integer index columns in the port: ``Poisson``, the ``IntColumn``
field of the row tile, and the per-row ``Gather`` (and ``Lookup``) by it,
held against the JAX package on GLMMPoisson2.

GLMMPoisson2 is built through both packages by one ``glmm_poisson(rt, R,
n_sites, n_years)``, a copy of ``benchmarks/models.py:111-142`` with its
sizes as arguments; f32 throughout.  Checked here, with the tolerance and
its reason at each assertion:

* ``Poisson`` against the JAX package's and scipy's, v = 0 included;
* the full-size model (100 sites × 40 years, 146 parameters) against
  ``jax.value_and_grad``, and ``logp_lanes_split_fn`` on a masked last
  tile;
* ``csrc/fused_hmc.cu`` compiled for the host with g++: the density
  through the tile loop against autograd and ``jax.grad``, indices out of
  range (clamped as ``jnp.take(mode="clip")``), a ``Lookup`` by an
  ``IntColumn``, and the kernel's loop against the plain version;
* ``fused_hmc_reference`` against the JAX kernel in interpret mode with
  the same noise;
* ``Model.sample(kernel="fused!")`` against the scan path, and the
  emitter's caps.
"""

import re

import numpy as np
import pytest
from scipy.stats import poisson

import jax
import jax.numpy as jnp
import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu.compute import real as Rj
from rainier_tpu.ops import fused_hmc as fused_hmc_jax
from rainier_tpu_torch.compute import emit_cuda
from rainier_tpu_torch.compute import real as Rt
from rainier_tpu_torch.ops import fused_hmc as F
from rainier_tpu_torch.sampler import HMC, SamplerConfig
from rainier_tpu_torch.sampler.driver import (_fused_unsupported_reason,
                                              _verify_split)
from test_torch_columns import (_host_library, _host_logp_grad, _jax_noise,
                                _run_host)

torch.set_num_threads(2)
rtt.config.set_device("cpu")


def _R(rt):
    return Rj if rt is rtj else Rt


def glmm_poisson(rt, n_sites=100, n_years=40, seed=4):
    """benchmarks/models.py:111-142 with its sizes as arguments: year
    polynomial + per-year eps + per-site alphas, counts indexed by (year,
    site) through two IntColumn gathers.  Returns (model, log_rate), where
    log_rate(j, k) is year j's and site k's log λ as a column-free Real."""
    R = _R(rt)
    rng = np.random.default_rng(seed)
    years = np.linspace(-0.95, 0.95, n_years)
    mu = rt.Normal(0, 10).latent()
    sd_alpha = rt.Uniform(0, 2).latent()
    alphas = rt.Normal(mu, sd_alpha).latent_vec(n_sites)
    sd_year = rt.Uniform(0, 1).latent()
    betas = rt.Normal(0, 10).latent_vec(3)
    eps = rt.Normal(0.0, sd_year).latent_vec(n_years)

    year_col = R.Column(np.repeat(years, n_sites))
    year_idx = R.IntColumn(np.repeat(np.arange(n_years), n_sites))
    site_idx = R.IntColumn(np.tile(np.arange(n_sites), n_years))
    year_effect = (year_col * betas[0] + year_col * year_col * betas[1]
                   + year_col * year_col * year_col * betas[2]
                   + R.Gather(eps.element, year_idx))
    log_lam = year_effect + R.Gather(alphas.element, site_idx)
    true_sites = rng.normal(np.log(20.0), 0.4, size=n_sites)
    true_eps = rng.normal(0.0, 0.2, size=n_years)
    true_log_lam = (np.repeat(true_eps - 0.1 * years, n_sites)
                    + np.tile(true_sites, n_years))
    counts = rng.poisson(np.exp(true_log_lam)).astype(float)
    n_obs = n_years * n_sites
    lh = R.RowSum(rt.Poisson(log_lam.exp()).log_density_at(
        R.Column(counts)), n_obs)

    def log_rate(j, k):
        y = float(years[j])
        return (betas[0] * y + betas[1] * (y * y) + betas[2] * (y * y * y)
                + eps[j] + alphas[k])

    return rt.Model.likelihood(lh), log_rate


def clamped_gather(rt):
    """Indices below 0 and at or past K = 4: the gather clamps them."""
    R = _R(rt)
    effects = rt.Normal(0, 1).latent_vec(4)
    idx = R.IntColumn(np.array([-1, 0, 3, 4, 2, 7, -5, 1] * 41))
    y = np.random.default_rng(8).normal(size=328)
    return rt.Model.likelihood(R.RowSum(rt.Normal(
        R.Gather(effects.element, idx) * 2.0, 1.0).log_density_at(
            R.Column(y)), 328))


def lookup_by_int_column(rt):
    """A Lookup whose index is an IntColumn, low = 1: index 0 and 5 fall
    outside the 4-entry table and give 0."""
    R = _R(rt)
    table = [rt.Normal(0, 1).latent() for _ in range(4)]
    idx = R.IntColumn(np.array([1, 2, 3, 4, 0, 5, 2] * 41))
    y = np.random.default_rng(9).normal(size=287)
    mean = R.Lookup(idx, table, low=1) + table[0] * 0.5
    return rt.Model.likelihood(R.RowSum(
        rt.Normal(mean, 1.5).log_density_at(R.Column(y)), 287))


def small_glmm(rt):
    """30 sites × 11 years: 330 rows, a full 256-row tile and a ragged
    one; 47 parameters."""
    return glmm_poisson(rt, 30, 11)[0]


HOST_MODELS = {"glmm": small_glmm, "clamped_gather": clamped_gather,
               "lookup": lookup_by_int_column}


def _points(n_vars, seed, k, scale=0.3):
    return np.random.default_rng(seed).normal(size=(n_vars, k)) * scale


# -- Poisson and the full-size density against JAX ---------------------------


def test_poisson_matches_jax_and_scipy():
    """Poisson(exp(θ)).log_density_at(v), v = 0 included, against the JAX
    package's at the same θ and scipy's logpmf in f64: f32 sums of 7
    terms whose largest is |v·θ| ~ 50, so rtol 1e-5 and atol 1e-4."""
    counts = np.array([0.0, 1.0, 2.0, 5.0, 0.0, 17.0, 40.0])

    def build(rt):
        theta = rt.Normal(0, 1).latent()
        return rt.Model.likelihood(_R(rt).RowSum(
            rt.Poisson(theta.exp()).log_density_at(_R(rt).Column(counts)),
            len(counts))), theta

    (mt, _), (mj, _) = build(rtt), build(rtj)
    for theta in (-1.5, 0.0, 0.7, 2.5):
        lp_t, g_t = mt.density().logp_and_grad(np.array([theta]))
        lp_j, g_j = mj.density().logp_and_grad(jnp.array([theta]))
        prior = -0.5 * theta ** 2 - 0.5 * np.log(2 * np.pi)
        want = poisson.logpmf(counts, np.exp(theta)).sum() + prior
        for lp in (float(lp_j), want):
            np.testing.assert_allclose(float(lp_t), lp, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5,
                                   atol=1e-4)


def test_full_size_glmm_matches_jax():
    """GLMMPoisson2 at 100 sites × 40 years: 146 parameters, 4000 rows.
    The port's logp and gradient (autograd on the lanes evaluator)
    against jax.value_and_grad at seeded points: f32 sums of 4000 terms
    in other orders, so rtol 1e-5 / atol 1e-5·(1 + |lp|), and gradients
    within 1e-5 of max |g|."""
    mt, mj = glmm_poisson(rtt)[0], glmm_poisson(rtj)[0]
    cdt, cdj = mt.density(), mj.density()
    assert cdt.n_vars == cdj.n_vars == 146
    q = _points(cdt.n_vars, 1, 4).astype(np.float32)
    cols = cdt.column_values(torch.float32, "cpu")
    assert [c.dtype for c in cols] == [torch.float32, torch.int32,
                                       torch.int32, torch.float32]
    lp_t, g_t = cdt.batched_logp_and_grad_fn()(torch.as_tensor(q.T), cols)
    lp_j, g_j = jax.vmap(jax.value_and_grad(cdj.logp_fn()),
                         in_axes=(0, None))(jnp.asarray(q.T),
                                            cdj.column_values(jnp.float32))
    lp_j, g_j = np.asarray(lp_j), np.asarray(g_j)
    np.testing.assert_allclose(lp_t.numpy(), lp_j, rtol=1e-5,
                               atol=1e-5 * (1 + np.abs(lp_j).max()))
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0,
                               atol=1e-5 * np.abs(g_j).max())


@pytest.mark.parametrize("name", ["glmm", "clamped_gather", "lookup"])
def test_split_matches_jax_on_a_masked_last_tile(name):
    """base_fn and tile_fn with int columns in the tile, against the JAX
    package's, on the last tile of a 64-row tiling padded past the data
    by repeating row 0 and masked there, as the JAX kernel pads: f32 sums
    of up to 64 terms in other orders, rtol 1e-5 / atol 1e-5·(1 +
    |value|)."""
    cdj, cdt = HOST_MODELS[name](rtj).density(), \
        HOST_MODELS[name](rtt).density()
    base_j, tile_j = cdj.logp_lanes_split_fn()
    base_t, tile_t = cdt.logp_lanes_split_fn()
    qb = _points(cdt.n_vars, 1, 6).astype(np.float32)
    got, want = base_t(torch.as_tensor(qb)), base_j(jnp.asarray(qb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * (1 + np.abs(want).max()))
    cols = [np.asarray(c) for c in cdj.column_values(jnp.float32)]
    n, r = cols[0].shape[0], 64
    a = (n - 1) // r * r
    assert a + r > n
    tile = [np.concatenate([c[a:], np.repeat(c[:1], a + r - n, axis=0)])
            for c in cols]
    mask = (np.arange(a, a + r) < n).astype(np.float32)[:, None]
    got = tile_t(torch.as_tensor(qb), torch.as_tensor(mask),
                 tuple(torch.as_tensor(c) for c in tile))
    want = tile_j(jnp.asarray(qb), jnp.asarray(mask),
                  tuple(jnp.asarray(c) for c in tile))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * (1 + np.abs(want).max()))


@pytest.mark.parametrize("name", sorted(HOST_MODELS))
def test_split_identity_holds_over_the_kernel_tiles(name):
    """base + Σ tiles == the whole density with int columns in the tiles
    (sampler/driver.py checks this before a launch) at 256 and 7 rows."""
    cd = HOST_MODELS[name](rtt).density()
    cols = cd.column_values(torch.float32, "cpu")
    assert _verify_split(cd, cols, 256) and _verify_split(cd, cols, 7)


# -- the emitted code, compiled for the host ---------------------------------


def test_emitted_gather_reads_and_scatters_the_invariant_block():
    """Each gather clamps its int32 index, reads inv at its block's
    offset and scatters its adjoint there: GLMMPoisson2, a model with
    rows past emit_cuda.LANE_STATE_MAX parameters, keeps its state in the
    workspace, so its row hands each gather's entry and adjoint to the
    warp (sidx/sval), which adds them into ainv; the index columns are
    int32 fields of RtCols, carried bit for bit in the tile."""
    em = emit_cuda.emit(glmm_poisson(rtt)[0].density())
    assert (em.n_vars, em.n_rows, em.row_width, em.tile_rows) == (
        146, 4000, 4, 4096)
    src = em.source
    assert "#define RT_NINV 143" in src     # 3 betas, 40 eps, 100 alphas
    assert src.count("const int* c") == 2
    # the two index columns copied into the tile as they are, bits and all
    loader = src[src.index("RT_HD void rt_fill_tile("):]
    ints = [j for j, c in enumerate(glmm_poisson(rtt)[0].density().columns)
            if type(c).__name__ == "IntColumn"]
    assert len(ints) == 2 and all(
        f"&cols.c{j}[row0 + i]);" in loader for j in ints)
    assert "rt_clampi(rt_bits_int(x[1]), 0, 39)" in src
    assert "rt_clampi(rt_bits_int(x[2]), 0, 99)" in src
    assert em.workspace and "#define RT_GATHERS 2" in src
    assert src.count("sidx[1] = 3 + j") == 1       # eps, by year
    assert src.count("sidx[0] = 43 + j") == 1      # alphas, by site
    # the row ops count the two gathers (clamp, address) and scatters
    assert F.op_count(em, 5) > 5 * em.n_rows * em.row_ops


@pytest.mark.parametrize("name", sorted(HOST_MODELS))
def test_host_compiled_density_matches_autograd_and_jax(name, tmp_path):
    """The kernel's density function through its tile loop, int columns
    in the tile, against torch autograd and jax.grad of the JAX package's
    lanes evaluator (the one its kernel runs): the same f32 terms summed
    in other orders, so lp within rtol 1e-5 / atol 1e-5·(1 + |lp|) and
    gradients within 1e-5 of max |g|.  The clamped gather and the Lookup
    hold indices out of range, so this also checks that the kernel clamps
    as jnp.take(mode="clip") does and that the Lookup gives 0 outside its
    table, as the lanes evaluators do (the JAX package's scalar
    evaluator, logp_fn, gives NaN there: jnp.take_along_axis fills)."""
    mt, mj = HOST_MODELS[name](rtt), HOST_MODELS[name](rtj)
    cd, cdj = mt.density(), mj.density()
    lib, em = _host_library(cd, tmp_path)
    q = torch.as_tensor(_points(cd.n_vars, 2, 5), dtype=torch.float32)
    cols = cd.column_values(torch.float32, "cpu")
    lp, g = _host_logp_grad(lib, em, q, cols)
    lp_t, g_t = cd.batched_logp_and_grad_fn()(q.T.contiguous(), cols)
    lanes_j, cols_j = cdj.logp_lanes_fn(), cdj.column_values(jnp.float32)
    qj = jnp.asarray(q.numpy())
    lp_j = lanes_j(qj, cols_j)
    g_j = jax.grad(lambda qq: lanes_j(qq, cols_j).sum())(qj).T
    for lp_ref, g_ref in ((lp_t.numpy(), g_t.numpy()),
                          (np.asarray(lp_j), np.asarray(g_j))):
        np.testing.assert_allclose(lp.numpy(), lp_ref, rtol=1e-5,
                                   atol=1e-5 * (1 + np.abs(lp_ref).max()))
        np.testing.assert_allclose(g.numpy().T, g_ref, rtol=0,
                                   atol=1e-5 * np.abs(g_ref).max())


def test_out_of_range_indices_clamp_as_jnp_take_clip():
    """The clamped gather's density equals the same model with its
    indices clamped to [0, 3] beforehand, in both packages (the same
    f32 operations on the same values: exact)."""
    def clipped(rt):
        R = _R(rt)
        effects = rt.Normal(0, 1).latent_vec(4)
        idx = R.IntColumn(np.clip([-1, 0, 3, 4, 2, 7, -5, 1] * 41, 0, 3))
        y = np.random.default_rng(8).normal(size=328)
        return rt.Model.likelihood(R.RowSum(rt.Normal(
            R.Gather(effects.element, idx) * 2.0, 1.0).log_density_at(
                R.Column(y)), 328))

    q = _points(4, 3, 1)[:, 0]
    for rt in (rtt, rtj):
        a = clamped_gather(rt).density().logp(q)
        b = clipped(rt).density().logp(q)
        assert float(a) == float(b)


@pytest.mark.parametrize("noise", ["explicit", "philox"])
def test_host_compiled_kernel_glmm_matches_plain_version(noise, tmp_path):
    """The kernel's loop on the 330-row GLMM (a ragged last tile) against
    the plain version, 13 chains (ragged), per-chain ε and Σ̂, from
    points near the data's log-rates.  The two sum the rows in other
    orders, so ≥ 90% of chains end within 1e-3 (a flipped borderline
    accept sends a chain away) and accept rates agree within 0.05 on
    average."""
    model = small_glmm(rtt)
    cd = model.density()
    lib, em = _host_library(cd, tmp_path)
    assert em.n_rows % em.tile_rows != 0
    n, n_it, dim = 13, 12, cd.n_vars
    q0, eps, imd = _warmed_up(model, n)
    rng = np.random.default_rng(2)
    kw = dict(step_size=eps * torch.as_tensor(rng.uniform(0.8, 1.2, n),
                                              dtype=torch.float32),
              n_steps=4, n_iterations=n_it, seed=9, collect_every=1,
              inv_mass_diag=imd)
    nz = (torch.as_tensor(rng.normal(size=(n_it, dim, n)),
                          dtype=torch.float32),
          torch.as_tensor(rng.uniform(1e-6, 1.0, (n_it, n)),
                          dtype=torch.float32)) \
        if noise == "explicit" else None
    cols = cd.column_values(torch.float32, "cpu")
    got = _run_host(lib, cd, q0, kw, nz, cols)
    ref = F.fused_hmc_reference(cd, q0, noise=nz, **kw)
    rel = ((got[0] - ref[0]).abs() / ref[0].abs().clamp(min=1.0)).amax(0)
    assert float((rel <= 1e-3).float().mean()) >= 0.9, rel
    assert float((got[2] - ref[2]).abs().mean()) < 0.05
    assert 0.2 < float(ref[2].mean())     # the chains do move


def _warmed_up(model, n):
    """q0 (dim, n), ε (n,) and Σ̂ (n, dim) from a short scan-path run:
    the sampling phase's inputs where the chains have found the data."""
    tr = model.sample(SamplerConfig(150, 10, sampler=HMC(5)), n_chains=n,
                      seed=3)
    return (torch.as_tensor(tr.chains[:, -1, :].T.copy()),
            torch.as_tensor(tr.step_size, dtype=torch.float32),
            torch.as_tensor(tr.mass.diag, dtype=torch.float32))


# -- the plain version against the JAX kernel --------------------------------


def test_plain_version_matches_pallas_kernel_on_a_glmm():
    """fused_hmc_reference on a 6-site × 5-year GLMM against the JAX
    package's kernel, untiled (row_tile 0: lp_fn is its logp_lanes_fn,
    the index columns cast to f32 inside as the kernel casts them),
    interpreted with the same noise: ≥ 90% of chains within 1e-3 and
    accept rates within 0.05, the bar of test_torch_columns.py for sums
    in other orders."""
    n, n_it, seed = 128, 20, 5
    mj, _ = glmm_poisson(rtj, 6, 5)
    mt, _ = glmm_poisson(rtt, 6, 5)
    cdj, cdt = mj.density(), mt.density()
    lanes = cdj.logp_lanes_fn()
    q0, eps, imd = _warmed_up(mt, n)
    kw = dict(step_size=eps.numpy(), n_steps=5, n_iterations=n_it,
              seed=seed, inv_mass_diag=imd.numpy(), collect_every=1)
    qf_j, _, acc_j, div_j = fused_hmc_jax(
        lambda q, *cols: lanes(q, cols), jnp.asarray(q0.numpy()),
        block_chains=n, interpret=True, host_rng=True,
        columns=cdj.column_values(jnp.float32), **kw)
    qf, _, acc, div = F.fused_hmc_reference(
        cdt, q0, noise=_jax_noise(seed, n_it, cdt.n_vars, n),
        **{**kw, "step_size": eps, "inv_mass_diag": imd})
    per_chain = np.max(np.abs(qf.numpy() - np.asarray(qf_j)), axis=0)
    assert np.mean(per_chain < 1e-3) >= 0.90, per_chain
    assert np.max(np.abs(acc.numpy() - np.asarray(acc_j))) < 0.05
    assert float(np.sum(div.numpy())) == float(np.sum(np.asarray(div_j)))
    assert 0.2 < float(np.mean(acc.numpy()))


# -- the wrapper, sampler/driver.py and the caps -----------------------------


def test_wrapper_takes_int32_index_columns_only():
    cd = small_glmm(rtt).density()
    cols = list(cd.column_values(torch.float32, "cpu"))
    q = torch.zeros(cd.n_vars, 3)
    kw = dict(step_size=0.01, n_steps=1, n_iterations=1, seed=0)
    F.fused_hmc(cd, q, columns=cols, **kw)
    for bad in (cols[1].float(), cols[1].long(), cols[1][:-1]):
        with pytest.raises(ValueError, match="IntColumn columns must be "
                                             "contiguous int32"):
            F.fused_hmc(cd, q, columns=[cols[0], bad] + cols[2:], **kw)


def test_fused_sample_on_a_glmm_matches_scan():
    """Model.sample(kernel="fused!") on a 3-site × 4-year GLMM runs the
    kernel's plain version over int columns (counterpart of
    test_pallas.py:185-204).  Both calls share seed 0, so warmup and its
    product are the same and only the sampling phases' random numbers
    differ.  Each cell's log-rate (its year effect plus its site effect:
    what the data identify, posterior SD 0.11 to 0.17) has its mean
    within 0.08 of the scan path's: 8 chains × 200 autocorrelated draws
    give each mean a Monte-Carlo error of 0.01 to 0.02, and this is the
    largest of 12 differences of two such means.  Against the data's log
    counts, each within 0.6 (Poisson noise of a count near 20 is 0.22 on
    the log scale, plus shrinkage)."""
    model, log_rate = glmm_poisson(rtt, 3, 4)
    cfg = SamplerConfig(warmup_iterations=200, iterations=200,
                        sampler=HMC(6))
    assert _fused_unsupported_reason(model, cfg, 8, None) is None
    tr_scan = model.sample(cfg, n_chains=8, seed=0)
    tr_fused = model.sample(cfg, n_chains=8, seed=0, kernel="fused!")
    assert tr_fused.chains.shape == (8, 200, 13)
    assert np.all(np.isfinite(tr_fused.chains))
    counts = model.density().columns[-1].values.reshape(4, 3)
    for j in range(4):
        for k in range(3):
            a, b = tr_scan.mean(log_rate(j, k)), \
                tr_fused.mean(log_rate(j, k))
            assert abs(a - b) < 0.08, (j, k, a, b)
            assert abs(b - np.log(counts[j, k])) < 0.6, (j, k, b)
    assert float(np.mean(tr_fused.accept_rate())) > 0.5


def test_caps_refuse_larger_models_naming_the_size(monkeypatch):
    """The old caps (256 parameters, 256 row-invariant values) now split
    the two layouts of the kernel's state: past them a model emits with
    its state in the workspace and its vectors as loops, and the glmm at
    10,000 sites (benchmarks/models.py::glmm_large's size) emits.  What
    bounds a model is the workspace: a run whose workspace exceeds the
    device's free memory is refused, naming the bytes."""
    k = emit_cuda.LOCAL_STATE_MAX // 2 + 72
    z = rtt.Normal(0, 1).latent_vec(k)
    idx = Rt.IntColumn(np.arange(2 * k) % k)
    y = Rt.Column(np.zeros(2 * k))
    # z·2 and exp(z) are two row-invariant blocks of k values each: 2k
    # values from k parameters, so only the row-invariant count is past
    wide = rtt.Model.likelihood(Rt.RowSum(rtt.Normal(
        Rt.Gather(z.element * 2.0, idx) + Rt.Gather(z.element.exp(), idx),
        1.0).log_density_at(y), 2 * k))
    assert k <= emit_cuda.LOCAL_STATE_MAX
    em = emit_cuda.emit(wide.density())
    assert em.n_inv == 2 * k and em.workspace == \
        7 * k + 2 * 2 * k + emit_cuda.LANES
    assert f"#define RT_WS_FLOATS {em.workspace}" in em.source
    glmm_large = glmm_poisson(rtt, 10_000, 1)[0]
    em = emit_cuda.emit(glmm_large.density())
    assert em.n_vars == 10_007 and em.n_inv == 10_004 and em.workspace
    # loops, not unrolled; the rows' step function holds the row's body
    # once for each of its GATHER_STEP rows
    step_fn = re.search(r"RT_HD void rt_row_step\(.*?\n}\n", em.source,
                        re.S).group(0)
    assert len(em.source.replace(step_fn, "").splitlines()) < 400
    assert len(step_fn.splitlines()) < 60 * emit_cuda.GATHER_STEP
    cfg = SamplerConfig(10, 10, sampler=HMC(5))
    assert _fused_unsupported_reason(glmm_large, cfg, 1024, None) is None
    need = F.workspace_bytes(em, 1024)
    assert need == 4 * em.workspace * 1024
    monkeypatch.setattr(F, "free_bytes", lambda device: need - 1)
    reason = _fused_unsupported_reason(glmm_large, cfg, 1024, None)
    assert f"workspace for 1024 chains is {need} bytes" in reason
    assert f"over the {need - 1} bytes free" in reason
