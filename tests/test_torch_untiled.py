"""The untiled density in the port: columns read whole outside the rows,
and several row spaces, held against the JAX package's untiled kernel
branch (``rainier_tpu/ops/hmc_pallas.py:282-291, 300-301``: ``lp_fn`` is
``logp_lanes_fn`` over whole columns, differentiated by ``jax.grad``).

Every model is built through both packages by one ``build(rt)`` function
from the same numpy data, at a small size:

* an ``MVNormal`` prior on logistic-regression coefficients (its Cholesky
  factor a (3, 3) ``MatColumn`` read whole, 600 rows);
* a data ``Vec`` dotted with a latent ``Vec`` inside a likelihood (a
  ``RowSum`` over a 3-row column, nested in the mean of 200 rows);
* two observe blocks of 300 and 500 rows, merged (two row spaces);
* the logistic regression observed as 600 + 400 rows (two row spaces),
  whose density is that of one block of 1000.

Checked, with the tolerance and its reason at each assertion: the
emitted density through the g++ host build and the port's lanes
evaluator against JAX's ``logp_lanes_fn`` and ``jax.grad``; the split
identity over each space's tiles; the host-built kernel against its
plain version, and streamed against synchronous bit for bit; the plain
version against the JAX kernel's untiled branch in interpret mode;
``Model.sample(kernel="fused!")`` on the CPU against the JAX package's
``kernel="pallas!"``; and each form the emitter still refuses (the
three the lanes evaluator cannot broadcast either), by its message.
"""

import numpy as np
import pytest

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
from rainier_tpu_torch.sampler.driver import _verify_split
from test_torch_columns import (_host_library, _host_logp_grad, _jax_noise,
                                _run_host)

torch.set_num_threads(2)
rtt.config.set_device("cpu")


def _R(rt):
    return Rj if rt is rtj else Rt


def _logistic_data(n, p, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p))
    true_b = rng.normal(size=p)
    ys = (rng.uniform(size=n) < 1 / (1 + np.exp(-(x @ true_b - 0.5))))
    return x, ys.astype(float)


def ar1_cov(p, scale=5.0, rho=0.5):
    """Σᵢⱼ = scale² · rho^|i−j|: an AR(1) correlation at the scale of the
    logistic regression's Normal(0, 5) prior."""
    i = np.arange(p)
    return scale ** 2 * rho ** np.abs(i[:, None] - i[None, :])


def mvnormal_logistic(rt, n=600, p=3):
    """benchmarks/models.py:145-159's data with a correlated prior on the
    coefficients, built with the documented Vec API (docs/model.md)."""
    x, ys = _logistic_data(n, p)
    alpha = rt.Normal(0, 5).latent()
    betas = rt.MVNormal([0.0] * p, ar1_cov(p)).latent_vec()
    return rt.Model.observe(list(ys), rt.Vec.from_([tuple(r) for r in x]).map(
        lambda t: rt.Bernoulli((alpha + rt.Vec.of(*t).dot(betas))
                               .logistic())))


def data_vec_dot(rt):
    """A data Vec dotted with a latent Vec (rainier_tpu/compute/vec.py:
    195-216) in the mean of every row: a RowSum over a 3-row column."""
    b = rt.Normal(0, 1).latent_vec(3)
    ys = np.random.default_rng(1).normal(size=200)
    return rt.Model.observe(list(ys), rt.Normal(
        rt.Vec.from_([0.5, 1.0, -0.3]).dot(b), 1))


def two_blocks(rt):
    """Two observe blocks of unequal length, merged (docs/likelihoods.md:
    58-66)."""
    rng = np.random.default_rng(2)
    mu = rt.Normal(0, 1).latent()
    s = rt.Exponential(1).latent()
    a = rt.Model.observe(list(rng.normal(1, 2, 300)), rt.Normal(mu, s))
    b = rt.Model.observe(list(rng.normal(1, 2, 500)),
                         rt.Normal(mu + 0.5, s))
    return a.merge(b)


def logistic_blocks(rt, cuts=(600,)):
    """The logistic regression of 1000 rows × 3 features observed as
    blocks cut at `cuts` (no cut: one block), under one set of
    parameters."""
    R = _R(rt)
    x, ys = _logistic_data(1000, 3, seed=0)
    alpha = rt.Normal(0, 5).latent()
    betas = rt.Normal(0, 5).latent_vec(3)
    bounds = [0, *cuts, len(ys)]
    return rt.Model.likelihoods([R.RowSum(rt.Bernoulli(
        (alpha + R.MatVec(R.MatColumn(x[a:b]), betas.element)).logistic())
        .log_density_at(R.Column(ys[a:b])), b - a)
        for a, b in zip(bounds, bounds[1:])])


MODELS = {"mvnormal_logistic": mvnormal_logistic,
          "data_vec_dot": data_vec_dot, "two_blocks": two_blocks,
          "split_logistic": logistic_blocks}

# (rows of each row space, whether a column is read whole)
SHAPES = {"mvnormal_logistic": ((600,), True),
          "data_vec_dot": ((200,), True),
          "two_blocks": ((300, 500), False),
          "split_logistic": ((600, 400), False)}


def _points(n_vars, seed, k):
    return np.random.default_rng(seed).normal(size=(n_vars, k)) * 0.3


def _jax_lp_grad(cdj, q):
    """JAX's logp_lanes_fn at every column of q (dim, k) and its jax.grad:
    the function the kernel's untiled branch evaluates."""
    lanes = cdj.logp_lanes_fn()
    cols = cdj.column_values(jnp.float32)
    qj = jnp.asarray(q, jnp.float32)
    lp = lanes(qj, cols)
    g = jax.grad(lambda qq: jnp.sum(lanes(qq, cols)))(qj)
    return np.asarray(lp), np.asarray(g)


def _density_bars(lp, g, lp_ref, g_ref):
    """chip_smoke.py's density_check bars, per point: |Δlp| within
    max(0.01 nats, 2 f32 ulps of lp) — two f32 sums of the same terms in
    other orders differ by rounding — and |Δg| within 1e-4 of the point's
    max |g|."""
    tol_lp = np.maximum(2 * np.finfo(np.float32).eps * np.abs(lp_ref), 0.01)
    assert np.all(np.abs(lp - lp_ref) <= tol_lp), (lp, lp_ref)
    gmax = np.abs(g_ref).max(axis=0)
    assert np.all(np.abs(g - g_ref) <= 1e-4 * gmax), np.abs(g - g_ref).max()


# -- the emitted density against JAX's logp_lanes_fn --------------------------


@pytest.mark.parametrize("name", sorted(MODELS))
def test_emitted_density_matches_jax_lanes(name, tmp_path):
    """The kernel's density function through its tile loops (g++ host
    build), the port's logp_lanes_fn with autograd and the plain version
    (density_lanes), each against JAX's logp_lanes_fn and jax.grad at the
    same q, with density_check's bars."""
    cd, cdj = MODELS[name](rtt).density(), MODELS[name](rtj).density()
    rows, whole = SHAPES[name]
    em = emit_cuda.emit(cd)
    assert tuple(s.n_rows for s in em.spaces) == rows
    assert ("#define RT_WHOLE_COLS" in em.source) == whole
    assert ("#define RT_SPACES" in em.source) == (len(rows) > 1)
    q = _points(cd.n_vars, 3, 6).astype(np.float32)
    lp_ref, g_ref = _jax_lp_grad(cdj, q)
    lib, em = _host_library(cd, tmp_path)
    cols = cd.column_values(torch.float32, "cpu")
    qt = torch.as_tensor(q)
    lp, g = _host_logp_grad(lib, em, qt, cols)
    _density_bars(lp.numpy(), g.numpy(), lp_ref, g_ref)
    lp_t, g_t = cd.batched_logp_and_grad_fn()(qt.T.contiguous(), cols)
    _density_bars(lp_t.numpy(), g_t.T.numpy(), lp_ref, g_ref)
    lp_p, g_p = F.logp_grad_reference(cd, qt)
    _density_bars(lp_p.numpy(), g_p.numpy(), lp_ref, g_ref)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_split_identity_holds_over_each_space(name):
    """base + Σ over each space's tiles of its rows == the whole density,
    at 256-row tiles and at 7, and at a tile of its own for each space."""
    cd = MODELS[name](rtt).density()
    cols = cd.column_values(torch.float32, "cpu")
    tiles = [7 + 5 * i for i in range(len(cd.row_split().spaces))]
    assert _verify_split(cd, cols, 256) and _verify_split(cd, cols, 7)
    assert _verify_split(cd, cols, tiles)


def test_two_spaces_give_the_one_block_density(tmp_path):
    """The logistic observed as 600 + 400 rows is the one-block model of
    1000 rows: the two host-built kernels' densities agree within
    density_check's bars (each sums its tiles in its own order), and the
    tile of each space holds only its own columns."""
    split, one = logistic_blocks(rtt).density(), \
        logistic_blocks(rtt, cuts=()).density()
    q = torch.as_tensor(_points(split.n_vars, 4, 8), dtype=torch.float32)
    out = []
    for cd in (split, one):
        lib, em = _host_library(cd, tmp_path)
        out.append(_host_logp_grad(lib, em, q,
                                   cd.column_values(torch.float32, "cpu")))
    em = emit_cuda.emit(split)
    assert [(s.n_rows, s.row_width, s.tile_rows) for s in em.spaces] == [
        (600, 4, 256), (400, 4, 256)]
    assert em.n_rows == 1000 and em.row_bytes() == 4 * 1000 * 4
    (lp, g), (lp1, g1) = out
    _density_bars(lp.numpy(), g.numpy(), lp1.numpy(), g1.numpy())


def test_whole_columns_are_read_at_every_call(tmp_path):
    """A column read whole is an argument of the kernel, not a constant of
    its source: after Model.with_data swaps the 3-row data vector of
    data_vec_dot, the same build gives the new density (against the plain
    version on the new data, density_check's bars) and the source is the
    same text."""
    model = data_vec_dot(rtt)
    cd = model.density()
    lib, em = _host_library(cd, tmp_path)
    (w,) = [c for c in cd.columns if c.n_rows == 3]
    model.with_data({w: [2.0, -1.0, 0.25]})
    assert emit_cuda.emit(cd).source == em.source
    q = torch.as_tensor(_points(cd.n_vars, 5, 6), dtype=torch.float32)
    lp, g = _host_logp_grad(lib, em, q, cd.column_values(torch.float32,
                                                          "cpu"))
    lp_p, g_p = F.logp_grad_reference(cd, q)
    _density_bars(lp.numpy(), g.numpy(), lp_p.numpy(), g_p.numpy())
    model.with_data({w: [0.5, 1.0, -0.3]})
    assert not torch.allclose(F.logp_grad_reference(cd, q)[0], lp_p)


# -- the kernel's loop: against the plain version, streamed against not ------


def _inputs(cd, model, n, n_it, noise, seed=2):
    """q0, the kernel's keywords with per-chain ε and Σ̂ from a short
    scan-path warmup, and explicit noise or None."""
    tr = model.sample(SamplerConfig(150, 10, sampler=HMC(5)), n_chains=n,
                      seed=3)
    rng = np.random.default_rng(seed)
    q0 = torch.as_tensor(tr.chains[:, -1, :].T.copy())
    kw = dict(step_size=torch.as_tensor(tr.step_size, dtype=torch.float32),
              n_steps=4, n_iterations=n_it, seed=9, collect_every=1,
              inv_mass_diag=torch.as_tensor(tr.mass.diag,
                                            dtype=torch.float32))
    nz = (torch.as_tensor(rng.normal(size=(n_it, cd.n_vars, n)),
                          dtype=torch.float32),
          torch.as_tensor(rng.uniform(1e-6, 1.0, (n_it, n)),
                          dtype=torch.float32)) \
        if noise == "explicit" else None
    return q0, kw, nz


@pytest.mark.parametrize("name", sorted(MODELS))
def test_host_kernel_matches_plain_version(name, tmp_path):
    """The kernel's loop (g++ host build, 37 chains in blocks of 4, a
    warp each: a ragged block) against the plain version with explicit
    noise: the two sum rows in other orders, so ≥ 90% of chains end
    within 1e-3 (a flipped borderline accept sends a chain away) and
    accept rates agree within 0.05 on average, the bar of
    test_torch_columns.py."""
    model = MODELS[name](rtt)
    cd = model.density()
    lib, em = _host_library(cd, tmp_path)
    q0, kw, nz = _inputs(cd, model, 37, 25, "explicit")
    cols = cd.column_values(torch.float32, "cpu")
    got = _run_host(lib, cd, q0, kw, nz, cols)
    ref = F.fused_hmc_reference(cd, q0, noise=nz, **kw)
    rel = ((got[0] - ref[0]).abs() / ref[0].abs().clamp(min=1.0)).amax(0)
    assert float((rel <= 1e-3).float().mean()) >= 0.9, rel
    assert float((got[2] - ref[2]).abs().mean()) < 0.05


@pytest.mark.parametrize("noise", ["explicit", "philox"])
def test_two_spaces_stream_bit_identically(noise, tmp_path):
    """Streamed through two slots, the 600 + 400-row model's kernel gives
    the synchronous kernel's final q, draws, accept rates and divergences
    exactly: each space sums a tile's rows with one function, and every
    thread commits one copy group a tile of each space."""
    model = logistic_blocks(rtt)
    cd = model.density()
    lib, em = _host_library(cd, tmp_path)
    assert all(s.n_rows % s.tile_rows for s in em.spaces)
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


@pytest.mark.parametrize("name", ["mvnormal_logistic", "two_blocks"])
def test_plain_version_matches_untiled_pallas_kernel(name):
    """fused_hmc_reference against the JAX package's kernel on its
    untiled branch (lp_fn its logp_lanes_fn over whole columns, row_tile
    0), interpreted with the same noise (128 chains: one lane block, for
    which the JAX kernel draws its noise): ≥ 90% of chains within 1e-3 and
    accept rates within 0.05, the bar of test_torch_columns.py for sums in
    other orders."""
    n, n_it, seed = 128, 20, 5
    mt, mj = MODELS[name](rtt), MODELS[name](rtj)
    cdt, cdj = mt.density(), mj.density()
    lanes = cdj.logp_lanes_fn()
    q0, kw, _ = _inputs(cdt, mt, n, n_it, None)
    kw = {**kw, "n_steps": 5, "seed": seed}
    jkw = {**kw, "step_size": kw["step_size"].numpy(),
           "inv_mass_diag": kw["inv_mass_diag"].numpy()}
    qf_j, _, acc_j, div_j = fused_hmc_jax(
        lambda q, *cols: lanes(q, cols), jnp.asarray(q0.numpy()),
        block_chains=n, interpret=True, host_rng=True,
        columns=cdj.column_values(jnp.float32), **jkw)
    qf, _, acc, div = F.fused_hmc_reference(
        cdt, q0, noise=_jax_noise(seed, n_it, cdt.n_vars, n), **kw)
    per_chain = np.max(np.abs(qf.numpy() - np.asarray(qf_j)), axis=0)
    assert np.mean(per_chain < 1e-3) >= 0.90, per_chain
    assert np.max(np.abs(acc.numpy() - np.asarray(acc_j))) < 0.05
    assert float(np.sum(div.numpy())) == float(np.sum(np.asarray(div_j)))


# -- Model.sample(kernel="fused!") against the JAX package's "pallas!" -------


def _mean_and_se(tr):
    """Per-coordinate posterior mean and its Monte-Carlo standard error
    sd / sqrt(ESS), ESS from the trace's own diagnostics."""
    flat = tr.chains.reshape(-1, tr.chains.shape[-1]).astype(np.float64)
    ess = np.array([d.effective_sample_size for d in tr.diagnostics()])
    return flat.mean(0), flat.std(0) / np.sqrt(ess)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fused_sample_matches_pallas_sample(name):
    """Model.sample(kernel="fused!", device="cpu") (the kernel's plain
    version on CPU tensors) against the JAX package's kernel="pallas!"
    (its untiled branch, interpreted): 16 chains × (200 warmup + 300
    draws) of HMC(5) each; every coordinate's mean within 5 Monte-Carlo
    standard errors of the two runs combined."""
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


# -- what the emitter still refuses -----------------------------------------


def _refused_models(rt):
    """Each form the emitter refuses, in the smallest JAX-package
    construct that builds it, with the refusal's words.  The forms it
    takes since (a MatVec past UNROLL_MAX, an IntColumn read whole, a
    vector per row, a row-varying Gather) are in test_torch_forms.py."""
    R = _R(rt)
    ys = np.random.default_rng(6).normal(size=8)
    b = rt.Normal(0, 1).latent_vec(3)
    a = rt.Normal(0, 1).latent()

    def observe(mean):
        return rt.Model.observe(list(ys), rt.Normal(mean, 1.0))

    x = R.MatColumn(np.random.default_rng(7).normal(size=(8, 3)))
    y = R.Column(ys)
    return {
        # Vec.__getitem__ with a Real (rainier_tpu/compute/vec.py:229-235)
        "float_index": (observe(b[a.abs()]),
                        "Gather by an index that is neither"),
        "matcolumn_as_value": (rt.Model.likelihood(R.RowSum(
            rt.Normal(R.MatVec(x, b.element) * x, 1.0).log_density_at(y),
            8)), "MatColumn used other than as MatVec's matrix"),
        "two_lengths_in_one_rowsum": (rt.Model.likelihood(R.RowSum(
            rt.Normal(a + R.Column(np.ones(5)), 1.0).log_density_at(y), 8)),
            r"RowSum over columns of different lengths \[5, 8\]"),
    }


# the forms the emitter refuses are the ones the lanes evaluator cannot
# broadcast, in either package (a float index gives a (1, C, C) take, a
# matrix times its own product an (n, p)-against-(n, C) product, two
# lengths do not broadcast): neither the JAX package's kernel nor either
# scan path runs them
REFUSED = sorted(_refused_models(rtt))


@pytest.mark.parametrize("form", REFUSED)
def test_emitter_refuses_and_names_the_form(form):
    """The refusal names the form, and kernel="fused!" raises with it."""
    model, words = _refused_models(rtt)[form]
    with pytest.raises(emit_cuda.UnsupportedNode, match=words):
        emit_cuda.emit(model.density())
    cfg = SamplerConfig(5, 3, sampler=HMC(2))
    with pytest.raises(ValueError, match=words):
        model.sample(cfg, n_chains=2, kernel="fused!")


def test_refused_forms_on_the_jax_lanes_evaluator():
    """The JAX package's lanes evaluator, which its kernel runs, raises on
    each form the emitter refuses."""
    for form in REFUSED:
        model, _ = _refused_models(rtj)[form]
        cd = model.density()
        q = jnp.asarray(_points(cd.n_vars, 1, 2), jnp.float32)
        with pytest.raises((TypeError, ValueError)):
            cd.logp_lanes_fn()(q, cd.column_values(jnp.float32))
