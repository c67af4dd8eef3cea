"""Data columns in the port: the base/row split, the emitted row code, and
the fused kernel's row-tiled density, held against the JAX package.

Every model is built through both packages by one ``build(rt)`` function
from the same numpy data; f32 throughout.  Checked here, with the
tolerance and its reason at each assertion:

* ``CompiledDensity.logp_lanes_split_fn`` against the JAX package's
  (``base_fn`` and ``tile_fn`` at the same q, mask and row tile), and
  ``None`` for the same models;
* ``csrc/fused_hmc.cu`` compiled for the host with g++: its density and
  gradient through the tile loop (``rt_logp_grad_host``) against autograd
  on the port's ``logp_lanes_fn`` and ``jax.grad`` of the JAX ``logp_fn``;
* ``fused_hmc_reference`` with columns and explicit noise against the
  JAX package's row-tiled Pallas kernel run as its own tests run it
  (``host_rng=True, interpret=True``);
* the host-compiled kernel with columns against the plain version in
  both noise modes, a ragged chain count and rows not a multiple of the
  tile;
* ``Model.sample(kernel="fused!")`` on a 2500-row model against the scan
  path, and the wrapper's and emitter's refusals.
"""

import ctypes
import hashlib
import shutil
import subprocess

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
from rainier_tpu_torch.sampler.driver import (_fused_unsupported_reason,
                                              _verify_split)

torch.set_num_threads(2)
rtt.config.set_device("cpu")


def _R(rt):
    return Rj if rt is rtj else Rt


# -- models, built the same way through either package ---------------------


def readme_regression(rt):
    rng = np.random.default_rng(42)
    xs = [tuple(r) for r in rng.normal(size=(200, 3))]
    ys = [float(np.dot(x, [1.0, -2.0, 0.5]) + 0.7 + 0.3 * rng.normal())
          for x in xs]
    sigma = rt.Exponential(1).latent()
    alpha = rt.Normal(0, 1).latent()
    betas = rt.Normal(0, 1).latent_vec(3)
    return rt.Model.observe(ys, rt.Vec.from_(xs).map(
        lambda t: rt.Normal(alpha + rt.Vec.of(*t).dot(betas), sigma)))


def _logistic_data(n=1500, p=3):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, p))
    true_b = np.array([1.0, -0.5, 0.25])[:p]
    ys = (rng.uniform(size=n) < 1 / (1 + np.exp(-(x @ true_b - 0.5))))
    return x, ys.astype(float)


def logistic(rt):
    """benchmarks/models.py:145-159's structure at n = 1500, p = 3: rows
    not a multiple of any tile."""
    R = _R(rt)
    x, ys = _logistic_data()
    alpha = rt.Normal(0, 5).latent()
    betas = rt.Normal(0, 5).latent_vec(x.shape[1])
    lin = alpha + R.MatVec(R.MatColumn(x), betas.element)
    return rt.Model.likelihood(R.RowSum(
        rt.Bernoulli(lin.logistic()).log_density_at(R.Column(ys)),
        len(ys)))


def normal_observe(rt):
    data = np.random.default_rng(3).normal(1.5, 2.0, size=600)
    mu = rt.Normal(0, 10).latent()
    return rt.Model.observe(list(data),
                            rt.Normal(mu, rt.Exponential(0.5).latent()))


def row_independent(rt):
    """A RowSum whose child depends on no column (n · child), beside a
    column likelihood."""
    R = _R(rt)
    mu = rt.Normal(0, 1).latent()
    d = np.random.default_rng(4).normal(size=50)
    return rt.Model.likelihoods([
        R.RowSum(mu * mu * -0.5, 50),
        rt.Normal(mu, 1.0).log_density(list(d))])


def matrix_views(rt):
    """KidIQ's structure (benchmarks/models.py:83-95): Column views of a
    MatColumn used elementwise, with the MatColumn itself in the graph
    too, so the tile holds the matrix once and the views read it."""
    R = _R(rt)
    rng = np.random.default_rng(5)
    x = np.stack([rng.normal(size=90), rng.uniform(size=90)], axis=1)
    y = 1.0 + x @ [0.6, 2.0] + 0.5 * rng.normal(size=90)
    mat = R.MatColumn(x)
    b = rt.Normal(0, 3).latent_vec(2)
    c = rt.Normal(0, 3).latent()
    sigma = rt.Exponential(1.0).latent()
    mean = R.MatVec(mat, b.element) + mat.column(1) * c + mat.column(0)
    return rt.Model.likelihood(R.RowSum(
        rt.Normal(mean, sigma).log_density_at(R.Column(y)), 90))


def base_with_columns(rt):
    """A likelihood over a column that is not a RowSum: the column-free
    base references columns, so neither package splits the density."""
    R = _R(rt)
    mu = rt.Normal(0, 1).latent()
    return rt.Model.likelihood(mu * R.Column(np.arange(5.0)) * -0.1)


SPLIT_MODELS = {"readme_regression": readme_regression,
                "logistic": logistic, "normal_observe": normal_observe,
                "row_independent": row_independent,
                "matrix_views": matrix_views}


def _points(n_vars, seed, k):
    return np.random.default_rng(seed).normal(size=(n_vars, k)) * 0.3


# -- logp_lanes_split_fn ----------------------------------------------------


@pytest.mark.parametrize("name", sorted(SPLIT_MODELS))
def test_split_matches_jax(name):
    """base_fn and tile_fn agree with the JAX package's at one q, on a
    row tile that ends past the data (masked): f32 sums of up to 600
    terms in other orders, so rtol 1e-5 and atol 1e-5·(1 + |value|)."""
    cdj, cdt = SPLIT_MODELS[name](rtj).density(), \
        SPLIT_MODELS[name](rtt).density()
    base_j, tile_j = cdj.logp_lanes_split_fn()
    base_t, tile_t = cdt.logp_lanes_split_fn()
    qb = _points(cdt.n_vars, 1, 6).astype(np.float32)
    got, want = base_t(torch.as_tensor(qb)), base_j(jnp.asarray(qb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * (1 + np.abs(want).max()))
    # the last tile of a 64-row tiling, padded past the data by
    # repeating row 0 and masked there, as the JAX kernel pads
    cols = [np.asarray(c) for c in cdj.column_values(jnp.float32)]
    n, r = cols[0].shape[0], 64
    a = (n - 1) // r * r
    tile = [np.concatenate([c[a:], np.repeat(c[:1], a + r - n, axis=0)])
            for c in cols]
    mask = (np.arange(a, a + r) < n).astype(np.float32)[:, None]
    ct = tuple(torch.as_tensor(c) for c in tile)
    cj = tuple(jnp.asarray(c) for c in tile)
    got = tile_t(torch.as_tensor(qb), torch.as_tensor(mask), ct)
    want = tile_j(jnp.asarray(qb), jnp.asarray(mask), cj)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * (1 + np.abs(want).max()))


def test_split_is_none_where_jax_has_none():
    """Neither package splits a density whose column-free base reads a
    column; the JAX kernel runs it untiled, and the emitter reads the
    column whole in the base terms, with no row space."""
    assert base_with_columns(rtj).density().logp_lanes_split_fn() is None
    assert base_with_columns(rtt).density().logp_lanes_split_fn() is None
    em = emit_cuda.emit(base_with_columns(rtt).density())
    assert em.spaces == () and "#define RT_WHOLE_COLS" in em.source


@pytest.mark.parametrize("name", sorted(SPLIT_MODELS))
def test_split_identity_holds_over_the_kernel_tiles(name):
    """base + Σ tiles == the whole density (sampler/driver.py checks this
    before a launch) at tiles of 256 rows and of 7."""
    cd = SPLIT_MODELS[name](rtt).density()
    cols = cd.column_values(torch.float32, "cpu")
    assert _verify_split(cd, cols, 256) and _verify_split(cd, cols, 7)


# -- the emitted code and the tile loop, compiled for the host ---------------


def _host_library(cd, tmp_path, lanes=None):
    """g++ build of csrc/fused_hmc.cu with the model's emitted header (and
    ``RT_LANES`` defined as `lanes`, as ``fused_hmc.build`` defines it
    for a model without rows)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: csrc/fused_hmc.cu cannot be "
                    "compiled for the host")
    em = emit_cuda.emit(cd)
    defines = [] if lanes is None else [f"-DRT_LANES={lanes}"]
    d = tmp_path / hashlib.sha256(
        (em.source + " ".join(defines)).encode()).hexdigest()[:16]
    d.mkdir(exist_ok=True)
    (d / emit_cuda.HEADER_NAME).write_text(em.source)
    so = d / "host.so"
    res = subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
         *defines, "-I", str(d), "-I", str(F.CSRC), "-o", str(so),
         str(F.CSRC / "fused_hmc.cu")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    lib.rt_logp_grad_host.argtypes = F.LOGP_GRAD_ARGTYPES
    lib.rt_fused_hmc_host.argtypes = F.HMC_ARGTYPES
    return lib, em


def _host_ws(em, n):
    """(the workspace the wrapper would allocate for a launch over n
    chains, NaN-filled, or None for a model whose state lives in the
    thread or in shared memory; the threads of its blocks)."""
    ws = torch.full((F.workspace_bytes(em, n) // 4,), float("nan")) \
        if F.workspace_bytes(em, n) else None
    return ws, F.threads_per_block(em, n)


def _host_logp_grad(lib, em, q, cols, stream=False):
    """rt_logp_grad_host at every column of q (dim, n), its tiles
    streamed through two slots with `stream`: (lp, g)."""
    n = q.shape[1]
    lp, g = torch.empty(n), torch.empty_like(q)
    ws, threads = _host_ws(em, n)
    ptrs, _held = F.column_pointers(em, cols)
    lib.rt_logp_grad_host(n, q.data_ptr(), lp.data_ptr(), g.data_ptr(),
                          ptrs, F.row_counts(em),
                          None if ws is None else ws.data_ptr(), threads,
                          int(stream))
    return lp, g


@pytest.mark.parametrize("name", sorted(SPLIT_MODELS))
def test_host_compiled_density_matches_autograd_and_jax(name, tmp_path):
    """The kernel's density function through its tile loop: per-tile f32
    sums, f64 across tiles, against torch autograd and jax.grad.  Both
    references sum the same f32 terms in other orders: lp within
    rtol 1e-5 / atol 1e-5·(1 + |lp|), gradients within 1e-5 of max |g|
    (a few ulps of the largest partial sums)."""
    mt, mj = SPLIT_MODELS[name](rtt), SPLIT_MODELS[name](rtj)
    cd, cdj = mt.density(), mj.density()
    lib, em = _host_library(cd, tmp_path)
    assert em.row_width > 0 and em.row_ops > 0
    q = torch.as_tensor(_points(cd.n_vars, 2, 5), dtype=torch.float32)
    cols = cd.column_values(torch.float32, "cpu")
    lp, g = _host_logp_grad(lib, em, q, cols)
    lp_t, g_t = cd.batched_logp_and_grad_fn()(q.T.contiguous(), cols)
    lpg_j = jax.vmap(jax.value_and_grad(cdj.logp_fn()), in_axes=(0, None))
    lp_j, g_j = lpg_j(jnp.asarray(q.numpy().T),
                      cdj.column_values(jnp.float32))
    for lp_ref, g_ref in ((lp_t.numpy(), g_t.numpy()),
                          (np.asarray(lp_j), np.asarray(g_j))):
        np.testing.assert_allclose(lp.numpy(), lp_ref, rtol=1e-5,
                                   atol=1e-5 * (1 + np.abs(lp_ref).max()))
        np.testing.assert_allclose(g.numpy().T, g_ref, rtol=0,
                                   atol=1e-5 * np.abs(g_ref).max())


def test_matrix_views_read_the_matrix_from_the_tile():
    em = emit_cuda.emit(matrix_views(rtt).density())
    # the 2-column matrix and the observed y: the views load nothing
    assert em.row_width == 3 and em.tile_rows == emit_cuda.TILE_ROWS_MAX
    assert em.source.count("= cols.c") == 2


def _laplace_start(n, seed):
    """q0 near the logistic posterior's mode, from a numpy Newton solve in
    the sampler's coordinates (the latent of Normal(0, 5) is 5·z), and the
    posterior variances."""
    x, ys = _logistic_data()
    xa = np.hstack([np.ones((len(ys), 1)), x])
    w = np.zeros(xa.shape[1])
    for _ in range(30):
        mu = 1 / (1 + np.exp(-(xa @ w)))
        h = (xa.T * (mu * (1 - mu))) @ xa + np.eye(xa.shape[1]) / 25.0
        w = w + np.linalg.solve(h, xa.T @ (ys - mu) - w / 25.0)
    var = np.diag(np.linalg.inv(h)) / 25.0
    rng = np.random.default_rng(seed)
    q0 = (w / 5.0)[:, None] + np.sqrt(var)[:, None] * rng.normal(
        size=(len(w), n))
    return q0.astype(np.float32), var.astype(np.float32)


def _jax_noise(seed, n_it, dim, n):
    """hmc_pallas.py:246-254's host_rng noise, sliced to the true dim."""
    dim_pad = (dim + 7) // 8 * 8
    kp, ku = jax.random.split(jax.random.PRNGKey(seed))
    p = jax.random.normal(kp, (n_it, dim_pad, n), jnp.float32)
    u = jax.random.uniform(ku, (n_it, 1, n), jnp.float32,
                           minval=1.1920929e-7, maxval=1.0)
    return (torch.as_tensor(np.array(p[:, :dim])),
            torch.as_tensor(np.array(u[:, 0])))


def test_plain_version_matches_row_tiled_pallas_kernel():
    """fused_hmc_reference with the logistic's columns against the JAX
    package's row-tiled kernel (row_tile 1024, prior_fn = the JAX split's
    base_fn, lp_fn its tile_fn), interpreted with the same noise: ≥ 90%
    of chains end within 1e-3 and accept rates agree within 0.05, the
    JAX package's own bar for tiled sums (test_pallas.py:148-151) — the
    two sum the 1500 row terms in other orders, so a borderline accept
    may flip and that chain walks away."""
    n, n_it, seed = 128, 40, 5
    cdj, cdt = logistic(rtj).density(), logistic(rtt).density()
    base_fn, tile_fn = cdj.logp_lanes_split_fn()
    q0, var = _laplace_start(n, 0)
    kw = dict(step_size=0.5, n_steps=5, n_iterations=n_it, seed=seed,
              inv_mass_diag=var, collect_every=1)
    qf_j, _, acc_j, div_j = fused_hmc_jax(
        lambda q, mask, *cols: tile_fn(q, mask, cols), jnp.asarray(q0),
        block_chains=n, interpret=True, host_rng=True,
        columns=cdj.column_values(jnp.float32), row_tile=1024,
        prior_fn=base_fn, **kw)
    qf, _, acc, div = F.fused_hmc_reference(
        cdt, torch.as_tensor(q0), noise=_jax_noise(seed, n_it, 4, n),
        **{**kw, "inv_mass_diag": torch.as_tensor(var)})
    per_chain = np.max(np.abs(qf.numpy() - np.asarray(qf_j)), axis=0)
    assert np.mean(per_chain < 1e-3) >= 0.90, per_chain
    assert np.max(np.abs(acc.numpy() - np.asarray(acc_j))) < 0.05
    assert float(np.sum(div.numpy())) == float(np.sum(np.asarray(div_j)))


def _run_host(lib, cd, q0, kw, noise, cols, collect_idx=None, ws_out=None,
              stream=False):
    """rt_fused_hmc_host over the slots of the wrapper's launch, in the
    workspace it would allocate (appended to `ws_out` if given), its
    tiles streamed through two slots with `stream`: (final q, samples,
    accept, divergences)."""
    dim, n = q0.shape
    n_it, collect = kw["n_iterations"], kw["collect_every"]
    _, eps, scale, noise, cols = F._prepare(
        cd, q0, kw["step_size"], kw["inv_mass_diag"], kw["n_steps"], n_it,
        collect, noise, cols)
    em = emit_cuda.emit(cd)
    pos, n_collect, expand = F._collect_pos(collect_idx, em, q0.device)
    qf, acc, div = torch.empty(dim, n), torch.empty(n), torch.empty(n)
    samples = torch.empty(n_it // collect, n_collect, n)
    ws, threads = _host_ws(em, n)
    if ws_out is not None:
        ws_out.append(ws)
    ptr = (lambda t: None if t is None else t.data_ptr())
    p, u = noise if noise is not None else (None, None)
    ptrs, _held = F.column_pointers(em, cols)
    lib.rt_fused_hmc_host(
        n, ptr(q0), ptr(scale), int(scale is not None and scale.dim() == 2),
        ptr(eps), ptr(p), ptr(u), ptr(qf), ptr(samples), ptr(acc), ptr(div),
        n_it, kw["n_steps"], collect, ptr(pos), n_collect, kw["seed"],
        ptrs, F.row_counts(em), ptr(ws), threads, int(stream))
    if expand is not None:
        samples = samples[:, expand]
    return qf, samples, acc, div


@pytest.mark.parametrize("noise", ["explicit", "philox"])
def test_host_compiled_kernel_with_columns_matches_plain_version(
        noise, tmp_path):
    """The kernel's loop with the row-tiled density (1500 rows: five full
    256-row tiles and a ragged one) against the plain version, 37 chains
    (ragged), per-chain ε and Σ̂.  The two sum rows in other orders, so
    ≥ 90% of chains end within 1e-3 (a flipped borderline accept sends a
    chain away) and accept rates agree within 0.05 on average."""
    cd = logistic(rtt).density()
    lib, em = _host_library(cd, tmp_path)
    assert em.n_rows % em.tile_rows != 0
    n, n_it = 37, 25
    q0, var = _laplace_start(n, 1)
    rng = np.random.default_rng(2)
    kw = dict(step_size=torch.as_tensor(rng.uniform(0.3, 0.9, n),
                                        dtype=torch.float32),
              n_steps=4, n_iterations=n_it, seed=9, collect_every=1,
              inv_mass_diag=torch.as_tensor(
                  var * rng.uniform(0.5, 2.0, (n, len(var))),
                  dtype=torch.float32))
    nz = (torch.as_tensor(rng.normal(size=(n_it, 4, n)),
                          dtype=torch.float32),
          torch.as_tensor(rng.uniform(1e-6, 1.0, (n_it, n)),
                          dtype=torch.float32)) \
        if noise == "explicit" else None
    q0 = torch.as_tensor(q0)
    cols = cd.column_values(torch.float32, "cpu")
    got = _run_host(lib, cd, q0, kw, nz, cols)
    ref = F.fused_hmc_reference(cd, q0, noise=nz, **kw)
    rel = ((got[0] - ref[0]).abs() / ref[0].abs().clamp(min=1.0)).amax(0)
    assert float((rel <= 1e-3).float().mean()) >= 0.9, rel
    assert float((got[2] - ref[2]).abs().mean()) < 0.05


# -- the wrapper, sampler/driver.py and the envelope -------------------------


def test_wrapper_runs_plain_versions_on_cpu_tensors():
    cd = readme_regression(rtt).density()
    q = torch.as_tensor(_points(cd.n_vars, 4, 6), dtype=torch.float32)
    before = (F.fused_hmc.launches, F.logp_grad.launches)
    lp, g = F.logp_grad(cd, q)
    lp_ref, g_ref = cd.batched_logp_and_grad_fn()(
        q.T.contiguous(), cd.column_values(torch.float32, "cpu"))
    # the plain version sums rows in f64 across slices, autograd in f32
    torch.testing.assert_close(lp, lp_ref, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(g, g_ref.T, rtol=1e-5, atol=1e-3)
    out = F.fused_hmc(cd, q, step_size=0.05, n_steps=3, n_iterations=4,
                      seed=0, collect_every=2)
    assert (F.fused_hmc.launches, F.logp_grad.launches) == before
    assert out[1].shape == (2, cd.n_vars, 6)


def test_wrapper_validates_columns():
    cd = logistic(rtt).density()
    x, y = cd.column_values(torch.float32, "cpu")
    q = torch.zeros(cd.n_vars, 3)
    kw = dict(step_size=0.1, n_steps=1, n_iterations=1, seed=0)
    for bad in ((x,), (x.double(), y), (x.T.contiguous().T, y),
                (x, y[:-1])):
        with pytest.raises(ValueError, match="column"):
            F.fused_hmc(cd, q, columns=bad, **kw)


def test_tile_rows_fit_shared_memory():
    # two tiles (a streamed launch's slots) fit the 227 KB of a block
    assert emit_cuda.tile_rows(11) == 256     # 2 x 11 KB
    assert emit_cuda.tile_rows(113) == 256    # 2 x 113 KB
    assert emit_cuda.tile_rows(114) == 128    # 2 x 114 KB at 256 rows
    assert emit_cuda.tile_rows(300) == 64     # 2 x 150 KB at 128 rows
    assert emit_cuda.tile_rows(2000) == 0     # 32 rows are 2 x 250 KB
    em = emit_cuda.emit(logistic(rtt).density())
    assert (em.row_width, em.tile_rows, em.n_rows) == (4, 256, 1500)
    assert em.density_ops() == em.ops + 1500 * em.row_ops


def test_op_count_adds_the_row_terms():
    em = emit_cuda.emit(logistic(rtt).density())
    assert F.op_count(em, 5) > 5 * 1500 * em.row_ops


@pytest.mark.parametrize("build,match", [
    # a RowSum over columns of two lengths row by row has no row space
    (lambda rt: rt.Model.likelihood(_R(rt).RowSum(
        rt.Normal(0, 1).latent() * _R(rt).Column(np.ones(3))
        + _R(rt).Column(np.ones(4)), 4)), "different lengths"),
    # a vector of another length than the rows, per row
    (lambda rt: rt.Model.likelihood(_R(rt).RowSum(
        rt.Normal(0, 1).latent_vec(2).element * _R(rt).Column(np.ones(3)),
        3)), "vector width"),
])
def test_emitter_refuses_what_it_does_not_cover(build, match):
    with pytest.raises(emit_cuda.UnsupportedNode, match=match):
        emit_cuda.emit(build(rtt).density())


def test_fused_sample_on_rows_matches_scan():
    """Model.sample(kernel="fused!") on a 2500-row model runs the kernel's
    plain version over its columns (counterpart of test_pallas.py:185-204):
    means of mu and sigma within 0.15 of the scan path's, 8 chains × 400
    draws each (posterior SDs ~0.04, so both are well inside)."""
    rng = np.random.default_rng(3)
    data = rng.normal(1.5, 2.0, size=2500)
    mu = rtt.Normal(0, 10).latent()
    sigma = rtt.Exponential(0.5).latent()
    model = rtt.Model.observe(list(data), rtt.Normal(mu, sigma))
    cfg = SamplerConfig(warmup_iterations=300, iterations=400,
                        sampler=HMC(8))
    assert _fused_unsupported_reason(model, cfg, 8, None) is None
    tr_scan = model.sample(cfg, n_chains=8, seed=0)
    tr_fused = model.sample(cfg, n_chains=8, seed=0, kernel="fused!")
    for expr in (mu, sigma):
        assert abs(tr_scan.mean(expr) - tr_fused.mean(expr)) < 0.15
    assert abs(tr_fused.mean(mu) - float(np.mean(data))) < 0.15
    assert float(np.mean(tr_fused.accept_rate())) > 0.5
    assert tr_fused.chains.shape == (8, 400, 2)


def test_failed_split_check_raises_or_falls_back(monkeypatch):
    """Where base + Σ tiles != the whole density, 'fused!' raises and
    'fused' warns and runs the scan path, as for every envelope miss."""
    from rainier_tpu_torch.sampler import driver

    monkeypatch.setattr(driver, "_verify_split", lambda *a: False)
    model = normal_observe(rtt)
    cfg = SamplerConfig(20, 10, sampler=HMC(2))
    with pytest.raises(ValueError, match="numeric check"):
        model.sample(cfg, n_chains=2, kernel="fused!")
    with pytest.warns(UserWarning, match="numeric check"):
        tr = model.sample(cfg, n_chains=2, kernel="fused")
    assert tr.chains.shape == (2, 10, 2)
