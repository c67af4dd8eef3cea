"""Models past the kernel's register layout: ``benchmarks/models.py::
glmm_large`` (10,002 parameters, 50,000 rows) and its smaller copies,
held against the JAX package.

``glmm_large(rt, ...)`` is a copy of ``benchmarks/models.py:162-202``
with its sizes as arguments, built through either package; f32
throughout.  Over ``emit_cuda.LOCAL_STATE_MAX`` parameters or
row-invariant values the emitted density runs its vectors as loops and
the kernel keeps each chain's state in a workspace.  Checked here, with
the tolerance and its reason at each assertion:

* the full-size model against ``jax.value_and_grad``, and its emitted
  header (loops, the workspace);
* ``csrc/fused_hmc.cu`` compiled for the host with g++ on a 300-group
  model (1,500 rows, past the register layout, lam 1 and lam 0): the
  density through the tile loop against autograd and ``jax.grad``, and
  the kernel's loop against ``fused_hmc_reference`` in both RNG modes;
* ``fused_hmc_reference`` against the JAX kernel in interpret mode on a
  small VIP GLMM;
* the collected coordinates: the draws of ``collect_idx`` equal the full
  draws sliced, in the host build and the plain version, and
  ``Model.sample(kernel="fused!", collect_idx=...)`` against the scan
  path;
* the funnel, README regression and logistic emit the header they did
  before the workspace existed, with no loop.
"""

import hashlib
import re

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
from rainier_tpu_torch.sampler.driver import _fused_unsupported_reason
from test_torch_columns import (_host_library, _host_logp_grad, _jax_noise,
                                _laplace_start, _run_host, logistic,
                                readme_regression)
from test_torch_density import _compile_host
from test_torch_fused_hmc import funnel

torch.set_num_threads(2)
rtt.config.set_device("cpu")

HOST_GROUPS = 300


def glmm_large(rt, n_groups=10_000, obs_per_group=5, seed=6, lam=1.0):
    """benchmarks/models.py:162-202 with its sizes as arguments: one
    VectorParameter of group effects at VIP weight `lam`, gathered by an
    IntColumn into a Poisson likelihood of `obs_per_group` rows each."""
    R = Rj if rt is rtj else Rt
    rng = np.random.default_rng(seed)
    n = n_groups * obs_per_group
    mu = rt.Normal(0, 1).latent()
    sd = rt.Exponential(1.0).latent()
    effects = rt.vip_latent_vec(mu, sd, n_groups, lam=lam)
    group_idx = R.IntColumn(np.repeat(np.arange(n_groups), obs_per_group))
    true_effects = rng.normal(np.log(5.0), 0.3, size=n_groups)
    counts = rng.poisson(
        np.exp(np.repeat(true_effects, obs_per_group))).astype(float)
    log_lam = R.Gather(effects.element, group_idx)
    lh = R.RowSum(rt.Poisson(log_lam.exp()).log_density_at(
        R.Column(counts)), n)
    return rt.Model.likelihood(lh)


def _points(n_groups, k, seed, lam=1.0):
    """(n_groups + 2, k) points near the data: mu near log 5, log sd near
    log 0.3, and the raw effects near what the data give at `lam`."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(np.log(5.0) * lam, 0.3, size=(n_groups, k))
    return np.vstack([rng.normal(np.log(5.0), 0.05, (1, k)),
                      rng.normal(np.log(0.3), 0.1, (1, k)),
                      raw]).astype(np.float32)


# -- the full-size model ------------------------------------------------------


def test_full_size_glmm_large_matches_jax():
    """glmm_large at 10,000 groups × 5 rows: the port's logp and gradient
    (autograd on the lanes evaluator) against jax.value_and_grad at 3
    points.  f32 sums of 50,000 row terms and 10,000 prior terms in other
    orders: rtol 1e-5 / atol 1e-5·(1 + |lp|), gradients within 1e-5 of
    max |g|."""
    cdt, cdj = glmm_large(rtt).density(), glmm_large(rtj).density()
    assert cdt.n_vars == cdj.n_vars == 10_002
    q = _points(10_000, 3, 1)
    cols = cdt.column_values(torch.float32, "cpu")
    lp_t, g_t = cdt.batched_logp_and_grad_fn()(torch.as_tensor(q.T), cols)
    lp_j, g_j = jax.vmap(jax.value_and_grad(cdj.logp_fn()),
                         in_axes=(0, None))(jnp.asarray(q.T),
                                            cdj.column_values(jnp.float32))
    lp_j, g_j = np.asarray(lp_j), np.asarray(g_j)
    np.testing.assert_allclose(lp_t.numpy(), lp_j, rtol=1e-5,
                               atol=1e-5 * (1 + np.abs(lp_j).max()))
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0,
                               atol=1e-5 * np.abs(g_j).max())


def test_full_size_glmm_large_emits_loops_over_a_workspace():
    """The emitted density of glmm_large: every vector a loop (the header
    is a few hundred lines, not one per element), the 10,000 group
    effects' block read only by the gather (so the row hands its adjoint
    to the warp, which adds the lanes' into the chain's ainv),
    restrict-qualified chain arrays, and the operation count of every
    element."""
    cd = glmm_large(rtt).density()
    em = emit_cuda.emit(cd)
    assert (em.n_vars, em.n_inv, em.n_rows, em.row_width) == (
        10_002, 10_000, 50_000, 2)
    assert em.workspace == emit_cuda.workspace_floats(10_002, 10_000, True)
    src = em.source
    # loops, not one line an element; the rows' step function holds the
    # row's body once for each of its GATHER_STEP rows
    step_fn = re.search(r"RT_HD void rt_row_step\(.*?\n}\n", src,
                        re.S).group(0)
    assert len(src.replace(step_fn, "").splitlines()) < 300
    assert len(step_fn.splitlines()) < 20 * emit_cuda.GATHER_STEP
    assert src.count(
        "for (int i = RT_LANE; i < 10000; i += RT_LSTEP)") == 4
    assert "#define RT_NINV_DENSE 0" in src
    assert "inv[0 + j" in src and "sidx[0] = 0 + j" in src
    # every chain array; the rows' steps of GATHER_STEP rows (x, inv,
    # ainv, sidx, sval, out)
    step = emit_cuda.GATHER_STEP
    assert f"#define RT_ROW_STEP {step}" in src
    assert f"sidx[{step - 1}] = 0 + j" in src
    assert src.count("__restrict__") == 12 + 6
    # each group's prior (forward and adjoint, the forward recomputed in
    # the adjoint loop) and its invariant value, 30 to 60 operations
    assert 30 * 10_000 < em.ops < 60 * 10_000
    assert _fused_unsupported_reason(
        glmm_large(rtt, 300), SamplerConfig(10, 10, sampler=HMC(5)),
        1024, None) is None


# -- the host build -----------------------------------------------------------


@pytest.mark.parametrize("lam", [1.0, 0.0])
def test_host_compiled_density_matches_autograd_and_jax(lam, tmp_path):
    """The kernel's density over its workspace, through the tile loop, on
    300 groups (302 parameters, 300 row-invariant values: past the
    register layout), against torch autograd and jax.grad of the JAX
    package's lanes evaluator: the same f32 terms in other orders, so lp
    within rtol 1e-5 / atol 1e-5·(1 + |lp|) and gradients within 1e-5 of
    max |g|."""
    cd = glmm_large(rtt, HOST_GROUPS, lam=lam).density()
    cdj = glmm_large(rtj, HOST_GROUPS, lam=lam).density()
    lib, em = _host_library(cd, tmp_path)
    assert em.workspace and em.n_inv == HOST_GROUPS
    q = torch.as_tensor(_points(HOST_GROUPS, 5, 2, lam))
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


def _warmed_up(model, n, seed=3):
    """q0 (dim, n), ε (n,) and Σ̂ (n, dim) from a short scan-path run."""
    tr = model.sample(SamplerConfig(150, 10, sampler=HMC(5)), n_chains=n,
                      seed=seed)
    return (torch.as_tensor(tr.chains[:, -1, :].T.copy()),
            torch.as_tensor(tr.step_size, dtype=torch.float32),
            torch.as_tensor(tr.mass.diag, dtype=torch.float32))


@pytest.fixture(scope="module")
def warm_300():
    model = glmm_large(rtt, HOST_GROUPS)
    return model, _warmed_up(model, 13)


@pytest.mark.parametrize("noise", ["explicit", "philox"])
def test_host_compiled_kernel_matches_plain_version(noise, warm_300,
                                                    tmp_path):
    """The kernel's loop over its workspace on 300 groups against the
    plain version: 13 chains in the wrapper's blocks of 4 chains (a warp
    each), so the last block holds one chain and three copies of it, each
    copy in a workspace slot of its own (the host build runs every slot,
    its lanes emulated, as the card does); per-chain ε and Σ̂ from a scan-path warmup, and the
    collected coordinates mu, sd and every 100th effect.  The two sum
    the rows and the 300 priors in other orders, so ≥ 90% of chains end
    within 1e-3 (a flipped borderline accept sends a chain away), accept
    rates agree within 0.05 on average, and the collected draws of the
    chains that agree match within 1e-3.  The copies store nothing, so
    the outputs are the 13 chains' alone."""
    model, (q0, eps, imd) = warm_300
    cd = model.density()
    lib, em = _host_library(cd, tmp_path)
    n, n_it, dim = 13, 12, cd.n_vars
    assert F.chains_per_block(em, n) == 4
    assert F.threads_per_block(em, n) == 4 * 32
    assert F.workspace_bytes(em, n) == 4 * em.workspace * 16
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
    idx = np.r_[0, 1, 2 + np.arange(0, HOST_GROUPS, 100)]
    cols = cd.column_values(torch.float32, "cpu")
    ws = []
    got = _run_host(lib, cd, q0, kw, nz, cols, collect_idx=idx, ws_out=ws)
    slots = ws[0].view(16, em.workspace)
    # every slot was the state of a chain or of a copy
    assert not bool(slots[:, :7 * dim].isnan().any())
    # the copies ran chain 12 from its start, in their own slots: their
    # last position is its last position
    q_last = slots[:, dim:2 * dim] * slots[:, :dim]
    for c in (13, 14, 15):
        torch.testing.assert_close(q_last[c], got[0][:, 12], rtol=0,
                                   atol=0)
    ref = F.fused_hmc_reference(cd, q0, noise=nz, collect_idx=idx, **kw)
    rel = ((got[0] - ref[0]).abs() / ref[0].abs().clamp(min=1.0)).amax(0)
    ok = rel <= 1e-3
    assert float(ok.float().mean()) >= 0.9, rel
    assert float((got[2] - ref[2]).abs().mean()) < 0.05
    assert 0.2 < float(ref[2].mean())     # the chains do move
    assert got[1].shape == ref[1].shape == (n_it, len(idx), n)
    torch.testing.assert_close(got[1][..., ok], ref[1][..., ok], rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("name", ["glmm_large", "logistic"])
def test_collected_coordinates_are_the_full_draws_sliced(name, warm_300,
                                                         tmp_path):
    """collect_idx, unsorted and with a repeat, stores exactly the full
    draws' rows at those indices, in the host build of the kernel and in
    the plain version (the same arithmetic: exact): on the 300-group
    model, whose kernel stores only those coordinates, and on the
    1500-row logistic, whose kernel stores every coordinate for the
    wrapper to slice."""
    if name == "glmm_large":
        model, (q0, eps, imd) = warm_300
        idx = (np.array([5, 0, 301, 1, 5]), np.array([2, 7, 101]))
    else:
        model = logistic(rtt)
        q0, var = _laplace_start(13, 0)
        q0, eps, imd = torch.as_tensor(q0), 0.5, torch.as_tensor(var)
        idx = (np.array([3, 0, 3]), np.array([1, 2]))
    cd = model.density()
    lib, em = _host_library(cd, tmp_path)
    assert bool(em.workspace) == (name == "glmm_large")
    kw = dict(step_size=eps, n_steps=3, n_iterations=6, seed=4,
              collect_every=2, inv_mass_diag=imd)
    cols = cd.column_values(torch.float32, "cpu")
    for i in idx:
        full = _run_host(lib, cd, q0, kw, None, cols)
        part = _run_host(lib, cd, q0, kw, None, cols, collect_idx=i)
        assert torch.equal(part[1], full[1][:, i])
        assert torch.equal(part[0], full[0])
        full = F.fused_hmc_reference(cd, q0, **kw)
        part = F.fused_hmc_reference(cd, q0, collect_idx=i, **kw)
        assert torch.equal(part[1], full[1][:, i])
    with pytest.raises(ValueError, match="collect_idx"):
        F.fused_hmc_reference(cd, q0, collect_idx=[0, cd.n_vars], **kw)


def test_plain_version_matches_pallas_kernel_on_a_vip_glmm():
    """fused_hmc_reference on a 12-group VIP GLMM (lam 0.5, 60 rows)
    against the JAX package's kernel, untiled, interpreted with the same
    noise: ≥ 90% of chains within 1e-3 and accept rates within 0.05, the
    bar of test_torch_columns.py for sums in other orders."""
    n, n_it, seed = 128, 20, 5
    mj, mt = glmm_large(rtj, 12, lam=0.5), glmm_large(rtt, 12, lam=0.5)
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


def test_fused_sample_with_collect_idx_matches_scan():
    """Model.sample(kernel="fused!", collect_idx=...) on the 300-group
    model runs the kernel's plain version and keeps mu, sd and every
    100th effect.  Both calls share seed 0, so warmup and its product
    are the same and only the sampling phases' random numbers differ.
    Each collected coordinate's mean is within 0.06 of the scan path's
    (posterior SDs: mu 0.02, log sd 0.1 to 0.2, an effect 0.17; 8 chains
    × 150 autocorrelated draws give each mean a Monte-Carlo error of at
    most 0.02), and each effect's within 0.5 of its group's log mean
    count."""
    model = glmm_large(rtt, HOST_GROUPS)
    idx = [0, 1, 2, 102, 202]
    cfg = SamplerConfig(warmup_iterations=150, iterations=150,
                        sampler=HMC(5))
    tr_scan = model.sample(cfg, n_chains=8, seed=0, collect_idx=idx)
    tr_fused = model.sample(cfg, n_chains=8, seed=0, kernel="fused!",
                            collect_idx=idx)
    assert tr_scan.chains.shape == tr_fused.chains.shape == (8, 150, 5)
    assert np.all(np.isfinite(tr_fused.chains))
    a, b = tr_scan.chains.mean((0, 1)), tr_fused.chains.mean((0, 1))
    assert np.all(np.abs(a - b) < 0.06), (a, b)
    counts = model.density().columns[-1].values.reshape(HOST_GROUPS, 5)
    log_mean = np.log(counts[[0, 100, 200]].mean(1))
    assert np.all(np.abs(b[2:] - log_mean) < 0.5), (b, log_mean)
    assert float(np.mean(tr_fused.accept_rate())) > 0.5


# -- loop shapes of the emitter ---------------------------------------------


def loop_zoo(rt, k):
    """Vector nodes as loops in every shape the emitter has: a sum (stage
    0), a loop of a later stage that reads that sum, one element of a
    loop read as a scalar, LogSumExp and Select in a loop body with a
    scalar broadcast in, and two lengths (k and 24) in one stage."""
    R = Rj if rt is rtj else Rt
    z = rt.Normal(0, 1).latent_vec(k).element
    w = rt.Normal(0.5, 2).latent_vec(24).element
    a = rt.Normal(0, 1).latent()
    s1 = R.VecSum(z * z, k)
    s2 = R.VecSum((z * s1 * 0.01).tanh(), k)
    third = R.Gather(z, R.const(3))
    lse = R.VecSum(R.LogSumExp((z, a)), k)
    sel = R.VecSum(rt.gt(w, 0.5, w * a, w * -0.5), 24)
    return rt.Model.likelihood(s2 * 0.5 + third * a + lse * 0.1
                               + sel * 0.2 - s1 * 0.05)


@pytest.mark.parametrize("k", [40, 300], ids=["registers", "workspace"])
def test_loop_shapes_match_autograd_and_jax(k, tmp_path):
    """Every loop shape of `loop_zoo`, compiled for the host as the card
    runs it, a warp a chain with its 32 lanes emulated, against autograd
    on the port's evaluator and jax.value_and_grad, with the state in a
    slot in shared memory (65 parameters; the id names the per-thread
    arrays it had before its chain took lanes) and in the device
    workspace (325): every loop is split over the lanes, a lane's partial
    sums added in f64 and met in the butterfly's order, against f32 sums
    of at most 300 terms in other orders, so lp within rtol 1e-5 /
    atol 1e-5·(1 + |lp|) and gradients within 1e-5 of max |g|."""
    cd, cdj = loop_zoo(rtt, k).density(), loop_zoo(rtj, k).density()
    lpg, em = _compile_host(cd, tmp_path)
    assert em.workspace
    assert em.shared == (k <= emit_cuda.LOCAL_STATE_MAX)
    src = em.source
    # the lanes of a chain split each loop's elements
    head = "for (int i = RT_LANE; i < {}; i += RT_LSTEP)"
    assert head.format(k) in src
    assert head.format(24) in src
    assert "if (i == 3) k" in src                 # the element read
    lpg_j = jax.value_and_grad(cdj.logp_fn())
    rng = np.random.default_rng(4)
    for _ in range(3):
        q = rng.normal(size=cd.n_vars).astype(np.float32)
        lp, g = lpg(q)
        lp_t, g_t = cd.logp_and_grad(q, device="cpu")
        lp_j, g_j = lpg_j(jnp.asarray(q), ())
        for lp_ref, g_ref in ((float(lp_t), g_t.numpy()),
                              (float(lp_j), np.asarray(g_j))):
            np.testing.assert_allclose(lp, lp_ref, rtol=1e-5,
                                       atol=1e-5 * (1 + abs(lp_ref)))
            np.testing.assert_allclose(g, g_ref, rtol=0,
                                       atol=1e-5 * np.abs(g_ref).max())


# -- the small models keep their header -------------------------------------


def _canonical(src):
    """The header with node ids numbered by first appearance: the text
    does not depend on how many nodes the process built before."""
    ids = {}
    return re.sub(r"\b([a-z])(\d+)", lambda m: m.group(1) + str(
        ids.setdefault(m.group(2), len(ids))), src)


# sha256 of _canonical(header): the funnel's as the parent commit of the
# workspace emitted it; the two with rows as the row loop's redesign for
# the H100 emits them (its loader, its tile sizes, its rows a step and
# its tile loaded once a launch), the logistic's row with its softplus
# pair sharing exp(-|v|), log1p and one reciprocal, the README's row
# multiplying by 1/σ, computed once a call (emit_cuda._reciprocals)
SMALL_HEADERS = {"funnel": "a5ff30fef7ba2450c660",
                 "readme_regression": "dbd775baf5d6aafd257a",
                 "logistic": "947c5613c41ed0539705"}


@pytest.mark.parametrize("name", sorted(SMALL_HEADERS))
def test_small_models_emit_their_header_unchanged(name):
    """The header pinned, apart from the tile loader, which a model with
    rows has after every other function, and which copies its two
    columns."""
    model = {"funnel": funnel, "readme_regression": readme_regression,
             "logistic": logistic}[name](rtt)
    em = emit_cuda.emit(model.density())
    src, _, loader = em.source.partition(
        "\n// rows [row0, row0 + rows) of every column into the tile")
    assert em.workspace == 0
    assert "for (int i = 0;" not in src and "__restrict__" not in src
    assert "RT_WS_FLOATS" not in src and "RT_NINV_DENSE" not in src
    assert hashlib.sha256(_canonical(src).encode()).hexdigest()[:20] == \
        SMALL_HEADERS[name]
    assert len(set(re.findall(r"cols\.c(\d+)\[", loader))) == (
        0 if name == "funnel" else 2)
