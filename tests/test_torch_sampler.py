"""Parity of the PyTorch port's sampler layer with the JAX package.

Deterministic pieces must match exactly or within f32 rounding: the
adaptation-window schedule, the dual-averaging constants and updates,
the initial step-size search, a leapfrog trajectory from a fixed
momentum, and the host diagnostics.  Stochastic pieces (the RNG streams
differ) must match posterior moments within Monte-Carlo error: the
funnel through ``Model.sample`` on the port's ``scan`` and ``fused!``
paths against the JAX package's ``kernel="pallas"``.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu.core import trace as trace_j
from rainier_tpu.sampler import dualavg as dualavg_j
from rainier_tpu.sampler import mass as mass_j
from rainier_tpu.sampler.leapfrog import ChainState as ChainState_j
from rainier_tpu.sampler.leapfrog import leapfrog as leapfrog_j
from rainier_tpu.sampler.leapfrog import log_accept_prob as lap_j
from rainier_tpu.sampler.leapfrog import try_stepping as try_stepping_j
from rainier_tpu_torch import interop
from rainier_tpu_torch.compute import emit_cuda
from rainier_tpu_torch.sampler import HMC, SamplerConfig
from rainier_tpu_torch.sampler import dualavg, mass
from rainier_tpu_torch.sampler.leapfrog import (ChainState, leapfrog,
                                                log_accept_prob, try_stepping)
from rainier_tpu_torch.sampler.driver import (_fused_unsupported_reason,
                                              run_sampling)

torch.set_num_threads(2)
rtt.config.set_device("cpu")


def funnel(rt):
    y = rt.Normal(0.0, 3.0).latent()
    xv = rt.Normal(0.0, (y / 2).exp()).latent_vec(9)
    return rt.Model.track_({y} | set(xv.to_list())), y


def normal_observe(rt):
    data = list(np.random.default_rng(3).normal(1.5, 2.0, size=64))
    mu = rt.Normal(0, 10).latent()
    return rt.Model.observe(data, rt.Normal(mu, rt.Exponential(0.5).latent()))


@pytest.mark.parametrize("args", [(1000, 50, 1.5, 50, 50),
                                  (300, 20, 2.0, 15, 30),
                                  (150, 75, 1.5, 50, 50), (17, 3, 1.3, 2, 4)])
def test_window_masks_exact(args):
    up_t, close_t = mass.window_masks(*args)
    up_j, close_j = mass_j.window_masks(*args)
    np.testing.assert_array_equal(up_t, np.asarray(up_j))
    np.testing.assert_array_equal(close_t, np.asarray(close_j))


def test_dual_avg_constants_match_reference():
    # the values tests/test_reference_constants.py pins for the JAX package
    assert dualavg.STEP_SIZE_UPDATE_DENOM == 0.05
    assert dualavg.ACCEPT_PROB_UPDATE_DENOM == 10.0
    assert dualavg.DECAY_RATE == 0.75
    assert dualavg.MIN_LOG_STEP == dualavg_j.MIN_LOG_STEP
    assert SamplerConfig().warmup_iterations == 1000
    assert SamplerConfig().iterations == 1000
    s = dualavg.dual_avg_init(torch.tensor([0.25]))
    assert float(s.shrinkage_target[0]) == pytest.approx(
        math.log(10.0 * 0.25), rel=1e-6)


def test_dual_avg_updates_match_jax():
    rng = np.random.default_rng(0)
    las = np.minimum(rng.normal(-0.3, 0.6, size=(60, 4)), 0.0)
    st = dualavg.dual_avg_init(torch.full((4,), 0.4))
    sj = [dualavg_j.dual_avg_init(jnp.float32(0.4)) for _ in range(4)]
    for i, la in enumerate(las):
        st = dualavg.dual_avg_update(st, torch.as_tensor(la, dtype=torch.float32),
                                     0.8)
        sj = [dualavg_j.dual_avg_update(s, jnp.float32(a), 0.8)
              for s, a in zip(sj, la)]
        if i == 30:
            st = dualavg.dual_avg_reset(st)
            sj = [dualavg_j.dual_avg_reset(s) for s in sj]
    for field in st._fields:
        np.testing.assert_allclose(
            getattr(st, field).numpy(),
            [float(getattr(s, field)) for s in sj], rtol=2e-5, atol=1e-6)


def _funnel_lpgs():
    mt, _ = funnel(rtt)
    mj, _ = funnel(rtj)
    lpg_t = mt.density().batched_logp_and_grad_fn()
    lpg_j = mj.density().logp_and_grad_fn()
    return (lambda q: lpg_t(q, ())), (lambda q: lpg_j(q, ()))


def test_find_reasonable_step_size_matches_jax():
    lpg_t, lpg_j = _funnel_lpgs()
    rng = np.random.default_rng(1)
    q = rng.normal(size=(5, 10)).astype(np.float32) * 2.0
    p = rng.normal(size=(5, 10)).astype(np.float32)
    lp, g = lpg_t(torch.as_tensor(q))
    chain = ChainState(torch.as_tensor(q), -lp, g)
    got = dualavg.find_reasonable_step_size(
        lambda e: try_stepping(chain, torch.as_tensor(p), e,
                                        mass.identity_mass(), lpg_t),
        torch.ones(5))
    for i in range(5):
        lpj, gj = lpg_j(jnp.asarray(q[i]))
        cj = ChainState_j(jnp.asarray(q[i]), -lpj, gj)
        want = dualavg_j.find_reasonable_step_size(
            lambda e: try_stepping_j(cj, jnp.asarray(p[i]), e,
                                              mass_j.identity_mass(), lpg_j))
        assert float(got[i]) == float(want)


def test_leapfrog_trajectory_matches_jax():
    lpg_t, lpg_j = _funnel_lpgs()
    rng = np.random.default_rng(2)
    q = rng.normal(size=(3, 10)).astype(np.float32)
    p = rng.normal(size=(3, 10)).astype(np.float32)
    diag = rng.uniform(0.5, 2.0, size=(3, 10)).astype(np.float32)
    eps = np.asarray([0.1, 0.25, 0.4], np.float32)
    lp, g = lpg_t(torch.as_tensor(q))
    st, pt = leapfrog(
        ChainState(torch.as_tensor(q), -lp, g), torch.as_tensor(p),
        torch.as_tensor(eps), 10, mass.diag_mass(torch.as_tensor(diag)),
        lpg_t)
    for i in range(3):
        lpj, gj = lpg_j(jnp.asarray(q[i]))
        sj, pj = leapfrog_j(
            ChainState_j(jnp.asarray(q[i]), -lpj, gj),
            jnp.asarray(p[i]), jnp.float32(eps[i]), 10,
            mass_j.diag_mass(jnp.asarray(diag[i])), lpg_j)
        np.testing.assert_allclose(st.q[i].numpy(), np.asarray(sj.q),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(pt[i].numpy(), np.asarray(pj), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(float(st.potential[i]),
                                   float(sj.potential), rtol=1e-5)


def test_log_accept_prob_rejects_any_nonfinite_energy():
    h0 = torch.tensor([1.0, float("inf"), 1.0, float("nan"), 2.0])
    h1 = torch.tensor([1.5, 1.0, float("inf"), 1.0, 1.0])
    la = log_accept_prob(h0, h1)
    np.testing.assert_allclose(la.numpy(), [-0.5, -np.inf, -np.inf, -np.inf,
                                            0.0])
    lj = [float(lap_j(jnp.float32(a), jnp.float32(b)))
          for a, b in zip(h0.tolist(), h1.tolist())]
    np.testing.assert_allclose(la.numpy(), lj)


def test_host_diagnostics_match_jax():
    chains = np.random.default_rng(4).normal(size=(4, 120, 3)).cumsum(1)
    chains = chains.astype(np.float32)
    tr = rtt.core.Trace(chains, None, None, None)
    for split, rank in ((False, False), (True, False), (True, True)):
        got = tr.diagnostics(split=split, rank_normalized=rank,
                             device=False)
        ch = chains
        if split:
            ch = trace_j._split_chains(ch)
        if rank:
            ch = trace_j._rank_normalize(ch)
        r_hat, ess = trace_j._diagnostics_all(ch)
        np.testing.assert_allclose([d.r_hat for d in got], r_hat, rtol=1e-12)
        np.testing.assert_allclose([d.effective_sample_size for d in got],
                                   ess, rtol=1e-12)


FUNNEL_CFG = dict(warmup_iterations=200, iterations=400)


@pytest.fixture(scope="module")
def pallas_funnel():
    model, y = funnel(rtj)
    cfg = rtj.SamplerConfig(sampler=rtj.HMC(5), **FUNNEL_CFG)
    tr = model.sample(cfg, n_chains=16, seed=0, kernel="pallas!")
    return tr.evaluate(y)


@pytest.mark.parametrize("kernel", ["scan", "fused!"])
def test_funnel_moments_match_pallas(kernel, pallas_funnel):
    """Model.sample on the port (CPU: the fused kernel's plain version)
    and the JAX package's fused Pallas path agree within MC error:
    y ~ N(0, 3²), 16 chains × 400 draws each (well over 1000 effective
    draws, so sd(mean y) < 0.1 and sd(var y)/9 < 0.05)."""
    model, y = funnel(rtt)
    tr = model.sample(SamplerConfig(sampler=HMC(5), **FUNNEL_CFG),
                      n_chains=16, seed=0, kernel=kernel)
    assert tr.chains.shape == (16, 400, 10)
    ys = tr.evaluate(y)
    yj = pallas_funnel
    assert abs(np.mean(ys)) < 0.4 and abs(np.mean(yj)) < 0.4
    assert abs(np.mean(ys) - np.mean(yj)) < 0.5
    assert abs(np.var(ys) / 9.0 - 1.0) < 0.25
    assert abs(np.var(ys) / np.var(yj) - 1.0) < 0.35
    assert float(np.mean(tr.accept_rate())) > 0.6
    assert tr.divergences() == 0
    assert max(d.r_hat for d in tr.diagnostics(rank_normalized=True)) < 1.05
    assert set(tr.timings) == {"build_s", "compile_s", "warmup_s",
                               "sample_s", "transfer_s"}


def gather_by_int_column(rt, k=4):
    """benchmarks/models.py:111-142's structure: k latent effects
    gathered by an integer index column, three rows each."""
    from rainier_tpu_torch.compute import real as R

    effects = rt.Normal(0, 1).latent_vec(k)
    idx = R.IntColumn(np.repeat(np.arange(k), 3))
    y = np.random.default_rng(8).normal(size=3 * k)
    return rt.Model.likelihood(R.RowSum(rt.Normal(
        R.Gather(effects.element, idx), 1.0).log_density_at(R.Column(y)),
        3 * k))


def test_fused_refuses_or_falls_back_outside_its_envelope(monkeypatch):
    """A gather model (the GLMMs) past LOCAL_STATE_MAX parameters runs in
    the kernel with its state in the workspace; where the device has no
    room for that workspace, 'fused!' raises and 'fused' warns and runs
    the scan path, each naming the bytes."""
    from rainier_tpu_torch.ops import fused_hmc as F

    cfg = SamplerConfig(30, 20, sampler=HMC(3))
    assert _fused_unsupported_reason(gather_by_int_column(rtt), cfg, 2,
                                     None) is None
    k = emit_cuda.LOCAL_STATE_MAX + 8
    model = gather_by_int_column(rtt, k)
    assert _fused_unsupported_reason(model, cfg, 2, None) is None
    monkeypatch.setattr(F, "free_bytes", lambda device: 4096)
    reason = _fused_unsupported_reason(model, cfg, 2, None)
    need = F.workspace_bytes(emit_cuda.emit(model.density()), 2)
    assert f"workspace for 2 chains is {need} bytes" in reason
    with pytest.raises(ValueError, match=f"{need} bytes"):
        model.sample(cfg, n_chains=2, kernel="fused!")
    with pytest.warns(UserWarning, match=f"{need} bytes"):
        tr = model.sample(cfg, n_chains=2, kernel="fused")
    assert tr.chains.shape == (2, 20, k)    # the scan path ran
    fm, _ = funnel(rtt)
    with pytest.raises(ValueError, match="fixed-step HMC"):
        fm.sample(SamplerConfig(10, 10), n_chains=2, kernel="fused!")
    dense = SamplerConfig(10, 10, sampler=HMC(3),
                          mass_matrix=rtt.sampler.DenseMassMatrixTuner())
    with pytest.raises(ValueError, match="diagonal"):
        fm.sample(dense, n_chains=2, kernel="fused!")
    with pytest.raises(ValueError, match="single-device"):
        fm.sample(cfg, n_chains=2, kernel="fused!", mesh=object())
    with pytest.raises(ValueError, match="unknown kernel"):
        fm.sample(cfg, n_chains=2, kernel="pallas")


def test_scan_path_adapts_per_chain_and_pooled():
    model = normal_observe(rtt)
    for pooled in (False, True):
        cfg = SamplerConfig(300, 40, sampler=HMC(4),
                            pooled_adaptation=pooled)
        tr = model.sample(cfg, n_chains=4, seed=1)
        assert np.all(np.isfinite(tr.chains))
        assert tr.mass.diag.shape == (4, 2)
        # pooled Welford windows give every chain the same Σ̂ diagonal
        same = np.allclose(tr.mass.diag, tr.mass.diag[:1])
        assert same if pooled else not same


def test_default_sampler_runs_and_devices_raise(monkeypatch):
    fm, _ = funnel(rtt)
    # the default config, EHMC(1024), samples on the scan path
    tr = fm.sample(SamplerConfig(5, 5), n_chains=2, device="cpu")
    assert tr.chains.shape == (2, 5, 10)
    monkeypatch.setattr(rtt.config, "_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fm.sample(SamplerConfig(5, 5, sampler=HMC(2)), n_chains=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fm.density().logp(np.zeros(10))


@pytest.mark.parametrize("cfg", [
    SamplerConfig(10, 10, sampler=rtt.sampler.EHMC(max_steps=16)),
    SamplerConfig(10, 10, sampler=rtt.sampler.NUTS(max_depth=4)),
    SamplerConfig(10, 10, sampler=HMC(3),
                  mass_matrix=rtt.sampler.DenseMassMatrixTuner(4, 1.5, 2, 2)),
], ids=["ehmc", "nuts", "dense-mass"])
def test_fused_falls_back_to_the_scan_path_outside_fixed_step_diag(cfg):
    fm, _ = funnel(rtt)
    reason = ("fixed-step HMC" if not isinstance(cfg.sampler, HMC)
              else "diagonal")
    with pytest.raises(ValueError, match=reason):
        fm.sample(cfg, n_chains=2, kernel="fused!")
    with pytest.warns(UserWarning, match=reason):
        tr = fm.sample(cfg, n_chains=2, kernel="fused")
    assert tr.chains.shape == (2, 10, 10) and np.all(np.isfinite(tr.chains))


def test_interop_round_trip_of_jax_ehmc_dense_warmup_product():
    """A JAX warmup product under EHMC and dense mass (its ring and Σ̂
    with its Cholesky factor) crosses to the port and back exactly, and
    the port's scan path samples from it."""
    model, _ = funnel(rtj)
    cd = model.density()
    lpg = cd.logp_and_grad_fn()
    from rainier_tpu.sampler.driver import build_warmup_fn

    cfg_j = rtj.SamplerConfig(
        60, 10, sampler=rtj.sampler.EHMC(max_steps=32),
        mass_matrix=rtj.sampler.DenseMassMatrixTuner(10, 1.5, 10, 10))
    warm = jax.vmap(build_warmup_fn(lambda q: lpg(q, ()), cd.n_vars, cfg_j,
                                    jnp.float32), axis_name="chains")
    wp_j = warm(jax.random.split(jax.random.PRNGKey(0), 4))
    d = interop.warmup_product_to_numpy(wp_j)
    assert d["mass_diag"] is None and d["mass_cov"].shape == (4, 10, 10)
    assert d["ring_buf"].shape == (4, 100) and int(d["ring_count"][0]) > 0
    wp_t = interop.warmup_product_from_numpy(d, device="cpu")
    back = interop.warmup_product_to_numpy(wp_t)
    assert back.keys() == d.keys()
    for k, v in d.items():
        if v is None:
            assert back[k] is None
        else:
            np.testing.assert_array_equal(back[k], v)
    assert wp_t.extra.idx.dtype == torch.int32
    cfg_t = SamplerConfig(60, 10, sampler=rtt.sampler.EHMC(max_steps=32))
    cd_t = funnel(rtt)[0].density()
    raw = cd_t.batched_logp_and_grad_fn()
    cols = cd_t.column_values(torch.float32, torch.device("cpu"))
    samples, stats, _ = run_sampling(lambda q: raw(q, cols), cfg_t, wp_t,
                                     torch.Generator().manual_seed(0))
    assert samples.shape == (4, 10, 10) and torch.isfinite(samples).all()
    # synchronized replay: every chain took the same steps
    assert (stats.grad_evals == stats.grad_evals[0]).all()


def test_interop_round_trip_of_jax_warmup_product():
    model, _ = funnel(rtj)
    cd = model.density()
    lpg = cd.logp_and_grad_fn()
    from rainier_tpu.sampler.driver import build_warmup_fn

    cfg = rtj.SamplerConfig(40, 10, sampler=rtj.HMC(3))
    warm = jax.vmap(build_warmup_fn(lambda q: lpg(q, ()), cd.n_vars, cfg,
                                    jnp.float32))
    wp_j = warm(jax.random.split(jax.random.PRNGKey(0), 3))
    d = interop.warmup_product_to_numpy(wp_j)
    wp_t = interop.warmup_product_from_numpy(d, device="cpu")
    back = interop.warmup_product_to_numpy(wp_t)
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], v)
    assert wp_t.chain.q.shape == (3, 10) and wp_t.step_size.shape == (3,)
