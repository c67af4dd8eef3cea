"""Chain driver: warmup + sampling (port of rainier_tpu/sampler/driver.py;
counterpart of sampler/Driver.scala:6-120).

* All chains run simultaneously as the leading batch dimension of every
  tensor (the JAX package vmaps a per-chain program instead).
* The expanding adaptation-window schedule is data-independent and
  precomputed on the host (mass.window_masks); a window close is a
  Python ``if`` on that schedule, so no iteration waits for the device.
* Warmup returns an explicit `WarmupProduct`; sampling runs either as a
  loop of batched transitions (``kernel="scan"``) or, for fixed-step HMC,
  as ONE fused CUDA kernel for the whole sampling phase
  (``kernel="fused"``, ops/fused_hmc.py) — the counterpart of the JAX
  package's ``kernel="pallas"``.

Cross-chain pooled adaptation (config.pooled_adaptation) averages the
acceptance statistics and the Welford state (the variances, and the
covariance of dense mass) over the chain dimension.

EHMC, NUTS and dense mass run on the scan path only, as in the JAX
package (its driver.py:532-536): the fused kernel samples with
fixed-step HMC and identity or diagonal mass.
"""

from __future__ import annotations

import time as _time
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import config as global_config
from ..compute import emit_cuda
from . import config as C
from . import samplers
from .dualavg import (current_step_size, dual_avg_init, dual_avg_reset,
                      dual_avg_update, final_step_size,
                      find_reasonable_step_size)
from .leapfrog import ChainState, try_stepping
from .mass import (MassState, dense_mass, diag_mass, identity_mass,
                   kinetic, mass_from_welford, welford_init, welford_update,
                   window_masks)
from .stats import StatsState, stats_init, stats_update


class WarmupProduct(NamedTuple):
    """Everything sampling needs (see interop.py for the JAX package's
    counterpart)."""

    chain: ChainState
    extra: object
    mass: MassState
    step_size: torch.Tensor     # (C,)
    warmup_stats: StatsState


class ChainResult(NamedTuple):
    samples: torch.Tensor       # (C, n_out, n_collect)
    mass: MassState
    step_size: torch.Tensor
    warmup_stats: StatsState
    stats: StatsState
    final_q: torch.Tensor


def _mass_kind(mass_cfg) -> str:
    if isinstance(mass_cfg, C.IdentityMassMatrix):
        return "identity"
    if isinstance(mass_cfg, C.DiagonalMassMatrixTuner):
        return "diag"
    if isinstance(mass_cfg, C.DenseMassMatrixTuner):
        return "dense"
    if isinstance(mass_cfg, C.StaticMassMatrix):
        return "static"
    raise TypeError(mass_cfg)


def _initial_mass(mass_cfg, shape, dtype, device) -> MassState:
    """One mass a chain (rainier_tpu/sampler/driver.py:109-120)."""
    n_chains, n_vars = shape
    if isinstance(mass_cfg, C.StaticMassMatrix):
        if mass_cfg.diag is not None:
            d = torch.as_tensor(mass_cfg.diag, dtype=dtype, device=device)
            return diag_mass(d.expand(shape).clone())
        if mass_cfg.cov is not None:
            cov = torch.as_tensor(mass_cfg.cov, dtype=dtype, device=device)
            return dense_mass(cov.expand(n_chains, n_vars, n_vars).clone())
    if isinstance(mass_cfg, C.DiagonalMassMatrixTuner):
        return diag_mass(torch.ones(shape, dtype=dtype, device=device))
    if isinstance(mass_cfg, C.DenseMassMatrixTuner):
        # identity-valued placeholder with the dense structure
        eye = torch.eye(n_vars, dtype=dtype, device=device)
        return dense_mass(eye.expand(n_chains, n_vars, n_vars).clone())
    return identity_mass()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def init_chains(lpg, n_chains: int, n_vars: int, cfg: C.SamplerConfig,
                gen, dtype, device) -> ChainState:
    """Overdispersed starts q0 ~ N(0, init_scale²·I) (LeapFrog.scala:
    102-110).  A chain whose logp or gradient is non-finite is redrawn,
    bounded at 100 draws — Stan's init-retry policy; the JAX package's
    vmapped while_loop becomes a batched loop over a per-chain mask."""
    shape = (n_chains, n_vars)

    def draw():
        q = cfg.init_scale * torch.randn(shape, generator=gen, dtype=dtype,
                                         device=device)
        lp, g = lpg(q)
        return q, lp, g

    q, lp, g = draw()
    for _ in range(99):
        bad = ~torch.isfinite(lp) | ~torch.isfinite(g).all(dim=-1)
        if not bool(bad.any()):
            break
        q2, lp2, g2 = draw()
        q = torch.where(bad[:, None], q2, q)
        lp = torch.where(bad, lp2, lp)
        g = torch.where(bad[:, None], g2, g)
    return ChainState(q=q, potential=-lp, grad=g)


def run_warmup(lpg, n_vars: int, cfg: C.SamplerConfig, n_chains: int, gen,
               dtype, device) -> WarmupProduct:
    """Initialization, step-size search, and the windowed adaptation of
    step size and mass (the JAX package's build_warmup_pieces)."""
    adaptive_step = isinstance(cfg.step_size, C.DualAvgStepSize)
    delta = cfg.step_size.delta if adaptive_step else 0.8
    kind = _mass_kind(cfg.mass_matrix)
    tuned_mass = kind in ("diag", "dense")
    pooled = cfg.pooled_adaptation
    W = cfg.warmup_iterations
    if tuned_mass:
        update_mask, close_mask = window_masks(
            W, cfg.mass_matrix.initial_window, cfg.mass_matrix.expansion,
            cfg.mass_matrix.skip_first, cfg.mass_matrix.skip_last)
    else:
        update_mask = close_mask = np.zeros(W, dtype=bool)
    shape = (n_chains, n_vars)

    chain = init_chains(lpg, n_chains, n_vars, cfg, gen, dtype, device)
    mass = _initial_mass(cfg.mass_matrix, shape, dtype, device)
    p_init = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    if adaptive_step:
        eps0 = find_reasonable_step_size(
            lambda e: try_stepping(chain, p_init, e, identity_mass(), lpg),
            torch.ones(n_chains, dtype=dtype, device=device))
        da = dual_avg_init(eps0)
        static_eps = None
    else:
        static_eps = torch.full((n_chains,), cfg.step_size.step_size,
                                dtype=dtype, device=device)
        da = dual_avg_init(static_eps)
    dense = kind == "dense"
    welford = welford_init(shape, dtype, device, dense)
    extra = samplers.init_extra(cfg.sampler, n_chains, dtype, device)
    stats = stats_init(chain.potential + kinetic(mass, p_init))

    for it in range(W):
        eps = current_step_size(da) if adaptive_step else static_eps
        res, extra, n_grads = samplers.step(
            cfg.sampler, gen, chain, eps, mass, extra, lpg, warmup=True)
        if adaptive_step:
            la = res.log_accept
            if pooled:
                la = torch.log(torch.clamp(torch.exp(la).mean(),
                                           min=1e-30)).expand(n_chains)
            da = dual_avg_update(da, la, delta)
        if update_mask[it]:
            welford = welford_update(welford, res.state.q)
        if close_mask[it]:
            w = welford
            if pooled:
                # the JAX package's pmean of the whole Welford state
                w = w._replace(
                    mean=w.mean.mean(0).expand(shape),
                    raw=w.raw.mean(0).expand(shape),
                    cov_raw=None if w.cov_raw is None
                    else w.cov_raw.mean(0).expand_as(w.cov_raw))
            mass = mass_from_welford(w, kind)
            if adaptive_step:
                da = dual_avg_reset(da)
            welford = welford_init(shape, dtype, device, dense)
        stats = stats_update(stats, res.log_accept, res.divergent,
                             res.energy, n_grads)
        chain = res.state
    step = final_step_size(da) if adaptive_step else static_eps
    return WarmupProduct(chain=chain, extra=extra, mass=mass, step_size=step,
                         warmup_stats=stats)


def run_sampling(lpg, cfg: C.SamplerConfig, wp: WarmupProduct, gen,
                 collect_idx=None):
    """Scan-path sampling phase: one collected draw per `cfg.thin`
    transitions.  Returns (samples (C, n_out, k), stats, final q)."""
    thin = max(cfg.thin, 1)
    n_out = cfg.iterations // thin
    q = wp.chain.q
    cidx = None if collect_idx is None else torch.as_tensor(
        np.asarray(collect_idx), device=q.device)
    k = q.shape[1] if cidx is None else cidx.numel()
    samples = torch.empty((q.shape[0], n_out, k), dtype=q.dtype,
                          device=q.device)
    chain, extra = wp.chain, wp.extra
    stats = stats_init(wp.warmup_stats.prev_energy)
    for o in range(n_out):
        for _ in range(thin):
            res, extra, n_grads = samplers.step(
                cfg.sampler, gen, chain, wp.step_size, wp.mass, extra, lpg,
                warmup=False)
            stats = stats_update(stats, res.log_accept, res.divergent,
                                 res.energy, n_grads)
            chain = res.state
        samples[:, o] = chain.q if cidx is None else chain.q[:, cidx]
    return samples, stats, chain.q


def sample(model, cfg: C.SamplerConfig, n_chains: int = 4, seed: int = 0,
           collect_idx=None, dtype=None, device=None, mesh=None,
           kernel: str = "scan"):
    """Run inference on `model`; returns a Trace.

    `device`: where the run happens — the process default
    (rainier_tpu_torch.config.device(), "cuda") unless given.
    `kernel`: 'scan' (default) runs every transition as batched PyTorch
    ops; 'fused' runs scan-path warmup, then the whole sampling phase as
    one fused CUDA kernel (ops/fused_hmc.py; its plain PyTorch version
    on the CPU).  Outside the kernel's envelope (non-HMC samplers, dense
    mass, a mesh, nodes the CUDA emitter does not cover such as a Gather
    whose source varies by row, a density without a clean base/row split,
    a kernel workspace larger than the device's free memory) 'fused'
    warns and runs the scan path; 'fused!' raises, for callers who need
    the kernel or nothing.  `collect_idx` (an index array into the
    parameters) keeps only those coordinates of each draw, on either
    path; a kernel with its state in the workspace stores only them.
    `dtype` is the sampler's (default ``config.dtype()``); on the fused
    path it is warmup's (default float32), and the kernel's state is
    float32 whatever it is.
    `mesh`: multi-device runs come in a later slice of the port.
    """
    if kernel in ("fused", "fused!"):
        reason = _fused_unsupported_reason(model, cfg, n_chains, mesh,
                                           device)
        if reason is None:
            # the split check, warmup and the kernel read one copy of the
            # columns on the device
            cd = model.density()
            cols = cd.column_values(torch.float32,
                                    global_config.resolve_device(device))
            if cols and not _verify_split(cd, cols, [
                    s.tile_rows for s in emit_cuda.emit(cd).spaces]):
                reason = ("the density's base/row split failed its numeric "
                          "check (base + sum over row tiles != the whole "
                          "density)")
        if reason is None:
            return _fused_sample(model, cfg, n_chains, seed, collect_idx,
                                 device, cols, dtype)
        if kernel == "fused!":
            raise ValueError(f"kernel='fused!': {reason}")
        warnings.warn(f"kernel='fused' falling back to the scan path: "
                      f"{reason}", stacklevel=2)
        kernel = "scan"
    if kernel != "scan":
        raise ValueError(f"unknown kernel {kernel!r} "
                         "(expected 'scan', 'fused' or 'fused!')")
    if mesh is not None:
        raise NotImplementedError("multi-device runs come in a later slice "
                                  "of the port")
    dev = global_config.resolve_device(device)
    dtype = dtype or global_config.dtype()
    timings: dict = {}
    t_build = _time.perf_counter()
    cd = model.density()
    cols = cd.column_values(dtype, dev)
    lpg_raw = cd.batched_logp_and_grad_fn()

    def lpg(q):
        return lpg_raw(q, cols)

    gen = torch.Generator(device=dev).manual_seed(seed)
    timings["build_s"] = _time.perf_counter() - t_build
    # eager PyTorch: nothing is compiled on this path
    timings["compile_s"] = 0.0

    t0 = _time.perf_counter()
    wp = run_warmup(lpg, cd.n_vars, cfg, n_chains, gen, dtype, dev)
    _sync(dev)
    timings["warmup_s"] = _time.perf_counter() - t0
    t_run = _time.perf_counter()
    samples, sstats, final_q = run_sampling(lpg, cfg, wp, gen, collect_idx)
    _sync(dev)
    timings["sample_s"] = _time.perf_counter() - t_run
    walltime = _time.perf_counter() - t0
    result = ChainResult(samples=samples, mass=wp.mass,
                         step_size=wp.step_size,
                         warmup_stats=wp.warmup_stats, stats=sstats,
                         final_q=final_q)
    return _finish(model, cd, result, cfg, collect_idx, walltime, timings)


def _finish(model, cd, result, cfg, collect_idx, walltime, timings):
    from ..core.trace import Trace

    t_xfer = _time.perf_counter()
    trace = Trace.from_result(model, cd, result, cfg,
                              collect_idx=collect_idx, walltime=walltime)
    timings["transfer_s"] = _time.perf_counter() - t_xfer
    trace.timings = {k: round(v, 3) for k, v in timings.items()}
    return trace


def _fused_unsupported_reason(model, cfg, n_chains, mesh,
                              device=None) -> Optional[str]:
    """None if the fused kernel can run this config on `device`, else a
    human-readable reason (the caller warns-and-falls-back or raises)."""
    from ..ops.fused_hmc import workspace_check

    if mesh is not None:
        return ("the fused kernel is single-device; multi-device runs use "
                "the scan path")
    if not isinstance(cfg.sampler, C.HMC):
        return ("the fused kernel samples with fixed-step HMC; "
                f"{type(cfg.sampler).__name__} runs on the scan path")
    kind = _mass_kind(cfg.mass_matrix)
    if kind == "dense" or (kind == "static"
                           and cfg.mass_matrix.cov is not None):
        return "the fused kernel supports identity/diagonal mass only"
    cd = model.density()
    try:
        em = emit_cuda.emit(cd)
    except emit_cuda.UnsupportedNode as e:
        return str(e)
    if em.row_width and not em.tile_rows:
        return (f"a row of the model's columns is {em.row_width} floats, "
                "too wide for the fused kernel's shared-memory tile")
    return workspace_check(em, n_chains,
                           global_config.resolve_device(device))


def _verify_split(cd, cols, tile_rows) -> bool:
    """Check numerically that logp(qb, cols) == base(qb) + Σ over each row
    space's tiles of its rows, with `tile_rows` rows a tile (an int, or
    one per row space, as the kernel tiles them), the identity the fused
    kernel relies on (rainier_tpu/sampler/driver.py:622-648)."""
    base_fn, rows_fn = cd.logp_rows_fn()
    gen = torch.Generator(device="cpu").manual_seed(0)
    qb = torch.randn((cd.n_vars, 8), generator=gen) * 0.5
    qb = qb.to(cols[0].device)
    got = base_fn(qb, cols).double() + rows_fn(qb, cols, tile_rows)
    ref = cd.logp_lanes_fn()(qb, cols).double()
    scale = 1.0 + float(ref.abs().max())
    return bool(torch.isfinite(got).all()) and bool(torch.allclose(
        got, ref, rtol=1e-4, atol=1e-4 * scale))


def _fused_sample(model, cfg: C.SamplerConfig, n_chains, seed, collect_idx,
                  device, cols, dtype=None):
    """kernel='fused' path: scan-path warmup (full adaptation semantics),
    then the sampling phase as ONE fused kernel (ops/fused_hmc.py) — the
    counterpart of the JAX package's _pallas_sample (driver.py:651-788).

    Each chain samples with its own adapted ε and Σ̂ diagonal; with
    cfg.pooled_adaptation the product is pooled (geometric-mean step,
    mean variance) as warmup pooled it.  Energy/E-BFMI telemetry is not
    carried (acceptance and divergence counts are).  `cols` are the
    model's columns on the device (``column_values``) in float32, which
    the kernel reads, and warmup too where `dtype` (warmup's) is float32:
    float64 warmup resolves lp where its f32 rounding moves it more than
    the posterior does (a sum of 10⁵ rows whose terms reach 10⁷ in all,
    PERF.md §4), and hands the kernel its state in float32."""
    from ..ops.fused_hmc import build, fused_hmc, lanes_per_chain

    dev = global_config.resolve_device(device)
    dtype = dtype or torch.float32
    timings: dict = {}
    t_build = _time.perf_counter()
    cd = model.density()
    lpg_raw = cd.batched_logp_and_grad_fn()
    warm_cols = cols if dtype == torch.float32 else cd.column_values(
        dtype, dev)

    def lpg(q):
        return lpg_raw(q, warm_cols)

    gen = torch.Generator(device=dev).manual_seed(seed)
    timings["build_s"] = _time.perf_counter() - t_build
    # the kernel is emitted and compiled (or found in the build cache)
    # before anything is timed as sampling
    timings["compile_s"] = 0.0
    if dev.type == "cuda":
        _, timings["compile_s"], _ = build(
            cd, lanes_per_chain(emit_cuda.emit(cd), n_chains))

    t0 = _time.perf_counter()
    wp = run_warmup(lpg, cd.n_vars, cfg, n_chains, gen, dtype, dev)
    _sync(dev)
    timings["warmup_s"] = _time.perf_counter() - t0

    if cfg.pooled_adaptation:
        eps = torch.exp(torch.log(wp.step_size).mean()).expand(n_chains)
        imd = None if wp.mass.diag is None else wp.mass.diag.mean(0)
    else:
        eps, imd = wp.step_size, wp.mass.diag
    # the kernel's state is f32
    eps = eps.float()
    imd = None if imd is None else imd.float()
    thin = max(cfg.thin, 1)
    q0 = wp.chain.q.T.float().contiguous()       # (n_vars, n_chains)

    t_kernel = _time.perf_counter()
    qf, samples, acc, div = fused_hmc(
        cd, q0, step_size=eps, n_steps=cfg.sampler.n_steps,
        n_iterations=cfg.iterations, seed=seed + 1, inv_mass_diag=imd,
        collect_every=thin, collect_idx=collect_idx, columns=cols)
    _sync(dev)
    timings["sample_s"] = _time.perf_counter() - t_kernel
    walltime = _time.perf_counter() - t0

    # (n_out, n_collect, n_chains) -> per-chain (n_chains, n_out, n_collect)
    chains = samples.permute(2, 0, 1)
    n_grads = cfg.iterations * cfg.sampler.n_steps + 1
    z = torch.zeros(n_chains, dtype=torch.float32, device=dev)
    full = torch.full((n_chains,), cfg.iterations, dtype=torch.int32,
                      device=dev)
    sstats = StatsState(
        iterations=full, divergences=div.to(torch.int32),
        accept_sum=acc * cfg.iterations,
        grad_evals=torch.full_like(full, n_grads),
        prev_energy=z, energy_trans2=z, e_count=z, e_mean=z, e_raw=z)
    result = ChainResult(samples=chains, mass=wp.mass,
                         step_size=wp.step_size,
                         warmup_stats=wp.warmup_stats, stats=sstats,
                         final_q=qf.T)
    return _finish(model, cd, result, cfg, collect_idx, walltime, timings)

