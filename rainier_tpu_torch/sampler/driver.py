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
covariance of dense mass) over the chain dimension, and over every rank
of a mesh's ``chains`` axis.

With a ``mesh`` (rainier_tpu_torch.parallel.make_mesh) each rank of the
``chains`` axis runs its block of the chains, with a generator seeded
from (seed, its block), and each rank of the ``data`` axis sums its
block of the rows (parallel/data.py); the ranks of one data group draw
the same numbers and hold the same bits.  The Trace gathers every chain
on every rank.

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
from ..parallel import mesh as M
from ..parallel.data import ShardedDensity
from . import config as C
from . import samplers
from .dualavg import (current_step_size, dual_avg_init, dual_avg_reset,
                      dual_avg_update, final_step_size,
                      find_reasonable_step_size)
from .leapfrog import ChainState, try_stepping
from .mass import (MassState, dense_mass, diag_mass, identity_mass,
                   kinetic, mass_from_welford, welford_init, welford_update,
                   window_masks)
from .progress import Progress
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


class Warmup:
    """Initialization, step-size search, and the windowed adaptation of
    step size and mass (the JAX package's build_warmup_pieces), as a loop
    that can stop and resume: :meth:`advance` runs the next iterations of
    the schedule, so warmup run in segments is the same computation, draw
    for draw, as warmup run at once.  The window schedule is the whole
    run's (``mass.window_masks``), indexed by the iteration, whatever the
    segments."""

    def __init__(self, lpg, n_vars: int, cfg: C.SamplerConfig,
                 n_chains: int, gen, dtype, device, mesh=None):
        self.lpg, self.cfg, self.gen, self.mesh = lpg, cfg, gen, mesh
        self.adaptive_step = isinstance(cfg.step_size, C.DualAvgStepSize)
        self.delta = cfg.step_size.delta if self.adaptive_step else 0.8
        self.kind = _mass_kind(cfg.mass_matrix)
        self.total = W = cfg.warmup_iterations
        if self.kind in ("diag", "dense"):
            self.update_mask, self.close_mask = window_masks(
                W, cfg.mass_matrix.initial_window, cfg.mass_matrix.expansion,
                cfg.mass_matrix.skip_first, cfg.mass_matrix.skip_last)
        else:
            self.update_mask = self.close_mask = np.zeros(W, dtype=bool)
        self.shape = shape = (n_chains, n_vars)
        self.dtype, self.device = dtype, device
        self.done = 0

        self.chain = init_chains(lpg, n_chains, n_vars, cfg, gen, dtype,
                                 device)
        self.mass = _initial_mass(cfg.mass_matrix, shape, dtype, device)
        p_init = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        if self.adaptive_step:
            eps0 = find_reasonable_step_size(
                lambda e: try_stepping(self.chain, p_init, e, identity_mass(),
                                       lpg),
                torch.ones(n_chains, dtype=dtype, device=device))
            self.da = dual_avg_init(eps0)
            self.static_eps = None
        else:
            self.static_eps = torch.full((n_chains,), cfg.step_size.step_size,
                                         dtype=dtype, device=device)
            self.da = dual_avg_init(self.static_eps)
        self.welford = welford_init(shape, dtype, device,
                                    self.kind == "dense")
        self.extra = samplers.init_extra(cfg.sampler, n_chains, dtype, device)
        self.stats = stats_init(self.chain.potential
                                + kinetic(self.mass, p_init))

    def step_size(self):
        """The step size the next iteration takes (C,)."""
        return current_step_size(self.da) if self.adaptive_step \
            else self.static_eps

    def advance(self, n: int) -> None:
        """Run the next `n` iterations of the schedule (fewer at its end)."""
        cfg, lpg = self.cfg, self.lpg
        n_chains = self.shape[0]
        for it in range(self.done, min(self.done + n, self.total)):
            eps = self.step_size()
            res, self.extra, n_grads = samplers.step(
                cfg.sampler, self.gen, self.chain, eps, self.mass, self.extra,
                lpg, warmup=True, mesh=self.mesh)
            if self.adaptive_step:
                la = res.log_accept
                if cfg.pooled_adaptation:
                    mean = M.chain_mean(torch.exp(la), self.mesh)
                    la = torch.log(torch.clamp(mean, min=1e-30)).expand(
                        n_chains)
                self.da = dual_avg_update(self.da, la, self.delta)
            if self.update_mask[it]:
                self.welford = welford_update(self.welford, res.state.q)
            if self.close_mask[it]:
                w = self.welford
                if cfg.pooled_adaptation:
                    # the JAX package's pmean of the whole Welford state
                    def pool(x):
                        return M.chain_mean(x, self.mesh).expand_as(x)

                    w = w._replace(
                        mean=pool(w.mean), raw=pool(w.raw),
                        cov_raw=None if w.cov_raw is None
                        else pool(w.cov_raw))
                self.mass = mass_from_welford(w, self.kind)
                if self.adaptive_step:
                    self.da = dual_avg_reset(self.da)
                self.welford = welford_init(self.shape, self.dtype,
                                            self.device, self.kind == "dense")
            self.stats = stats_update(self.stats, res.log_accept,
                                      res.divergent, res.energy, n_grads)
            self.chain = res.state
            self.done = it + 1

    def product(self) -> WarmupProduct:
        step = final_step_size(self.da) if self.adaptive_step \
            else self.static_eps
        return WarmupProduct(chain=self.chain, extra=self.extra,
                             mass=self.mass, step_size=step,
                             warmup_stats=self.stats)


def run_warmup(lpg, n_vars: int, cfg: C.SamplerConfig, n_chains: int, gen,
               dtype, device, mesh=None) -> WarmupProduct:
    """Warmup at once: :class:`Warmup` run to the end of its schedule."""
    w = Warmup(lpg, n_vars, cfg, n_chains, gen, dtype, device, mesh)
    w.advance(w.total)
    return w.product()


def run_sampling(lpg, cfg: C.SamplerConfig, wp: WarmupProduct, gen,
                 collect_idx=None, segment: Optional[int] = None,
                 refresh=None, mesh=None):
    """Scan-path sampling phase: one collected draw per `cfg.thin`
    transitions, exactly ``cfg.iterations // thin`` draws.  With
    `segment`, ``refresh(draws so far, stats)`` is called after every
    `segment` draws and at the end.  Returns (samples (C, n_out, k),
    stats, final q)."""
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
                warmup=False, mesh=mesh)
            stats = stats_update(stats, res.log_accept, res.divergent,
                                 res.energy, n_grads)
            chain = res.state
        samples[:, o] = chain.q if cidx is None else chain.q[:, cidx]
        if refresh is not None and ((o + 1) % segment == 0
                                    or o + 1 == n_out):
            refresh(o + 1, stats)
    return samples, stats, chain.q


def _scan_sample(lpg, n_vars, cfg, n_chains, gen, dtype, dev, collect_idx,
                 progress, chunk_iters, timings, mesh=None) -> ChainResult:
    """The scan path: warmup, then sampling.  With a `progress` or
    `chunk_iters` both run in segments of `chunk_iters` iterations with
    a host sync and a refresh after each (the JAX package's
    _chunked_sample, driver.py:791-887; without `chunk_iters` warmup is
    one segment and sampling about 20).  Unlike the JAX package, which
    runs whole chunks and slices off the overshoot (so its sampling stats
    count transitions it throws away), sampling stops at exactly
    ``cfg.iterations // thin`` draws (ROADMAP C2.6), so a segmented run
    is the run at once, draw for draw.  On a mesh, progress reads every
    chain (gathered over ``chains`` at each refresh)."""
    segmented = progress is not None or chunk_iters is not None
    progress = progress or Progress()
    progress.start(n_chains * M.axis_size(mesh, M.CHAINS))

    def every(x):
        return x if not segmented else _gather_chains(x, mesh)

    t_warm = _time.perf_counter()
    w = Warmup(lpg, n_vars, cfg, n_chains, gen, dtype, dev, mesh)
    W = w.total
    while w.done < W:
        w.advance(min(chunk_iters or W, W))
        if segmented:
            _sync(dev)
            progress.refresh("warmup", w.done, W, every(w.stats),
                             every(w.step_size()))
    wp = w.product()
    _sync(dev)
    timings["warmup_s"] = _time.perf_counter() - t_warm
    progress.refresh("warmup complete", W, W, every(wp.warmup_stats),
                     every(wp.step_size))

    thin = max(cfg.thin, 1)
    n_out = cfg.iterations // thin
    if chunk_iters:
        chunk = max(chunk_iters // thin, 1)
    else:
        chunk = max(n_out // min(20, max(n_out, 1)), 1)

    def refresh(done, stats):
        _sync(dev)
        progress.refresh("sampling", done * thin, cfg.iterations,
                         every(stats), every(wp.step_size))

    t_sample = _time.perf_counter()
    samples, sstats, final_q = run_sampling(
        lpg, cfg, wp, gen, collect_idx, chunk, refresh if segmented else None,
        mesh)
    _sync(dev)
    timings["sample_s"] = _time.perf_counter() - t_sample
    progress.finish("complete", every(sstats), every(wp.step_size))
    return ChainResult(samples=samples, mass=wp.mass, step_size=wp.step_size,
                       warmup_stats=wp.warmup_stats, stats=sstats,
                       final_q=final_q)


def sample(model, cfg: C.SamplerConfig, n_chains: int = 4, seed: int = 0,
           collect_idx=None, dtype=None, device=None, mesh=None,
           progress=None, kernel: str = "scan",
           chunk_iters: Optional[int] = None, sync_compile: bool = False):
    """Run inference on `model`; returns a Trace.

    `device`: where the run happens — the process default
    (rainier_tpu_torch.config.device(), "cuda") unless given.
    `kernel`: 'scan' (default) runs every transition as batched PyTorch
    ops; 'fused' runs scan-path warmup, then the whole sampling phase as
    one fused CUDA kernel (ops/fused_hmc.py; its plain PyTorch version
    on the CPU).  Outside the kernel's envelope (non-HMC samplers, dense
    mass, a mesh, `chunk_iters`, nodes the CUDA emitter does not cover
    such as a Gather by a float index, a density without a
    clean base/row split, a kernel workspace larger than the device's
    free memory) 'fused' warns and runs the scan path; 'fused!' raises,
    for callers who need the kernel or nothing.  `collect_idx` (an index
    array into the parameters) keeps only those coordinates of each
    draw, on either path; a kernel with its state in the workspace
    stores only them.
    `dtype` is the sampler's (default ``config.dtype()``); on the fused
    path it is warmup's (default float32), and the kernel's state is
    float32 whatever it is.
    `progress`: a sampler.progress.Progress.  On the scan path it runs
    warmup and sampling in segments with a refresh after each; on the
    fused path it reports after warmup and after the kernel.
    `chunk_iters`: iterations a segment on the scan path (a host sync
    after each).
    `sync_compile`: build the fused kernel and run a throwaway launch
    before anything is timed, as `compile_sync_s`; on the scan path,
    which compiles nothing, `compile_sync_s` is 0.0.
    `mesh`: a (chains, data) DeviceMesh (parallel.make_mesh) that every
    rank passes: rank group g of C/c chain groups runs chains
    [g·C/c, (g+1)·C/c), each data rank sums its block of the rows, and the
    returned Trace holds every chain on every rank.  Scan path only.
    """
    if kernel in ("fused", "fused!"):
        reason = _fused_unsupported_reason(model, cfg, n_chains, mesh,
                                           device)
        if reason is None and chunk_iters is not None:
            reason = ("the fused kernel runs the whole sampling phase as "
                      "one device program; chunk_iters needs the scan "
                      "path")
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
                                 device, cols, dtype, progress, sync_compile)
        if kernel == "fused!":
            raise ValueError(f"kernel='fused!': {reason}")
        warnings.warn(f"kernel='fused' falling back to the scan path: "
                      f"{reason}", stacklevel=2)
        kernel = "scan"
    if kernel != "scan":
        raise ValueError(f"unknown kernel {kernel!r} "
                         "(expected 'scan', 'fused' or 'fused!')")
    if mesh is not None:
        M.check_mesh(mesh)
        groups = M.axis_size(mesh, M.CHAINS)
        if n_chains % groups:
            raise ValueError(f"{n_chains} chains do not split over "
                             f"{groups} chain shards")
    lo, hi = M.chain_sharding(mesh).block(n_chains)
    dev = global_config.resolve_device(device)
    dtype = dtype or global_config.dtype()
    timings: dict = {}
    t_build = _time.perf_counter()
    cd = model.density()
    lpg = ShardedDensity(cd, mesh, M.DATA, dtype, dev).lpg
    gen = torch.Generator(device=dev).manual_seed(
        M.group_seed(seed, M.axis_rank(mesh, M.CHAINS)))
    timings["build_s"] = _time.perf_counter() - t_build
    # eager PyTorch: nothing is compiled on this path
    timings["compile_s"] = 0.0
    if sync_compile:
        timings["compile_sync_s"] = 0.0

    t0 = _time.perf_counter()
    result = _scan_sample(lpg, cd.n_vars, cfg, hi - lo, gen, dtype, dev,
                          collect_idx, progress, chunk_iters, timings, mesh)
    result = _gather_chains(result, mesh)
    walltime = _time.perf_counter() - t0
    return _finish(model, cd, result, cfg, collect_idx, walltime, timings)


def _gather_chains(x, mesh):
    """A tensor of this rank's chains (or a NamedTuple of them) as every
    chain of the mesh, in order."""
    if x is None or M.axis_size(mesh, M.CHAINS) == 1:
        return x
    if isinstance(x, tuple):
        return type(x)(*[_gather_chains(v, mesh) for v in x])
    return M.all_gather(x, mesh, M.CHAINS)


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
                  device, cols, dtype=None, progress=None,
                  sync_compile=False):
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
    PERF.md §4), and hands the kernel its state in float32.

    `progress` starts before warmup, refreshes once after it and
    finishes after the kernel, as the JAX package's _pallas_sample does
    (driver.py:684-695, 777-778).  `sync_compile` runs one throwaway
    launch of the kernel (one iteration from the origin) before warmup,
    timed as `compile_sync_s`."""
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
    if sync_compile:
        t_sync = _time.perf_counter()
        fused_hmc(cd, torch.zeros((cd.n_vars, n_chains), device=dev),
                  step_size=torch.full((n_chains,), 1e-3, device=dev),
                  n_steps=1, n_iterations=1, seed=seed, collect_every=0,
                  columns=cols)
        _sync(dev)
        timings["compile_sync_s"] = _time.perf_counter() - t_sync

    t0 = _time.perf_counter()
    if progress is not None:
        progress.start(n_chains)
    wp = run_warmup(lpg, cd.n_vars, cfg, n_chains, gen, dtype, dev)
    _sync(dev)
    timings["warmup_s"] = _time.perf_counter() - t0
    if progress is not None:
        progress.refresh("warmup complete", cfg.warmup_iterations,
                         cfg.warmup_iterations, wp.warmup_stats,
                         wp.step_size)

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
    if progress is not None:
        progress.finish("complete", sstats, wp.step_size)
    result = ChainResult(samples=chains, mass=wp.mass,
                         step_size=wp.step_size,
                         warmup_stats=wp.warmup_stats, stats=sstats,
                         final_q=qf.T)
    return _finish(model, cd, result, cfg, collect_idx, walltime, timings)

