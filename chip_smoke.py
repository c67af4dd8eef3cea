#!/usr/bin/env python3
"""On-card smoke test of rainier_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the fused HMC kernel from the checkout's sources, holds the
kernel against its plain PyTorch version, drives the port's main path
(``Model.sample(kernel="fused!")`` on the model-built Neal's funnel at
1024 chains, 1000 warmup + 1000 draws), checks the posterior, and times
the kernel.  Every phase prints one line; any failure raises and exits
nonzero.  The line before the last is a JSON object with each kernel's
launches, error against the plain version, times and bound; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA card it exits
nonzero and prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks at the full 700 W limit (NVIDIA data sheet): f32 outside
# the tensor cores, and device memory bandwidth
PEAK_F32_OPS = 67e12
PEAK_HBM_BYTES = 3.35e12

N_WARMUP, N_DRAWS, MAIN_CHAINS, N_STEPS = 1000, 1000, 1024, 5
THROUGHPUT_CHAINS, THROUGHPUT_ITERS, THROUGHPUT_EPS = 524288, 500, 0.18
PARITY_CHAINS, PARITY_ITERS = 1000, 200
REL_TOL = 1e-4   # |kernel - plain| <= REL_TOL * max(1, |plain|), per chain
DEVICE = "cuda"


def funnel(rt):
    """Neal's funnel, 10 dims, built through the model API
    (__graft_entry__.py:9-14)."""
    y = rt.Normal(0.0, 3.0).latent()
    xv = rt.Normal(0.0, (y / 2).exp()).latent_vec(9)
    return rt.Model.track_({y} | set(xv.to_list())), y


def check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def timed(fn, device, reps: int = 1, warm: bool = True):
    """(result of the last call, mean ms per call): CUDA events on the
    card, the host clock elsewhere."""
    import torch

    if device.type == "cuda":
        if warm:
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return out, (time.perf_counter() - t0) * 1e3 / reps


def agreement(a, b):
    """(fraction of chains whose final q agrees, max |Δq|, mean |Δacc|,
    equal divergences) between kernel output a and plain output b."""
    rel = ((a[0] - b[0]).abs() / b[0].abs().clamp(min=1.0)).amax(dim=0)
    return (float((rel <= REL_TOL).float().mean()),
            float((a[0] - b[0]).abs().max()),
            float((a[2] - b[2]).abs().mean()),
            bool((a[3] == b[3]).all()))


def parity_phase(F, cd, device, n_chains, n_iters, explicit_noise: bool):
    """Kernel vs plain version on one input: per-chain ε and Σ̂, a ragged
    chain count, every draw collected."""
    import torch

    rng = np.random.default_rng(1 if explicit_noise else 2)
    dim = cd.n_vars

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    q0 = t(rng.normal(size=(dim, n_chains)))
    kw = dict(step_size=t(rng.uniform(0.3, 0.9, n_chains)),
              n_steps=N_STEPS, n_iterations=n_iters, seed=11,
              inv_mass_diag=t(rng.uniform(0.5, 2.0, (n_chains, dim))),
              collect_every=1)
    if explicit_noise:
        kw["noise"] = (t(rng.normal(size=(n_iters, dim, n_chains))),
                       t(rng.uniform(1.1920929e-7, 1.0, (n_iters, n_chains))))
    a = F.fused_hmc(cd, q0, **kw)
    b = F.fused_hmc_reference(cd, q0, **kw)
    frac, max_err, dacc, div_eq = agreement(a, b)
    mode = "explicit noise" if explicit_noise else "on-device Philox"
    print(f"phase kernel-vs-plain ({mode}): {n_chains} chains x {n_iters} "
          f"it: {frac:.4f} of chains within {REL_TOL} rel, max |dq| "
          f"{max_err:.3g}, mean |d accept| {dacc:.3g}, divergences equal "
          f"{div_eq}", flush=True)
    check(frac >= 0.99 and dacc < 0.01 and div_eq, (frac, dacc, div_eq))


def kernel_bound_ms(em_ops, dim, n_chains, n_iters, n_steps, collect_every,
                    F):
    """Least time the card could take for one fused_hmc call: the larger
    of its bytes over the memory rate and its operations over the f32
    rate (Philox integer operations counted at the f32 rate)."""
    ops = n_chains * n_iters * F.op_count(em_ops, dim, n_steps)
    n_out = n_iters // collect_every if collect_every else 0
    # q0, ε, Σ̂ read; final q, accept, divergences, draws written
    nbytes = 4 * (n_chains * (dim + 1 + dim) + n_chains * (dim + 2)
                  + n_out * dim * n_chains)
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.ops import fused_hmc as F
    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    device = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"phase card: {name} ({torch.cuda.device_count()} visible), "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- build ------------------------------------------------------------
    model, y = funnel(rt)
    cd = model.density()
    _, build_s, em = F.build(cd)
    print(f"phase build: fused_hmc for the funnel ({cd.n_vars} dims, "
          f"{em.ops} ops per logp+grad) in {build_s:.2f} s", flush=True)

    # -- kernel vs plain, both RNG modes ------------------------------------
    parity_phase(F, cd, device, PARITY_CHAINS, PARITY_ITERS, True)
    parity_phase(F, cd, device, PARITY_CHAINS, PARITY_ITERS, False)

    # -- main path --------------------------------------------------------
    cfg = SamplerConfig(N_WARMUP, N_DRAWS, sampler=HMC(N_STEPS))
    F.fused_hmc.launches = 0
    tr = model.sample(cfg, n_chains=MAIN_CHAINS, seed=0, kernel="fused!",
                      device=device)
    launches = F.fused_hmc.launches
    ys = tr.evaluate(y)
    mean_y, var_y = float(np.mean(ys)), float(np.var(ys))
    rhat = max(d.r_hat for d in tr.diagnostics(rank_normalized=True))
    print(f"phase main path: Model.sample(kernel='fused!') {MAIN_CHAINS} "
          f"chains x ({N_WARMUP} warmup + {N_DRAWS} draws), HMC({N_STEPS}): "
          f"fused_hmc launches {launches}, mean(y) {mean_y:.4f}, var(y) "
          f"{var_y:.4f}, rank-r_hat max {rhat:.5f}, accept "
          f"{float(np.mean(tr.accept_rate())):.3f}, divergences "
          f"{tr.divergences()}, timings {tr.timings}", flush=True)
    check(launches >= 1, f"fused_hmc launches {launches}")
    check(np.all(np.isfinite(tr.chains)) and tr.chains.shape == (
        MAIN_CHAINS, N_DRAWS, cd.n_vars), tr.chains.shape)
    check(abs(mean_y) < 0.3 and abs(var_y / 9.0 - 1.0) < 0.15,
          (mean_y, var_y))
    check(rhat < 1.01, rhat)

    # the kernel at the main path's shapes, on the warmup product's scale
    # of inputs: per-chain ε and Σ̂, every draw collected
    q0 = torch.as_tensor(tr.chains[:, -1, :].T.copy(), device=device)
    main_kw = dict(step_size=torch.as_tensor(tr.step_size, device=device),
                   n_steps=N_STEPS, n_iterations=N_DRAWS, seed=1,
                   inv_mass_diag=torch.as_tensor(tr.mass.diag,
                                                 device=device),
                   collect_every=1)
    ker, ker_ms = timed(lambda: F.fused_hmc(cd, q0, **main_kw), device, 3)
    plain, plain_ms = timed(
        lambda: F.fused_hmc_reference(cd, q0, **main_kw), device, 1, False)
    frac, max_err, dacc, div_eq = agreement(ker, plain)
    bound_ms, bound_by = kernel_bound_ms(em.ops, cd.n_vars, MAIN_CHAINS,
                                         N_DRAWS, N_STEPS, 1, F)
    print(f"phase kernel at main-path shapes ({MAIN_CHAINS} chains x "
          f"{N_DRAWS} it x {N_STEPS} steps, draws collected): kernel "
          f"{ker_ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.4f} "
          f"ms ({bound_by}), {frac:.4f} of chains agree, max |dq| "
          f"{max_err:.3g}", flush=True)
    check(frac >= 0.99 and dacc < 0.01 and div_eq, (frac, dacc, div_eq))

    # -- throughput: bench.py's configuration on the model-built funnel ----
    qz = torch.zeros((cd.n_vars, THROUGHPUT_CHAINS), device=device)
    tp_kw = dict(step_size=THROUGHPUT_EPS, n_steps=N_STEPS, seed=0,
                 collect_every=0)
    _, tp_ms = timed(lambda: F.fused_hmc(
        cd, qz, n_iterations=THROUGHPUT_ITERS, **tp_kw), device, 3)
    _, tp_plain_ms = timed(lambda: F.fused_hmc_reference(
        cd, qz, n_iterations=50, **tp_kw), device, 1, False)
    evals = THROUGHPUT_CHAINS * THROUGHPUT_ITERS * N_STEPS
    tp_bound_ms, tp_bound_by = kernel_bound_ms(
        em.ops, cd.n_vars, THROUGHPUT_CHAINS, THROUGHPUT_ITERS, N_STEPS, 0, F)
    print(f"phase throughput: {THROUGHPUT_CHAINS} chains x "
          f"{THROUGHPUT_ITERS} it x {N_STEPS} steps, eps {THROUGHPUT_EPS}: "
          f"kernel {tp_ms:.3f} ms = {evals / tp_ms * 1e3:.4g} grad evals/s "
          f"(bound {tp_bound_ms:.3f} ms, {tp_bound_by}); plain version "
          f"{tp_plain_ms * THROUGHPUT_ITERS / 50:.1f} ms (50 it timed, "
          f"scaled) on {smi}", flush=True)

    print(json.dumps({"kernels": [{
        "name": "fused_hmc", "route": "cuda",
        "source": "rainier_tpu_torch/csrc/fused_hmc.cu",
        "replaces": "rainier_tpu/ops/hmc_pallas.py:506",
        "launches": launches, "max_abs_err": max_err, "ms": ker_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
