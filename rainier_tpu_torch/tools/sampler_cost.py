#!/usr/bin/env python3
"""What the samplers outside the fused kernel cost on a CUDA card: NUTS,
EHMC and dense mass, which run as batched eager PyTorch (the scan path).

Run from the root of a checkout on a machine with a CUDA card:

    python3 rainier_tpu_torch/tools/sampler_cost.py [WARMUP DRAWS]
    python3 rainier_tpu_torch/tools/sampler_cost.py density LABEL
    python3 rainier_tpu_torch/tools/sampler_cost.py rhat WARMUP DRAWS SEED [cpu]

At 1024 chains, on ``chip_smoke.py``'s models: eight schools with
NUTS(max_depth=8) and dense mass, and the funnel under the default
config, EHMC(1024) synchronized (WARMUP and DRAWS default to 100 each).
For warmup and sampling apart it prints the lockstep steps (NUTS:
leaves) and host syncs an iteration, and ms a step and an iteration;
then one density-and-gradient call at 1024 chains by CUDA events, which
splits a step into the density and the sampler's own work; then the
device's busy share over 5 sampling iterations, from ``torch.profiler``;
last, what one host sync (``bool(mask.any())``, the loops' check) adds
to a small launch, over 1000 of each.

``density``: one density-and-gradient call of eight schools at 1024
chains (CUDA events over 100 calls), on the ``rainier_tpu_torch`` that
the import finds: put another checkout's root on PYTHONPATH to time that
one, in turns with this one's.  Prints one line tagged LABEL.

``rhat``: eight schools through ``Model.sample`` with NUTS(max_depth=8)
and dense mass at 1024 chains, WARMUP + DRAWS from SEED, on the card or
on the CPU; prints rank-r̂ of mu, tau and theta_1 over the first 300,
400, 500, 750 and 1000 draws (those the run has): how ``chip_smoke.py``'s
bar depends on the chains' length.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
# rainier_tpu_torch from this checkout unless PYTHONPATH names another;
# the models always from this checkout's chip_smoke.py
sys.path.append(str(ROOT))
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

CHAINS = 1024


def _secs(fn, device):
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def _line(label, what, counts, secs, n_iters):
    steps = max(counts.steps, 1)
    print(f"RESULT {label}, {what}: {n_iters} iterations in {secs:.3f} s, "
          f"{counts.steps / n_iters:.2f} lockstep steps an iteration, "
          f"{counts.syncs / n_iters:.2f} host syncs an iteration, "
          f"{secs / n_iters * 1e3:.3f} ms an iteration, "
          f"{secs / steps * 1e3:.4f} ms a step", flush=True)


def _device_share(fn):
    """Device kernel time over wall time of `fn`, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    busy_us = sum(getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0) for e in kernels)
    return busy_us * 1e-6, wall, sum(e.count for e in kernels)


def _density_ms(lpg, q, n=100):
    for _ in range(3):
        lpg(q)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        lpg(q)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _sync_us(device, n=1000):
    """(µs a launch of ``mask.any()`` read to the host, µs without the
    read), each the mean of n on an idle card."""
    mask = torch.zeros(CHAINS, dtype=torch.bool, device=device)
    out = []
    for read in (True, False):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(n):
            m = mask.any()
            if read:
                bool(m)
        torch.cuda.synchronize(device)
        out.append((time.perf_counter() - t0) / n * 1e6)
    return out


def run(label, model, cfg, device):
    from rainier_tpu_torch.sampler.driver import run_sampling, run_warmup
    from rainier_tpu_torch.sampler.stats import COUNTS

    cd = model.density()
    cols = cd.column_values(torch.float32, device)
    raw = cd.batched_logp_and_grad_fn()

    def lpg(q):
        return raw(q, cols)

    gen = torch.Generator(device=device).manual_seed(0)
    COUNTS.reset()
    wp, secs = _secs(lambda: run_warmup(lpg, cd.n_vars, cfg, CHAINS, gen,
                                        torch.float32, device), device)
    _line(label, "warmup", COUNTS, secs, cfg.warmup_iterations)
    COUNTS.reset()
    _, secs = _secs(lambda: run_sampling(lpg, cfg, wp, gen), device)
    _line(label, "sampling", COUNTS, secs, cfg.iterations)
    if isinstance(COUNTS.depths, torch.Tensor):
        print(f"RESULT {label}, sampling: tree depths (histogram over "
              f"chains and iterations) {COUNTS.depths.tolist()}", flush=True)

    print(f"RESULT {label}: one density-and-gradient call at {CHAINS} "
          f"chains {_density_ms(lpg, wp.chain.q):.4f} ms (CUDA events, 100 "
          f"calls)", flush=True)

    short = dataclasses.replace(cfg, iterations=5)
    busy, wall, n_kernels = _device_share(
        lambda: run_sampling(lpg, short, wp, gen))
    print(f"RESULT {label}: 5 sampling iterations under torch.profiler, "
          f"device busy {busy * 1e3:.3f} ms of {wall * 1e3:.3f} ms wall "
          f"({busy / wall:.4f}), {n_kernels} kernels", flush=True)


def rhat_by_draws(warmup, draws, seed, device):
    import numpy as np

    import rainier_tpu_torch as rt
    from rainier_tpu_torch.sampler import (NUTS, DenseMassMatrixTuner,
                                           SamplerConfig)

    model, *exprs = cs.eight_schools(rt)
    cfg = SamplerConfig(warmup, draws, sampler=NUTS(max_depth=cs.NUTS_DEPTH),
                        mass_matrix=DenseMassMatrixTuner())
    tr = model.sample(cfg, n_chains=CHAINS, seed=seed, device=device)
    got = np.stack([tr.evaluate(e).reshape(CHAINS, draws) for e in exprs],
                   axis=-1)
    for k in (300, 400, 500, 750, 1000):
        if k <= draws:
            r = [round(cs.rank_rhat(got[:, :k, j:j + 1], device), 5)
                 for j in range(3)]
            print(f"RESULT rhat {warmup} + {draws}, seed {seed}, {device}: "
                  f"rank-r_hat of (mu, tau, theta_1) over the first {k} "
                  f"draws {r}", flush=True)


def main(argv) -> int:
    if argv[:1] == ["rhat"]:
        rhat_by_draws(*(int(a) for a in argv[1:4]),
                      torch.device(argv[4] if len(argv) > 4 else "cuda"))
        return 0
    if not torch.cuda.is_available():
        print("sampler_cost: no CUDA device", file=sys.stderr)
        return 2
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.sampler import (NUTS, DenseMassMatrixTuner,
                                           SamplerConfig)

    device = torch.device("cuda")
    if argv[:1] == ["density"]:
        cd = cs.eight_schools(rt)[0].density()
        cols = cd.column_values(torch.float32, device)
        raw = cd.batched_logp_and_grad_fn()
        q = torch.randn((CHAINS, cd.n_vars), device=device)
        print(f"RESULT density {argv[1]}: eight schools, one "
              f"density-and-gradient call at {CHAINS} chains "
              f"{_density_ms(lambda x: raw(x, cols), q):.4f} ms "
              f"({rt.__file__})", flush=True)
        return 0
    warmup, draws = (int(a) for a in argv) if argv else (100, 100)
    print(f"card: {cs.nvidia_smi()}", flush=True)
    model = cs.eight_schools(rt)[0]
    run("eight schools, NUTS(8), dense mass", model,
        SamplerConfig(warmup, draws, sampler=NUTS(max_depth=cs.NUTS_DEPTH),
                      mass_matrix=DenseMassMatrixTuner()), device)
    run("funnel, EHMC(1024)", cs.funnel(rt)[0],
        SamplerConfig(warmup, draws), device)
    with_read, without = _sync_us(device)
    print(f"RESULT host sync: mask.any() then bool() {with_read:.2f} us, "
          f"mask.any() alone {without:.2f} us (1000 each)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
