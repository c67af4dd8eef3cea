#!/usr/bin/env python3
"""Timing comparisons on a CUDA card for choices of the fused kernel.

Run from the root of a checkout on a machine with a CUDA card:

    python3 rainier_tpu_torch/tools/kernel_ab.py row-sums
    python3 rainier_tpu_torch/tools/kernel_ab.py plain LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py stream
    python3 rainier_tpu_torch/tools/kernel_ab.py tiles LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py lanes
    python3 rainier_tpu_torch/tools/kernel_ab.py layouts
    python3 rainier_tpu_torch/tools/kernel_ab.py adapt

``row-sums``: the kernels of the README regression, the 100k-row
logistic regression and GLMMPoisson2 (``chip_smoke.py``'s models), whose
state stays in the thread, built from ``csrc/`` as it stands (their rows
summed in f32 per tile, lp rounded twice) and from a copy that sums
their rows in f64 and rounds lp once, as a workspace model does; each
timed at 1024 chains from a short warmup's states, in the order A B B A.
Prints one line per model and order.

``plain``: the plain PyTorch versions (``fused_hmc_reference``) of the
funnel, the README regression and GLMMPoisson2 at 1024 chains and at 8,
100 iterations each, on the ``rainier_tpu_torch`` and ``chip_smoke``
that the import finds: put another checkout's root on PYTHONPATH to time
that one.  Prints one line tagged LABEL with the host's CPU count and
load.  A plain version whose time does not fall with the chain count is
bound by the host issuing its launches, not by the card.

``stream``: the kernel with its column tiles streamed through two
shared-memory slots (``stream_columns=True``) against synchronous tiles
(False), in the order A B B A, on ``row-sums``' three models (the 100k
logistic's 4.4 MB of columns sit inside the card's L2) and on the
2M-row logistic regression (512 chains, 5 iterations of HMC(8), 88 MB,
past it, from points around its Laplace mode).  Prints one line per
model and order, with the results' equality.

``tiles``: the kernels of every model with rows that ``chip_smoke.py``
drives (``row-sums``' three, the MVNormal logistic, the logistic in two
row spaces, glmm_large, and the 2M-row logistic at 512 chains × 5
iterations of HMC(8), which streams), each as its launch decides, built
from the ``rainier_tpu_torch`` that the import finds, as ``plain`` does:
run it with another checkout's root on PYTHONPATH and with this one's,
in turns, to compare two trees.  Prints one line per model tagged LABEL.

``lanes``: the same kernels of this checkout at W = 2, 4 and 8 chains a
block (the wrapper's rule ``fused_hmc.chains_per_block`` replaced for
the run, as ``row-sums`` patches a copy of ``csrc/``), in the order 2 4 8
8 4 2.  Prints one line per model and W.

``layouts``: GLMMPoisson2 (146 parameters) with its chain state in the
workspace, each pass split over a chain's lanes (its layout, past
``emit_cuda.LANE_STATE_MAX``), and in per-thread arrays that every lane
holds (``LANE_STATE_MAX`` raised for its emission), at CHAINS chains ×
500 iterations, in the order A B B A.  Prints one line per layout and
order.

``adapt``: the MVNormal logistic of ``chip_smoke.py`` (the 100k
logistic's data under an AR(1) ``MVNormal`` prior) at 1024 chains × (1000
warmup + 200 draws), sampled four ways from the same seed: the kernel
and the scan path with per-chain adaptation, the kernel with pooled
adaptation, and the kernel with HMC(10).  Prints each run's rank-r̂ per
parameter and the quantiles of its per-chain step sizes and accept
rates: which chains, and which parameters, keep r̂ over 1.01.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# after PYTHONPATH, so that another checkout put there is the one timed
sys.path.append(str(Path(__file__).resolve().parents[2]))

CHAINS, FEW_CHAINS, PLAIN_ITERS = 1024, 8, 100
# the 2M-row logistic regression's stream timing: 5 iterations of HMC(8)
ROWS_2M, CHAINS_2M, ITERS_2M = 2_000_000, 512, 5
# iterations of HMC(5) that ``tiles`` and ``lanes`` time each model over
# (the 2M-row logistic: ITERS_2M of HMC(8))
TILE_ITERS = {"README regression": 1000, "logistic regression": 100,
              "MVNormal logistic": 100,
              "logistic regression, two row spaces": 100,
              "GLMMPoisson2": 500, "glmm_large": 50}
# the values of W that ``lanes`` times
LANE_W = (2, 4, 8, 8, 4, 2)

# every model's rows summed in f64 and lp rounded once
F64_ROWS = (
    ("typedef float rt_row_sum;\n", "typedef double rt_row_sum;\n"),
    ("#ifdef RT_WS_FLOATS\n  lp = (float)((double)lp + lp_acc);\n#else\n"
     "  lp += (float)lp_acc;\n#endif\n",
     "  lp = (float)((double)lp + lp_acc);\n"))


def _warm(model, n_chains, device):
    """(q0 (dim, n), ε (n,), Σ̂ (n, dim)) after 300 scan-path warmup
    iterations."""
    import torch

    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    tr = model.sample(SamplerConfig(300, 1, sampler=HMC(5)),
                      n_chains=n_chains, seed=0, kernel="scan",
                      device=device)
    return (torch.as_tensor(tr.chains[:, -1, :].T.copy(), device=device),
            torch.as_tensor(tr.step_size, device=device),
            torch.as_tensor(tr.mass.diag, device=device))


def _laplace_start(design, ys, n, device):
    """(q0 (dim, n) around the Laplace mode of a logistic regression with
    this design, ε 0.76 for every chain, Σ̂ the Laplace variances)."""
    import torch

    import chip_smoke as cs

    w_map, cov = cs.laplace_design(design, ys)
    rng = np.random.default_rng(0)
    q0 = w_map[:, None] + np.sqrt(np.diag(cov))[:, None] * rng.normal(
        size=(w_map.size, n))
    return (torch.as_tensor(q0, dtype=torch.float32, device=device),
            torch.full((n,), 0.76, device=device),
            torch.as_tensor(np.diag(cov).copy(), dtype=torch.float32,
                            device=device))


def _register_runs(device):
    """{name: (model, (q0, ε, Σ̂), iterations, leapfrog steps)} for the
    README regression, the 100k-row logistic regression and GLMMPoisson2
    at CHAINS chains."""
    import chip_smoke as cs
    import rainier_tpu_torch as rt

    readme = cs.readme_regression(rt)[0]
    logit, x, ys = cs.logistic_regression(rt)
    glmm = cs.glmm_poisson(rt)
    return {
        "README regression": (readme, _warm(readme, CHAINS, device), 1000,
                              5),
        "logistic regression": (logit, _laplace_start(
            cs.logistic_design(x), ys, CHAINS, device), 100, 5),
        "GLMMPoisson2": (glmm, _warm(glmm, CHAINS, device), 1000, 5)}


def _row_runs(device):
    """{name: (model, (q0, ε, Σ̂), iterations, leapfrog steps)} for every
    model with rows that chip_smoke.py drives: CHAINS chains and
    TILE_ITERS iterations of HMC(5), the 2M-row logistic CHAINS_2M chains
    and ITERS_2M of HMC(8)."""
    import chip_smoke as cs
    import rainier_tpu_torch as rt

    runs = {name: (model, start, TILE_ITERS[name], 5) for name, (
        model, start, _, _) in _register_runs(device).items()}
    logit, x, ys = cs.logistic_regression(rt)
    mv, alpha, betas = cs.mvnormal_logistic(rt, x, ys)
    runs["MVNormal logistic"] = (mv, _laplace_start(
        cs.mv_design(mv.density(), x, alpha, betas), ys, CHAINS, device),
        TILE_ITERS["MVNormal logistic"], 5)
    runs["logistic regression, two row spaces"] = (
        cs.split_logistic(rt, x, ys), runs["logistic regression"][1],
        TILE_ITERS["logistic regression, two row spaces"], 5)
    large = cs.glmm_large(rt)
    runs["glmm_large"] = (large, _warm(large, CHAINS, device),
                          TILE_ITERS["glmm_large"], 5)
    logit2m, x2, ys2 = cs.logistic_regression(rt, ROWS_2M)
    runs["logistic regression 2M"] = (logit2m, _laplace_start(
        cs.logistic_design(x2), ys2, CHAINS_2M, device), ITERS_2M, 8)
    return runs


def _build_runs(runs):
    """Every run's kernel, one nvcc each, all started together."""
    from rainier_tpu_torch.ops import fused_hmc as F

    with ThreadPoolExecutor(len(runs)) as pool:
        list(pool.map(F.build, [run[0].density() for run in runs.values()]))


def _time_runs(runs, device, label, built=None):
    """Each run's kernel (warm, then timed) as its launch decides, from
    the libraries `built` ({name: build}) or the model's own build."""
    import chip_smoke as cs
    from rainier_tpu_torch.ops import fused_hmc as F

    for name, (model, (q0, eps, imd), n_it, n_steps) in runs.items():
        cd = model.density()
        kw = dict(step_size=eps, n_steps=n_steps, n_iterations=n_it,
                  seed=1, inv_mass_diag=imd, collect_every=0)
        if built is not None:
            kernels, _, em = built[name]
            F._BUILT[cd] = (kernels, em)
        out, ms = cs.timed(lambda: F.fused_hmc(cd, q0, **kw), device, 1,
                           True)
        print(f"RESULT {label} {name}: {q0.shape[1]} chains x {n_it} it x "
              f"{n_steps} steps {ms:.3f} ms, accept "
              f"{float(out[2].mean()):.4f}", flush=True)


def row_sums() -> None:
    import torch

    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device("cuda")
    runs = _register_runs(device)
    csrc = F.CSRC
    with tempfile.TemporaryDirectory() as tmp:
        variant = Path(tmp) / "csrc"
        shutil.copytree(csrc, variant)
        src = (variant / "fused_hmc.cu").read_text()
        for old, new in F64_ROWS:
            if src.count(old) != 1:
                raise RuntimeError(f"fused_hmc.cu no longer holds {old!r}")
            src = src.replace(old, new)
        (variant / "fused_hmc.cu").write_text(src)
        built = {}
        for label, path in (("f32 tiles", csrc), ("f64 rows", variant)):
            F.CSRC = path
            cds = [run[0].density() for run in runs.values()]
            for cd in cds:
                F._BUILT.pop(cd, None)
            with ThreadPoolExecutor(len(cds)) as pool:
                for name, b in zip(runs, pool.map(F.build, cds)):
                    built[label, name] = b
                    print(f"built {label}, {name}: {b[1]:.2f} s", flush=True)
        F.CSRC = csrc
    for name, run in runs.items():
        for label in ("f32 tiles", "f64 rows", "f64 rows", "f32 tiles"):
            _time_runs({name: run}, device, f"row-sums {label},",
                       {name: built[label, name]})


def tiles(label: str) -> None:
    import torch

    device = torch.device("cuda")
    runs = _row_runs(device)
    _build_runs(runs)
    _time_runs(runs, device, f"tiles {label}")


def lanes() -> None:
    import torch

    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device("cuda")
    runs = _row_runs(device)
    _build_runs(runs)
    rule = F.chains_per_block
    try:
        for name, run in runs.items():
            for w in LANE_W:
                F.chains_per_block = lambda em, n, w=w: w
                _time_runs({name: run}, device, f"lanes W={w},")
    finally:
        F.chains_per_block = rule


def layouts() -> None:
    import torch

    import chip_smoke as cs
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.compute import emit_cuda

    device = torch.device("cuda")
    models = {}
    for label, cap in (("workspace", emit_cuda.LANE_STATE_MAX),
                       ("registers", emit_cuda.LOCAL_STATE_MAX)):
        model = cs.glmm_poisson(rt)
        rule = emit_cuda.LANE_STATE_MAX
        emit_cuda.LANE_STATE_MAX = cap
        try:
            em = emit_cuda.emit(model.density())    # kept for the build
        finally:
            emit_cuda.LANE_STATE_MAX = rule
        print(f"layouts {label}: workspace {em.workspace} floats a chain",
              flush=True)
        models[label] = model
    start = _warm(models["workspace"], CHAINS, device)
    runs = {label: (model, start, TILE_ITERS["GLMMPoisson2"], 5)
            for label, model in models.items()}
    _build_runs(runs)
    for label in ("workspace", "registers", "registers", "workspace"):
        _time_runs({f"GLMMPoisson2, state in {label}": runs[label]}, device,
                   "layouts")


def plain(label: str) -> None:
    import torch

    import chip_smoke as cs
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device("cuda")
    models = {"funnel": cs.funnel(rt)[0],
              "README regression": cs.readme_regression(rt)[0],
              "GLMMPoisson2": cs.glmm_poisson(rt)}
    times = []
    for name, model in models.items():
        cd = model.density()
        for n in (CHAINS, FEW_CHAINS):
            q0 = 0.1 * torch.randn((cd.n_vars, n), device=device,
                                   generator=torch.Generator(
                                       device=device).manual_seed(0))
            _, ms = cs.timed(lambda: F.fused_hmc_reference(
                cd, q0, step_size=0.05, n_steps=5, n_iterations=PLAIN_ITERS,
                seed=1, collect_every=1), device, 1, True)
            times.append(f"{name} {n} chains {ms:.1f} ms")
    print(f"RESULT plain {label}: {PLAIN_ITERS} it x 5 steps: "
          + ", ".join(times) + f"; torch {torch.__version__}, "
          f"{rt.__file__}, {os.cpu_count()} CPUs, load {os.getloadavg()}, "
          f"torch threads {torch.get_num_threads()}", flush=True)


def stream() -> None:
    import torch

    import chip_smoke as cs
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device("cuda")
    runs = {name: (model.density(), q0, dict(
        step_size=eps, n_steps=n_steps, n_iterations=n_it, seed=1,
        inv_mass_diag=imd, collect_every=1))
        for name, (model, (q0, eps, imd), n_it, n_steps)
        in _register_runs(device).items()}
    model, x, ys = cs.logistic_regression(rt, ROWS_2M)
    q0, eps, imd = _laplace_start(cs.logistic_design(x), ys, CHAINS_2M,
                                  device)
    runs["logistic regression 2M"] = (model.density(), q0, dict(
        step_size=eps, n_steps=8, n_iterations=ITERS_2M, seed=1,
        inv_mass_diag=imd, collect_every=1))
    with ThreadPoolExecutor(len(runs)) as pool:
        list(pool.map(F.build, [cd for cd, _, _ in runs.values()]))
    for name, (cd, q0, kw) in runs.items():
        col_bytes = sum(c.numel() * 4 for c in cd.column_values(
            torch.float32, device))
        outs = {}
        for flag in (False, True, True, False):
            outs[flag], ms = cs.timed(
                lambda: F.fused_hmc(cd, q0, stream_columns=flag, **kw),
                device, 1, False)
            print(f"RESULT stream {name} ({col_bytes} bytes of columns), "
                  f"{'streamed' if flag else 'synchronous'}: {q0.shape[1]} "
                  f"chains x {kw['n_iterations']} it x {kw['n_steps']} "
                  f"steps {ms:.3f} ms, accept "
                  f"{float(outs[flag][2].mean()):.4f}", flush=True)
        same = all(torch.equal(a, b) for a, b in zip(outs[True],
                                                     outs[False]))
        print(f"RESULT stream {name}: streamed and synchronous results "
              f"identical {same}", flush=True)


def adapt() -> None:
    import torch

    import chip_smoke as cs
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    device = torch.device("cuda")
    _, x, ys = cs.logistic_regression(rt)
    model = cs.mvnormal_logistic(rt, x, ys)[0]
    runs = (("kernel, per chain", "fused!", False, 5),
            ("scan path, per chain", "scan", False, 5),
            ("kernel, pooled", "fused!", True, 5),
            ("kernel, per chain, HMC(10)", "fused!", False, 10))
    for name, kernel, pooled, steps in runs:
        cfg = SamplerConfig(1000, 200, sampler=HMC(steps),
                            pooled_adaptation=pooled)
        tr = model.sample(cfg, n_chains=CHAINS, seed=0, kernel=kernel,
                          device=device)
        rhat = []
        for j in range(tr.chains.shape[2]):
            one = type("T", (), {"chains": tr.chains[:, :, j:j + 1]})
            rhat.append(round(cs.rank_rhat(one, device), 5))
        q = [0, 0.01, 0.5, 0.99, 1]
        print(f"RESULT adapt {name}: rank-r_hat by parameter {rhat}; "
              f"step size quantiles {q}: "
              f"{np.round(np.quantile(tr.step_size, q), 4).tolist()}; "
              f"accept {np.round(np.quantile(tr.accept_rate(), q), 3)}; "
              f"timings {tr.timings}", flush=True)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if argv[:1] == ["row-sums"]:
        row_sums()
    elif argv[:1] == ["plain"] and len(argv) == 2:
        plain(argv[1])
    elif argv[:1] == ["stream"]:
        stream()
    elif argv[:1] == ["tiles"] and len(argv) == 2:
        tiles(argv[1])
    elif argv[:1] == ["lanes"]:
        lanes()
    elif argv[:1] == ["layouts"]:
        layouts()
    elif argv[:1] == ["adapt"]:
        adapt()
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
