#!/usr/bin/env python3
"""Timing comparisons on a CUDA card for choices of the fused kernel.

Run from the root of a checkout on a machine with a CUDA card:

    python3 rainier_tpu_torch/tools/kernel_ab.py row-sums
    python3 rainier_tpu_torch/tools/kernel_ab.py plain LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py stream
    python3 rainier_tpu_torch/tools/kernel_ab.py tiles LABEL

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

``tiles``: the kernels of ``row-sums``' three models on their default
(synchronous) tiles, built from the ``rainier_tpu_torch`` that the
import finds, as ``plain`` does: run it with another checkout's root on
PYTHONPATH and with this one's, in turns, to compare two trees.  Prints
one line per model tagged LABEL.
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


def _register_runs(device):
    """{name: (model, (q0, ε, Σ̂), iterations)} for the README regression,
    the 100k-row logistic regression and GLMMPoisson2 at CHAINS chains."""
    import torch

    import chip_smoke as cs
    import rainier_tpu_torch as rt

    readme = cs.readme_regression(rt)[0]
    logit, x, ys = cs.logistic_regression(rt)
    glmm = cs.glmm_poisson(rt)
    # model, chains' start, iterations
    w_map, cov = cs.laplace_reference(x, ys)
    rng = np.random.default_rng(0)
    q_logit = w_map[:, None] + np.sqrt(np.diag(cov))[:, None] * rng.normal(
        size=(w_map.size, CHAINS))
    runs = {
        "README regression": (readme, _warm(readme, CHAINS, device), 1000),
        "logistic regression": (logit, (
            torch.as_tensor(q_logit, dtype=torch.float32, device=device),
            torch.full((CHAINS,), 0.76, device=device),
            torch.as_tensor(np.diag(cov).copy(), dtype=torch.float32,
                            device=device)), 100),
        "GLMMPoisson2": (glmm, _warm(glmm, CHAINS, device), 1000)}
    return runs


def _time_runs(runs, device, label, built=None):
    """Each run's kernel at CHAINS chains (warm, then timed), from the
    libraries `built` ({name: build}) or the model's own build."""
    import chip_smoke as cs
    from rainier_tpu_torch.ops import fused_hmc as F

    for name, (model, (q0, eps, imd), n_it) in runs.items():
        cd = model.density()
        kw = dict(step_size=eps, n_steps=5, n_iterations=n_it, seed=1,
                  inv_mass_diag=imd, collect_every=0)
        if built is not None:
            kernels, _, em = built[name]
            F._BUILT[cd] = (kernels, em)
        out, ms = cs.timed(lambda: F.fused_hmc(cd, q0, **kw), device, 1,
                           True)
        print(f"RESULT {label} {name}: {CHAINS} chains x {n_it} it x 5 "
              f"steps {ms:.3f} ms, accept {float(out[2].mean()):.4f}",
              flush=True)


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
            cds = [model.density() for model, _, _ in runs.values()]
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

    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device("cuda")
    runs = _register_runs(device)
    with ThreadPoolExecutor(len(runs)) as pool:
        list(pool.map(F.build, [m.density() for m, _, _ in runs.values()]))
    _time_runs(runs, device, f"tiles {label}")


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
        step_size=eps, n_steps=5, n_iterations=n_it, seed=1,
        inv_mass_diag=imd, collect_every=1))
        for name, (model, (q0, eps, imd), n_it)
        in _register_runs(device).items()}
    model, x, ys = cs.logistic_regression(rt, ROWS_2M)
    w_map, cov = cs.laplace_reference(x, ys)
    rng = np.random.default_rng(0)
    q0 = w_map[:, None] + np.sqrt(np.diag(cov))[:, None] * rng.normal(
        size=(w_map.size, CHAINS_2M))
    runs["logistic regression 2M"] = (model.density(), torch.as_tensor(
        q0, dtype=torch.float32, device=device), dict(
            step_size=torch.full((CHAINS_2M,), 0.76, device=device),
            n_steps=8, n_iterations=ITERS_2M, seed=1,
            inv_mass_diag=torch.as_tensor(np.diag(cov).copy(),
                                          dtype=torch.float32,
                                          device=device), collect_every=1))
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
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
