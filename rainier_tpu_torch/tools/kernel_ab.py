#!/usr/bin/env python3
"""Timing comparisons on a CUDA card for choices of the fused kernel.
Every kernel time is the median of several launches timed alone by CUDA
events (``launch_ms``: the wrapper's setup hoisted, the columns bound
once), after a warm launch: a checkout without ``prepare_fused_hmc``
(older than the launch-alone timing) cannot be timed so and is refused.

Run from the root of a checkout on a machine with a CUDA card:

    python3 rainier_tpu_torch/tools/kernel_ab.py row-sums
    python3 rainier_tpu_torch/tools/kernel_ab.py plain LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py stream
    python3 rainier_tpu_torch/tools/kernel_ab.py tiles LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py lanes
    python3 rainier_tpu_torch/tools/kernel_ab.py layouts
    python3 rainier_tpu_torch/tools/kernel_ab.py adapt
    python3 rainier_tpu_torch/tools/kernel_ab.py columnfree LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py forms LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py gather-tiles LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py gp-layouts LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py zoo STEPS DRAWS DTYPE [FAMILY ...]
    python3 rainier_tpu_torch/tools/kernel_ab.py split LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py tile-sizes LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py steps LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py loaders LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py lse LABEL

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
(False), in the order A B B A, on every model of ``tiles`` (the 2M-row
logistic's 88 MB of columns past the card's L2, the others' inside it),
every draw collected.  Prints one line per model and order, with the
results' equality.

``tiles``: the kernels of every model with rows that ``chip_smoke.py``
drives (``row-sums``' three, the MVNormal logistic, the logistic in two
row spaces, glmm_large, the 32-feature MVNormal logistic, the
marginalized mixture, the three zoo families of its kernel-vs-plain
phases, and the 2M-row logistic at 512 chains × 5 iterations of HMC(8)),
each as its launch decides, built from the ``rainier_tpu_torch`` that
the import finds, as ``plain`` does: run it with another checkout's root
on PYTHONPATH and with this one's, in turns, to compare two trees; then
each model's density alone (``rt_logp_grad_launch``) at CHECK_POINTS
states (its CHAINS states, then the first of them again: the shape of
chip_smoke.py's density checks).
Prints one line per model tagged LABEL, with its tile's rows and
whether the launch streamed.

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

``columnfree``: the kernels of models without rows at each count of
lanes a chain (the wrapper's rule ``fused_hmc.lanes_per_chain`` replaced
for the run, as ``lanes`` replaces ``chains_per_block``), one A B B A
round (1 2 4 ... 32 ... 4 2 1) per shape (``FREE_SHAPES``): the 10-dim
funnel at 1024 chains × 1000 iterations × 5 steps with on-device Philox
and with explicit noise, and with its state in a shared-memory slot in
place of every lane's registers; at 2,048 to 32,768 chains × 1000 × 5
at 1 to 16 lanes (``SWEEP_CHAINS``: where the rule's crossovers lie); at
524,288 × 500 × 5 (bench.py's throughput shape, ε 0.18 from q = 0); at
100 dims, 1024 chains × 200 ×
5, in a slot and in registers (``emit_cuda.LANE_STATE_MAX`` replaced for
its emission, as ``layouts`` does); and at 1000 dims (past 256
parameters, its state in the workspace) at 1 and 32 lanes.  Every
shape but the throughput one collects every draw, as the main path does
(of the first 10 coordinates past 10 dims).  Each run
prints its ms and the fraction of chains whose final q is within 1e-4
relative of the first run's of that shape.  With another checkout's
root on PYTHONPATH whose wrapper has no lane rule (the parent's, one
thread a chain), the emitter's own layouts run as their launch decides,
tagged "as built": run both checkouts in one call to compare trees.
Prints one line per shape, lanes and order, tagged LABEL.

``forms``: the kernels of the five density forms the emitter took last
(``chip_smoke.py``'s latent GP at 64 inputs, 1024 chains × 25 iterations
of HMC(12); its MVNormal logistic at 32 features, × 100 of HMC(5), from
points around its Laplace mode; and each row form of ``form_models`` at
100,000 rows, × 20 of HMC(4)), from a short scan-path warmup's states
where not named, each the median of 20 launches alone, built from the
``rainier_tpu_torch`` that the import finds, as ``tiles`` does: run it
with another checkout's root on PYTHONPATH and with this one's, in the
order A B B A, to compare two trees; then each form's density alone at
DENSITY_POINTS of those states.  Prints one line per form tagged LABEL,
with the time a density call.

``gather-tiles``: the row-varying gather of ``form_models`` (100,000
rows, 1024 chains × 20 iterations of HMC(4), from a short scan-path
warmup's states) with its space's tiles of each of ``GATHER_TILES`` rows
(``emit_cuda.TILE_ROWS_MAX`` replaced for its emission, as
``columnfree`` replaces ``LANE_STATE_MAX``), in the order A B B A, each
with the synchronous tile loop and with the streamed one, and the
density alone (``rt_logp_grad_launch``) at 576 of those states.  Prints
one line per tile size and loop, tagged LABEL, with whether the two
loops gave the same bits.

``gp-layouts``: ``chip_smoke.py``'s latent GP (64 inputs, 1024 chains ×
25 iterations of HMC(12), as ``forms`` times it) with the product
passes' L staged in the block's shared memory and read from a
transposed copy in device memory (emitted with a ``stage_budget`` of 0
bytes), in the order A B B A, and the density alone at 576
states.  Prints one line per layout, tagged LABEL, with whether its
draws are the first layout's bit for bit (both sum in one order).

``split``: the row loop's time split into its parts on three models of
``tiles`` (the 32-feature MVNormal logistic, the marginalized mixture and
the 100k logistic, 1024 chains × SPLIT_ITERS iterations), each built from
a copy of ``csrc/`` with one part removed (``SPLIT_PARTS``: the tile fill
past the first two tiles, the rows, the butterflies, the tile loop's
barriers), each loop as its launch decides, in the order base, parts,
parts reversed, base.  The copies patch whichever tree the import finds
(the one before the row loop's redesign or a later one), as ``row-sums``
does.  Prints one line per
model and build, tagged LABEL.

``tile-sizes``: the three models of ``split``, GLMMPoisson2 and
glmm_large (``TILE_SIZE_MODELS``, SPLIT_ITERS iterations) with tiles of
at most 256, 1024 and 4096 rows (``emit_cuda.TILE_ROWS_MAX`` replaced for
their emission; each takes the size rule's tile under it), in the order
256 1024 4096 4096 1024 256, each loop as its launch decides, each with
its density alone at CHECK_POINTS states.

``steps``: the kernels of the mixture, the zoo's negative binomial,
large Poisson and zero-inflated geometric, the README regression, the
100k logistic and the 32-feature MVNormal logistic (``STEP_MODELS``, at
TILE_ITERS iterations) with each lane summing 1, 2 and 4 rows a step
(``emit_cuda.ROW_STEP`` replaced for their emission, whatever the row's
width and operations), in the order 1 2 4 4 2 1, each held to the first
run's bits.

``loaders``: the synchronous tile loop (``stream_columns=False``) of
``LOADER_MODELS``, SPLIT_ITERS iterations each, with each of ``LOADERS``
as the emitter's loader: the tree's (``emit_cuda._fill``: asynchronous
copies, waited for at once), the earlier one (a loop a column, each value stored
as it is loaded: ``_column_fill``) and a batch of a thread's loads
before its stores (``_batched_fill``), in the order A B C C B A, each
held to the streamed launch's bits, which is timed first, and each with
its density alone at CHECK_POINTS states.

``lse``: the marginalized mixture, the zero-inflated geometric and the
mixture with overlapping components (rows that hold a LogSumExp), with
the LogSumExp adjoint's share as the tree emits it (``rt_lse_share``, a
division in f64 without a branch), as the f32 division ``e / s``, and as
that division guarded so that a zero e is not divided (``LSE_FORMS``,
the emitted text so replaced), TILE_ITERS iterations, in the order A B C
C B A, each held to the first run's bits.

``zoo``: the goldset zoo of ``chip_smoke.py`` (each family's 100,000
rows synthesized on the card, seed ``ZOO_SEED``), every family or those
named, fitted through ``Model.sample(kernel="fused!")`` at 1024 chains x
(``ZOO_WARMUP`` warmup in DTYPE, ``float32`` or ``float64``, + DRAWS
draws) of HMC(STEPS), seed 0.  Prints one line per family: its mean and
SD against ``chip_smoke.py``'s quadrature, rank-r̂, accept, step sizes
and timings.  No bar is applied: it reads what ``chip_smoke.py``'s zoo
phase holds to its bars.
"""


from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# after PYTHONPATH, so that another checkout put there is the one timed
sys.path.append(str(Path(__file__).resolve().parents[2]))

CHAINS, FEW_CHAINS, PLAIN_ITERS = 1024, 8, 100
# the device of ``tiles``, ``forms``, ``split``, ``steps``, ``lse``,
# ``loaders`` and ``stream`` (a CPU rehearsal sets "cpu": plain versions,
# no kernel)
DEVICE = "cuda"
# the 2M-row logistic regression's stream timing: 5 iterations of HMC(8)
ROWS_2M, CHAINS_2M, ITERS_2M = 2_000_000, 512, 5
# iterations of HMC(5) that ``tiles`` and ``lanes`` time each model over
# (the 2M-row logistic: ITERS_2M of HMC(8))
TILE_ITERS = {"README regression": 1000, "logistic regression": 100,
              "MVNormal logistic": 100,
              "logistic regression, two row spaces": 100,
              "GLMMPoisson2": 500, "glmm_large": 50,
              "MVNormal logistic 32": 100, "marginalized mixture": 100,
              "zoo zero_inflated_geometric": 100, "zoo large_poisson": 100,
              "zoo neg_binomial": 100}
# the leapfrog steps of the models that do not take HMC(5): the mixture
# and the zoo run HMC(4), as chip_smoke.py does
TILE_STEPS = {"marginalized mixture": 4, "zoo zero_inflated_geometric": 4,
              "zoo large_poisson": 4, "zoo neg_binomial": 4}
# ``split``: the models, their iterations, and the parts removed: for
# each, alternatives (this tree's, then the tree's before the row loop's
# redesign), each a list of
# (text, replacement) of fused_hmc.cu; the first whose texts the tree
# holds is applied
SPLIT_MODELS = ("MVNormal logistic 32", "marginalized mixture",
                "logistic regression")
SPLIT_ITERS = 20
_SYNC_FILL = "      rt_block_fill<S>(tile, cols, row0, n);\n"
_SYNC_FILL_OLD = ("      RtSpace<S>::fill(tile, cols, row0, n, RT_TID, "
                   "RT_NTHREADS);\n")
_STREAM_FILL = ("      rt_stream_tile<S>(tile + ((t + 1) & 1) * RT_TILE_FLOATS, cols,\n"
                "                        row0 + kTile, n_rows);\n")
_SYNC_ROWS = ("      RT_TILE_SYNC();\n"
              "      rt_tile_rows<S>(tile, n, inv, lanes, ainv, lp_acc, ainv_acc, cols, q,\n"
              "                      g);\n"
              "      RT_TILE_SYNC();\n")
_STREAM_ROWS = ("      RT_TILE_SYNC();\n"
                "      rt_tile_rows<S>(tile + (t & 1) * RT_TILE_FLOATS,\n"
                "                      n_rows - row0 < kTile ? n_rows - row0 : kTile, inv,\n"
                "                      lanes, ainv, lp_acc, ainv_acc, cols, q, g);\n"
                "      RT_TILE_SYNC();\n")


def _unsynced(text):
    return text.replace("      RT_TILE_SYNC();\n", "")


SPLIT_PARTS = {
    "no fill": [
        [(fill, "      if (row0 == 0)\n  " + fill),
         (_STREAM_FILL, _STREAM_FILL.replace(
             "row0 + kTile, n_rows", "t < 1 ? row0 + kTile : n_rows, n_rows"))]
        for fill in (_SYNC_FILL, _SYNC_FILL_OLD)],
    "no rows": [
        [("  typedef RtSpace<S> Sp;\n  enum { kG",
          "  typedef RtSpace<S> Sp;\n  rows >>= 30;\n  enum { kG")]],
    "no butterfly": [
        [("  const double lp_acc = rt_acc_sum(lp_lanes, 1, 0);\n",
          "  const double lp_acc = lp_lanes[0];\n"),
         ("    ainv[k] = (float)rt_acc_sum(ainv_acc, RT_NINV_DENSE_ALLOC, k);\n",
          "    ainv[k] = (float)ainv_acc[k];\n")],
        [("  lp_acc += (double)rt_warp_sum<RT_LANES>(lp_t);\n",
          "  lp_acc += (double)lp_t;\n"),
         ("    ainv_acc[k] += (double)rt_warp_sum<RT_LANES>(own[k]);\n",
          "    ainv_acc[k] += (double)own[k];\n")]],
    "no barriers": [
        [(_SYNC_ROWS, _unsynced(_SYNC_ROWS)),
         (_STREAM_ROWS, _unsynced(_STREAM_ROWS))]],
}
# the five forms that ``forms`` times: (iterations, leapfrog steps) at
# PERF.md §6's shapes, the launches each timed over, and the scan-path
# warmup iterations of HMC(5) their states come from
FORM_RUNS = {"latent GP": (25, 12), "MVNormal logistic 32": (100, 5),
             "form index column read whole": (20, 4),
             "form vector per row": (20, 4),
             "form row-varying gather": (20, 4)}
FORM_REPS, FORM_WARMUP = 20, 100
# ``gather-tiles``: the rows of the row-varying gather's tiles, in order;
# ``gp-layouts``: the GP's layouts by the staging budget each is emitted
# with (None: the emitter's own), in order; both also time the density
# alone at DENSITY_POINTS states
GATHER_TILES = (256, 1024, 2048, 4096, 4096, 2048, 1024, 256)
GP_LAYOUTS = {"shared memory": None, "transposed copy": 0}
GP_ORDER = ("shared memory", "transposed copy", "transposed copy",
            "shared memory")
DENSITY_POINTS = 576
# the density alone in ``tiles`` and ``tile-sizes``: at chip_smoke.py's
# density checks' 1088 points (1024 near a mode and 64 inits)
CHECK_POINTS = 1088
# the values of W that ``lanes`` times
LANE_W = (2, 4, 8, 8, 4, 2)
# ``columnfree``: (what, dims, chains, iterations, explicit noise, lanes
# a chain timed in order, the cap on the parameters that every lane holds
# in registers: 256 to hold them so, 0 to give them a slot, None for the
# emitter's own choice; a checkout without the lane rule times the shapes
# of None only, each as built)
FREE_LANES = (1, 2, 4, 8, 16, 32, 32, 16, 8, 4, 2, 1)
# the chain counts between the main path's and the throughput shape at
# which the 10-dim funnel is timed at 1 to 16 lanes: where the rule's
# crossovers lie
SWEEP_CHAINS = (2048, 4096, 8192, 16384, 32768)
SWEEP_LANES = (1, 2, 4, 8, 16, 16, 8, 4, 2, 1)
FREE_SHAPES = (
    ("funnel", 10, CHAINS, 1000, False, FREE_LANES, None),
    *((f"funnel, {n} chains", 10, n, 1000, False, SWEEP_LANES, None)
      for n in SWEEP_CHAINS),
    ("funnel, explicit noise", 10, CHAINS, 1000, True, FREE_LANES, None),
    ("funnel, slot in shared memory", 10, CHAINS, 1000, False,
     FREE_LANES[1:-1], 0),
    ("funnel, throughput", 10, 524288, 500, False, FREE_LANES, None),
    ("funnel 100, registers", 100, CHAINS, 200, False, (1, 8, 32, 32, 8, 1),
     256),
    ("funnel 100", 100, CHAINS, 200, False, (1, 8, 32, 32, 8, 1), None),
    ("funnel 1000", 1000, CHAINS, 200, False, (1, 32, 32, 1), None))
# coordinates of each draw collected at the 1024-chain shapes
FREE_COLLECT = 10
# launches timed a run, their median reported (others: 3)
FREE_REPS = {"funnel": 20, "funnel, explicit noise": 20,
             "funnel, slot in shared memory": 20, "funnel, throughput": 3,
             **{f"funnel, {n} chains": 10 for n in SWEEP_CHAINS}}

# every model's rows summed in f64 and lp rounded once
F64_ROWS = (
    ("typedef float rt_row_sum;\n", "typedef double rt_row_sum;\n"),
    ("#ifdef RT_WS_FLOATS\n  lp = (float)((double)lp + lp_acc);\n#else\n"
     "  lp += (float)lp_acc;\n#endif\n",
     "  lp = (float)((double)lp + lp_acc);\n"))


# cycles the card sleeps while the host queues a timed run's launches
# (about 12 ms on an H100): each launch's events then wait on the card
# alone, never on the host issuing the next launch
QUEUE_SLEEP_CYCLES = 20_000_000


def launch_ms(launch, device, reps: int = 10, warm: bool = True):
    """(output of the last launch, median ms of `reps` launches) of
    ``launch`` (a prepared launch: ``prepare_fused_hmc``'s), each timed
    alone by CUDA events around it, after one warm launch with `warm`;
    the card sleeps while the host queues them all.  The setup of the
    wrapper (columns, build, workspace) is not in the time.  The host
    clock off the card."""
    import torch

    out = launch() if warm else None
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = launch()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, float(np.median(times))
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    for start, end in events:
        start.record()
        out = launch()
        end.record()
    torch.cuda.synchronize()
    return out, float(np.median([a.elapsed_time(b) for a, b in events]))


def kernel_ms(F, cd, q0, kw, device, reps: int = 3):
    """``launch_ms`` of ``fused_hmc(cd, q0, **kw)``'s prepared launch, the
    columns bound once.  A tree the import finds without
    ``prepare_fused_hmc`` (an older checkout) cannot time its launches
    alone, and its whole calls are no yardstick against another tree's
    launches: it is refused."""
    import torch

    kw = dict(kw, columns=cd.column_values(torch.float32, device))
    prepare = getattr(F, "prepare_fused_hmc", None)
    if prepare is None:
        raise SystemExit(
            f"kernel_ab: {F.__file__} has no prepare_fused_hmc, so its "
            f"launches cannot be timed alone, as the other tree's are")
    return launch_ms(prepare(cd, q0, **kw), device, reps)


def _warm(model, n_chains, device, warmup=300):
    """(q0 (dim, n), ε (n,), Σ̂ (n, dim)) after `warmup` scan-path
    warmup iterations of HMC(5)."""
    import torch

    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    tr = model.sample(SamplerConfig(warmup, 1, sampler=HMC(5)),
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
    for name, model in _more_row_models(rt, cs, device).items():
        runs[name] = (model, _start(model, name, device), TILE_ITERS[name],
                      TILE_STEPS.get(name, 5))
    logit2m, x2, ys2 = cs.logistic_regression(rt, ROWS_2M)
    runs["logistic regression 2M"] = (logit2m, _laplace_start(
        cs.logistic_design(x2), ys2, CHAINS_2M, device), ITERS_2M, 8)
    return runs


def _more_row_models(rt, cs, device, names=None):
    """{name: model} of the models with rows that ``tiles`` times beside
    ``row-sums``' and the untiled ones: the 32-feature MVNormal logistic, the
    marginalized mixture and the zoo families of ``chip_smoke.py``'s
    kernel-vs-plain phases (each family's rows synthesized on `device`,
    as ``chip_smoke.zoo_models`` does), or those of them named."""
    want = set(names or [n for n in TILE_ITERS if n.startswith(
        ("MVNormal logistic 32", "marginalized", "zoo "))])
    out = {}
    if "MVNormal logistic 32" in want:
        _, x, ys = cs.logistic_regression(rt, p=cs.MV32_FEATURES)
        mv, alpha, betas = cs.mvnormal_logistic(rt, x, ys)
        mv._ab_start = (cs.mv_design(mv.density(), x, alpha, betas), ys)
        out["MVNormal logistic 32"] = mv
    if "marginalized mixture" in want:
        out["marginalized mixture"] = cs.marginal_mixture(rt)[0]
    for name, sbc in cs.zoo(rt):
        if f"zoo {name}" in want:
            data = sbc.synthesize(cs.ZOO_ROWS, cs.ZOO_SEED, device)[0]
            dist, _ = sbc.fn([p.latent() for p in sbc.priors])
            out[f"zoo {name}"] = rt.Model.observe(data.astype(np.float64),
                                                  dist)
    return out


def _start(model, name, device):
    """A run's (q0, ε, Σ̂): around the Laplace mode for the 32-feature
    MVNormal logistic, else after FORM_WARMUP scan-path iterations."""
    if hasattr(model, "_ab_start"):
        return _laplace_start(*model._ab_start, CHAINS, device)
    return _warm(model, CHAINS, device, FORM_WARMUP)


def _build(cd):
    """The kernel of a model with rows (a warp a chain)."""
    from rainier_tpu_torch.compute import emit_cuda
    from rainier_tpu_torch.ops import fused_hmc as F

    return F.build(cd, emit_cuda.LANES)


def _build_runs(runs):
    """Every run's kernel, one nvcc each, all started together."""
    with ThreadPoolExecutor(len(runs)) as pool:
        list(pool.map(_build, [run[0].density() for run in runs.values()]))


def _time_runs(runs, device, label, built=None, reps=3, stream=None):
    """Each run's kernel (warm, then the median of `reps` launches) as
    its launch decides (`stream`: its ``stream_columns``), from the
    libraries `built` ({name: build}) or the model's own build.  Returns
    the last run's outputs."""
    import chip_smoke as cs
    from rainier_tpu_torch.ops import fused_hmc as F

    for name, (model, (q0, eps, imd), n_it, n_steps) in runs.items():
        cd = model.density()
        kw = dict(step_size=eps, n_steps=n_steps, n_iterations=n_it,
                  seed=1, inv_mass_diag=imd, collect_every=0)
        if stream is not None:
            kw["stream_columns"] = stream
        if built is not None:
            kernels, _, em = built[name]
            F._BUILT[cd] = {F.emit_cuda.LANES: (kernels, em)}
        streamed = F.fused_hmc.streamed
        out, ms = kernel_ms(F, cd, q0, kw, device, reps)
        how = "streamed" if F.fused_hmc.streamed > streamed else \
            "synchronous"
        print(f"RESULT {label} {name}: {q0.shape[1]} chains x {n_it} it x "
              f"{n_steps} steps {ms:.3f} ms ({ms / (n_it * n_steps + 1):.4f}"
              f" ms a density call), accept {float(out[2].mean()):.4f}; "
              f"tiles of {F.emit_cuda.emit(cd).tile_rows} rows, {how}",
              flush=True)
    return out


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
                for name, b in zip(runs, pool.map(_build, cds)):
                    built[label, name] = b
                    print(f"built {label}, {name}: {b[1]:.2f} s", flush=True)
        F.CSRC = csrc
    for name, run in runs.items():
        for label in ("f32 tiles", "f64 rows", "f64 rows", "f32 tiles"):
            _time_runs({name: run}, device, f"row-sums {label},",
                       {name: built[label, name]})


def tiles(label: str) -> None:
    import torch

    device = torch.device(DEVICE)
    runs = _row_runs(device)
    _build_runs(runs)
    _time_runs(runs, device, f"tiles {label}")
    for name, (model, (q0, _, _), _, _) in runs.items():
        _density_alone(model, _check_points(q0), device,
                       f"tiles {label} {name}")


def _check_points(q0):
    """CHECK_POINTS states from a run's q0 (its columns, then its first
    again): the shape of chip_smoke.py's density checks, whose
    CHECK_POINTS chains fill more blocks than the card has SMs."""
    import torch

    return torch.cat([q0, q0[:, :CHECK_POINTS - q0.shape[1]]],
                     1).contiguous() if q0.shape[1] < CHECK_POINTS else q0


def _variant_csrc(csrc, tmp, changes):
    """A copy of the sources `csrc` in `tmp` with `changes` (SPLIT_PARTS'
    alternatives) applied to fused_hmc.cu: the first alternative whose
    texts the tree holds."""
    d = Path(tmp)
    shutil.copytree(csrc, d)
    src = (d / "fused_hmc.cu").read_text()
    for alt in changes:
        if all(src.count(old) == 1 for old, _ in alt):
            for old, new in alt:
                src = src.replace(old, new)
            (d / "fused_hmc.cu").write_text(src)
            return d
    raise RuntimeError(f"fused_hmc.cu holds none of {changes!r}")


def _run_kernel(F, cd, start, n_it, n_steps, device, reps=3, stream=None):
    """The kernel of the model `cd` from `start` (its build already in
    F._BUILT): (outputs, median ms, whether it streamed)."""
    q0, eps, imd = start
    kw = dict(step_size=eps, n_steps=n_steps, n_iterations=n_it, seed=1,
              inv_mass_diag=imd, collect_every=0)
    if stream is not None:
        kw["stream_columns"] = stream
    streamed = F.fused_hmc.streamed
    out, ms = kernel_ms(F, cd, q0, kw, device, reps)
    return out, ms, F.fused_hmc.streamed > streamed


def split(label: str) -> None:
    import torch

    import chip_smoke as cs
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.compute import emit_cuda
    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device(DEVICE)
    models = _more_row_models(rt, cs, device, SPLIT_MODELS[:2])
    logit, x, ys = cs.logistic_regression(rt)
    starts = {name: _start(m, name, device) for name, m in models.items()}
    models["logistic regression"] = logit
    starts["logistic regression"] = _laplace_start(
        cs.logistic_design(x), ys, CHAINS, device)
    builds = ("base", *SPLIT_PARTS)
    csrc = F.CSRC
    built = {}
    with tempfile.TemporaryDirectory() as tmp:
        for what in builds:
            F.CSRC = csrc if what == "base" else _variant_csrc(
                csrc, Path(tmp) / what.replace(" ", "_"), SPLIT_PARTS[what])
            cds = [models[name].density() for name in SPLIT_MODELS]
            for cd in cds:
                F._BUILT.pop(cd, None)
            with ThreadPoolExecutor(len(cds)) as pool:
                for name, b in zip(SPLIT_MODELS, pool.map(_build, cds)):
                    built[what, name] = b
        F.CSRC = csrc
    for name in SPLIT_MODELS:
        cd = models[name].density()
        log = built["base", name][0].log
        print(f"RESULT split {label} {name}: ptxas " + " | ".join(
            line.split("ptxas info    : ")[-1].strip()
            for line in log.splitlines()
            if "registers" in line or "spill" in line), flush=True)
        for what in (*builds, *builds[::-1]):
            kernels, _, em = built[what, name]
            F._BUILT[cd] = {emit_cuda.LANES: (kernels, em)}
            steps = TILE_STEPS.get(name, 5)
            out, ms, streamed = _run_kernel(F, cd, starts[name], SPLIT_ITERS,
                                            steps, device)
            print(f"RESULT split {label} {name}, {what}: {CHAINS} chains x "
                  f"{SPLIT_ITERS} it x {steps} steps {ms:.3f} ms, tiles of "
                  f"{em.tile_rows} rows, "
                  f"{'streamed' if streamed else 'synchronous'}, accept "
                  f"{float(out[2].mean()):.4f}", flush=True)


# ``tile-sizes``: the models, and the most rows of a tile each is timed
# at, in order (each model's tile the size rule's under that most)
TILE_SIZE_MODELS = (*SPLIT_MODELS, "GLMMPoisson2", "glmm_large")
TILE_SIZES = (256, 1024, 4096, 4096, 1024, 256)


def tile_sizes(label: str) -> None:
    import torch

    import chip_smoke as cs
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.compute import emit_cuda
    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device(DEVICE)

    def build(name):
        if name == "logistic regression":
            return cs.logistic_regression(rt)[0]
        if name == "GLMMPoisson2":
            return cs.glmm_poisson(rt)
        if name == "glmm_large":
            return cs.glmm_large(rt)
        return _more_row_models(rt, cs, device, [name])[name]

    runs, starts = {}, {}
    for name in TILE_SIZE_MODELS:
        for most in dict.fromkeys(TILE_SIZES):
            model = build(name)
            if name not in starts:
                starts[name] = _start(model, name, device) if name != \
                    "logistic regression" else _laplace_start(
                        cs.logistic_design(cs.logistic_regression(rt)[1]),
                        cs.logistic_regression(rt)[2], CHAINS, device)
            _emit_as(model.density(), {"TILE_ROWS_MAX": most})
            runs[name, most] = (model, starts[name])
    _build_runs(runs)
    for name in TILE_SIZE_MODELS:
        for most in TILE_SIZES:
            model, start = runs[name, most]
            out, ms, streamed = _run_kernel(F, model.density(), start,
                                            SPLIT_ITERS,
                                            TILE_STEPS.get(name, 5), device)
            tag = (f"tile-sizes {label} {name}, tiles of "
                   f"{emit_cuda.emit(model.density()).tile_rows} rows (at "
                   f"most {most})")
            print(f"RESULT {tag}: {CHAINS} chains x {SPLIT_ITERS} it "
                  f"{ms:.3f} ms, {'streamed' if streamed else 'synchronous'}",
                  flush=True)
            _density_alone(model, _check_points(start[0]), device, tag)


# ``steps``: the models and the rows a step each is timed at, in order
STEP_MODELS = ("marginalized mixture", "zoo neg_binomial",
               "zoo large_poisson", "zoo zero_inflated_geometric",
               "README regression", "logistic regression",
               "MVNormal logistic 32")
STEP_ORDER = (1, 2, 4, 4, 2, 1)


def steps(label: str) -> None:
    import torch

    import chip_smoke as cs
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device(DEVICE)

    def build(name):
        if name == "README regression":
            return cs.readme_regression(rt)[0]
        if name == "logistic regression":
            return cs.logistic_regression(rt)[0]
        return _more_row_models(rt, cs, device, [name])[name]

    runs = {}
    for name in STEP_MODELS:
        first = build(name)
        start = _start(first, name, device) if name != \
            "logistic regression" else _laplace_start(
                cs.logistic_design(cs.logistic_regression(rt)[1]),
                cs.logistic_regression(rt)[2], CHAINS, device)
        for r in dict.fromkeys(STEP_ORDER):
            model = first if r == STEP_ORDER[0] else build(name)
            _emit_as(model.density(), {"ROW_STEP": r, "ROW_STEP_OPS": 0,
                                       "ROW_STEP_FLOATS": 1 << 30})
            runs[name, r] = (model, start)
    _build_runs({key: run for key, run in runs.items()})
    for name in STEP_MODELS:
        first = None
        for r in STEP_ORDER:
            model, start = runs[name, r]
            out, ms, streamed = _run_kernel(
                F, model.density(), start, TILE_ITERS[name],
                TILE_STEPS.get(name, 5), device)
            first = out if first is None else first
            print(f"RESULT steps {label} {name}, {r} rows a step: {CHAINS} "
                  f"chains x {TILE_ITERS[name]} it {ms:.3f} ms, "
                  f"{'streamed' if streamed else 'synchronous'}, the bits "
                  f"of {STEP_ORDER[0]} a step: {_same_bits(out, first)}",
                  flush=True)


# ``lse``: the models whose rows hold a LogSumExp, in order (the mixture
# also with components that overlap: MIX_SCALE replaced for its data);
# the emitted division replaced by the f32 one, and that guarded so that
# a zero e (a term far below the max) is not divided: it divides 1 and
# gives 0, the bits of e / s wherever s is a number
LSE_MODELS = ("marginalized mixture", "zoo zero_inflated_geometric",
              "marginalized mixture, overlapping")
LSE_OVERLAP_SCALE = 2.0
LSE_DIVIDE = (r"rt_lse_share\((\w+), (\w+)\)", r"(\1 / \2)")
LSE_GUARD = (r"\((e\w+) / (s\w+)\)",
             r"(\1 > 0.0f || \2 != \2 ? (\1 > 0.0f || \2 != \2 ? \1 : "
             r"1.0f) / \2 : 0.0f)")
LSE_FORMS = {"f64 share (the tree's)": (),
             "f32 division": (LSE_DIVIDE,),
             "f32 division, zero not divided": (LSE_DIVIDE, LSE_GUARD)}


def lse(label: str) -> None:
    import dataclasses
    import re

    import torch

    import chip_smoke as cs
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.compute import emit_cuda
    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device(DEVICE)

    def build(name):
        if name.endswith("overlapping"):
            scale = cs.MIX_SCALE
            cs.MIX_SCALE = LSE_OVERLAP_SCALE
            try:
                return cs.marginal_mixture(rt)[0]
            finally:
                cs.MIX_SCALE = scale
        return _more_row_models(rt, cs, device, [name])[name]

    runs = {}
    for name in LSE_MODELS:
        start = None
        for form, subs in LSE_FORMS.items():
            model = build(name)
            start = start or _warm(model, CHAINS, device, FORM_WARMUP)
            cd = model.density()
            em = emit_cuda.emit(cd)
            src = em.source
            for pattern, repl in subs:
                src = re.sub(pattern, repl, src)
            emit_cuda._EMITTED[cd] = dataclasses.replace(em, source=src)
            runs[name, form] = (model, start)
    _build_runs(runs)
    order = (*LSE_FORMS, *reversed(LSE_FORMS))
    for name in LSE_MODELS:
        first = None
        for form in order:
            model, start = runs[name, form]
            n_it = TILE_ITERS.get(name, TILE_ITERS["marginalized mixture"])
            out, ms, _ = _run_kernel(F, model.density(), start, n_it,
                                     TILE_STEPS.get(name, 4), device)
            first = out if first is None else first
            print(f"RESULT lse {label} {name}, {form}: {CHAINS} chains x "
                  f"{n_it} it {ms:.3f} ms, the first run's bits: "
                  f"{_same_bits(out, first)}", flush=True)


# ``loaders``: the models (and the synchronous loop's loaders: LOADERS)
LOADER_MODELS = ("MVNormal logistic 32", "marginalized mixture",
                 "logistic regression", "README regression", "glmm_large")
def _column_fill(cd, space, offs, widths, row_w, loads=()):
    """The synchronous tile loader, from before the row loop's redesign,
    of a space that gathers nothing, as the emitter's one loader: a loop
    a column, each thread storing each value as it loads it (a wide
    column's floats in order over the threads); the tile loops' waits
    for copies then wait for none."""
    from rainier_tpu_torch.compute import real as R

    if loads:
        raise ValueError("the per-column loader gathers nothing")
    fill = []
    loop = "  for (int i = tid; i < rows; i += nt) "
    for j, w in zip(space.columns, widths):
        c = cd.columns[j]
        o = offs[c.id]
        if w == 1:
            v = f"cols.c{j}[row0 + i]"
            fill.append(f"{loop}tile[i * {row_w} + {o}] = " + (
                f"rt_int_bits({v})" if isinstance(c, R.IntColumn) else v)
                + ";")
        elif w > 1:
            fill += [f"  for (int i = tid; i < rows * {w}; i += nt) {{",
                     f"    const int r = i / {w};",
                     f"    tile[r * {row_w} + {o} + i - r * {w}] = "
                     f"cols.c{j}[(size_t)row0 * {w} + i];", "  }"]
    if "rix" in offs:
        fill.append(f"{loop}tile[i * {row_w} + {offs['rix']}] = "
                    "rt_int_bits(row0 + i);")
    return fill


def _batched_fill(cd, space, offs, widths, row_w, loads=()):
    """A synchronous tile loader for a space that gathers nothing, as the
    emitter's one loader: each thread takes a batch of its rows at a time
    (FILL_BATCH rows, fewer past FILL_VALUES values a thread), and of
    each wide column the batch's floats in order over the threads, and
    issues every load of a batch before any of its stores (into
    registers); the tile loops' waits for copies then wait for none."""
    from rainier_tpu_torch.compute import emit_cuda
    from rainier_tpu_torch.compute import real as R

    if loads:
        raise ValueError("the batched loader here gathers nothing")
    vals, stores, flats = [], [], []
    at = f"tile[i * {row_w} + {{}}]"
    for j, w in zip(space.columns, widths):
        c = cd.columns[j]
        if w == 1:
            src = f"cols.c{j}[r]"
            vals.append(f"rt_int_bits({src})"
                        if isinstance(c, R.IntColumn) else src)
            stores.append(f"{at.format(offs[c.id])} = v[u][{len(vals) - 1}];")
        elif w > 1:
            flats.append((j, offs[c.id], w))
    if "rix" in offs:
        stores.append(f"{at.format(offs['rix'])} = rt_int_bits(row0 + i);")
    b = max(1, min(emit_cuda.FILL_BATCH, emit_cuda.FILL_VALUES // max(
        len(vals) + sum(w for _, _, w in flats), 1)))
    fill = [f"  for (int w0 = 0; w0 < rows; w0 += {b} * nt) {{",
            "    const int i0 = w0 + tid;",
            f"    float v[{b}][{max(len(vals), 1)}];", "#pragma unroll",
            f"    for (int u = 0; u < {b}; ++u) {{",
            "      const int r = row0 + (i0 + u * nt < rows ? i0 + u * nt "
            ": 0);", *[f"      v[u][{m}] = {e};" for m, e in enumerate(vals)],
            "    }"]
    for j, o, w in flats:
        fill += [f"    float f{j}[{b * w}];", "#pragma unroll",
                 f"    for (int u = 0; u < {b * w}; ++u) {{",
                 f"      const int e = w0 * {w} + tid + u * nt;",
                 f"      f{j}[u] = e < rows * {w} ? cols.c{j}[(size_t)row0 * "
                 f"{w} + e] : 0.0f;", "    }"]
    fill += ["#pragma unroll", f"    for (int u = 0; u < {b}; ++u) {{",
             "      const int i = i0 + u * nt;", "      if (i < rows) {",
             *[f"        {line}" for line in stores], "      }", "    }"]
    for j, o, w in flats:
        fill += ["#pragma unroll", f"    for (int u = 0; u < {b * w}; ++u) {{",
                 f"      const int e = w0 * {w} + tid + u * nt;",
                 f"      if (e < rows * {w}) tile[e / {w} * {row_w} + {o} + "
                 f"e % {w}] = f{j}[u];", "    }"]
    return fill + ["  }"]


LOADERS = {"copies and a wait (the tree's)": None,
           "loads then stores, a loop a column (the earlier)": _column_fill,
           "a batch's loads before its stores": _batched_fill}


def loaders(label: str) -> None:
    import torch

    import chip_smoke as cs
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device(DEVICE)

    def build(name):
        if name == "logistic regression":
            return cs.logistic_regression(rt)[0]
        if name == "README regression":
            return cs.readme_regression(rt)[0]
        if name == "glmm_large":
            return cs.glmm_large(rt)
        return _more_row_models(rt, cs, device, [name])[name]

    runs = {}
    for name in LOADER_MODELS:
        start = None
        for what, fill in LOADERS.items():
            model = build(name)
            if start is None:
                start = _start(model, name, device) if name != \
                    "logistic regression" else _laplace_start(
                        cs.logistic_design(cs.logistic_regression(rt)[1]),
                        cs.logistic_regression(rt)[2], CHAINS, device)
            if fill is not None:
                _emit_as(model.density(), {"_fill": fill})
            runs[name, what] = (model, start)
    _build_runs(runs)
    order = (*LOADERS, *reversed(LOADERS))
    for name in LOADER_MODELS:
        model, start = runs[name, next(iter(LOADERS))]
        ref, ms, _ = _run_kernel(F, model.density(), start, SPLIT_ITERS,
                                 TILE_STEPS.get(name, 5), device, stream=True)
        print(f"RESULT loaders {label} {name}, the tree's, streamed: "
              f"{SPLIT_ITERS} it {ms:.3f} ms", flush=True)
        for what in order:
            model, start = runs[name, what]
            out, ms, _ = _run_kernel(F, model.density(), start, SPLIT_ITERS,
                                     TILE_STEPS.get(name, 5), device,
                                     stream=False)
            print(f"RESULT loaders {label} {name}, {what}, synchronous: "
                  f"{SPLIT_ITERS} it {ms:.3f} ms, the streamed launch's "
                  f"bits: {_same_bits(out, ref)}", flush=True)
            _density_alone(model, _check_points(start[0]), device,
                           f"loaders {label} {name}, {what}, synchronous")


def _form_runs(device):
    """{name: (model, (q0, ε, Σ̂), iterations, leapfrog steps)} for the
    five forms of FORM_RUNS at CHAINS chains."""
    import chip_smoke as cs
    import rainier_tpu_torch as rt

    gp = cs.latent_gp(rt)[0]
    _, x, ys = cs.logistic_regression(rt, p=cs.MV32_FEATURES)
    mv, alpha, betas = cs.mvnormal_logistic(rt, x, ys)
    starts = {"latent GP": (gp, _warm(gp, CHAINS, device, FORM_WARMUP)),
              "MVNormal logistic 32": (mv, _laplace_start(
                  cs.mv_design(mv.density(), x, alpha, betas), ys, CHAINS,
                  device))}
    for name, (model, _) in cs.form_models(rt).items():
        starts[f"form {name}"] = (model, _warm(model, CHAINS, device,
                                               FORM_WARMUP))
    return {name: (model, start, *FORM_RUNS[name])
            for name, (model, start) in starts.items()}


def forms(label: str) -> None:
    import torch

    device = torch.device(DEVICE)
    runs = _form_runs(device)
    _build_runs(runs)
    _time_runs(runs, device, f"forms {label}", reps=FORM_REPS)
    for name, (model, (q0, _, _), _, _) in runs.items():
        _density_alone(model, q0[:, :DENSITY_POINTS].contiguous(), device,
                       f"forms {label} {name}")


def _emit_as(cd, consts):
    """The density `cd` emitted, once a process, with the constants
    `consts` of ``emit_cuda`` in place (restored after)."""
    from rainier_tpu_torch.compute import emit_cuda

    old = {k: getattr(emit_cuda, k) for k in consts}
    try:
        for k, v in consts.items():
            setattr(emit_cuda, k, v)
        emit_cuda.emit(cd)
    finally:
        for k, v in old.items():
            setattr(emit_cuda, k, v)


def _same_bits(a, b):
    """Whether two launches' outputs are equal bit for bit (None for the
    draws of both where none were collected)."""
    import torch

    return all(x is y or torch.equal(x, y) for x, y in zip(a, b))


def _density_alone(model, q, device, label):
    """``rt_logp_grad_launch`` of `model` at the columns of q, the median
    of FORM_REPS launches alone, printed tagged `label`."""
    from rainier_tpu_torch.ops import fused_hmc as F

    _, ms = launch_ms(F.prepare_logp_grad(model.density(), q), device,
                      FORM_REPS)
    print(f"RESULT {label}: density alone at {q.shape[1]} q {ms:.4f} ms",
          flush=True)


def gather_tiles(label: str) -> None:
    import torch

    import chip_smoke as cs
    import rainier_tpu_torch as rt

    device = torch.device("cuda")
    name = "form row-varying gather"

    def build():
        return cs.form_models(rt)["row-varying gather"][0]

    start = _warm(build(), CHAINS, device, FORM_WARMUP)
    runs = {rows: (build(), start, *FORM_RUNS[name])
            for rows in dict.fromkeys(GATHER_TILES)}
    for rows, run in runs.items():
        _emit_as(run[0].density(), {"TILE_ROWS_MAX": rows})
    _build_runs(runs)
    q = start[0][:, :DENSITY_POINTS].contiguous()
    for rows in GATHER_TILES:
        tag = f"gather-tiles {label} tile {rows}"
        outs = [_time_runs({name: runs[rows]}, device, f"{tag}, {loop}",
                           reps=FORM_REPS, stream=stream)
                for loop, stream in (("synchronous", False),
                                     ("streamed", True))]
        same = _same_bits(*outs)
        print(f"RESULT {tag} the two loops the same bits: {same}",
              flush=True)
        _density_alone(runs[rows][0], q, device, tag)


def gp_layouts(label: str) -> None:
    import torch

    import chip_smoke as cs
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.compute import emit_cuda

    device = torch.device("cuda")
    name = "latent GP"

    def build():
        return cs.latent_gp(rt)[0]

    start = _warm(build(), CHAINS, device, FORM_WARMUP)
    runs = {what: (build(), start, *FORM_RUNS[name]) for what in GP_LAYOUTS}
    for what, budget in GP_LAYOUTS.items():
        emit_cuda.emit(runs[what][0].density(), stage_budget=budget)
    _build_runs(runs)
    q = start[0][:, :DENSITY_POINTS].contiguous()
    first = None
    for what in GP_ORDER:
        out = _time_runs({name: runs[what]}, device,
                         f"gp-layouts {label} {what},", reps=FORM_REPS)
        first = out if first is None else first
        same = _same_bits(out, first)
        print(f"RESULT gp-layouts {label} {what}: the first layout's bits "
              f"{same}", flush=True)
        _density_alone(runs[what][0], q, device,
                       f"gp-layouts {label} {what}")


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

    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device(DEVICE)
    runs = {name: (model.density(), q0, dict(
        step_size=eps, n_steps=n_steps, n_iterations=n_it, seed=1,
        inv_mass_diag=imd, collect_every=1))
        for name, (model, (q0, eps, imd), n_it, n_steps)
        in _row_runs(device).items()}
    with ThreadPoolExecutor(len(runs)) as pool:
        list(pool.map(_build, [cd for cd, _, _ in runs.values()]))
    for name, (cd, q0, kw) in runs.items():
        col_bytes = sum(c.numel() * 4 for c in cd.column_values(
            torch.float32, device))
        outs = {}
        for flag in (False, True, True, False):
            outs[flag], ms = kernel_ms(F, cd, q0, dict(
                kw, stream_columns=flag), device)
            print(f"RESULT stream {name} ({col_bytes} bytes of columns, "
                  f"tiles of {F.emit_cuda.emit(cd).tile_rows} rows), "
                  f"{'streamed' if flag else 'synchronous'}: {q0.shape[1]} "
                  f"chains x {kw['n_iterations']} it x {kw['n_steps']} "
                  f"steps {ms:.3f} ms, accept "
                  f"{float(outs[flag][2].mean()):.4f}", flush=True)
        print(f"RESULT stream {name}: streamed and synchronous results "
              f"identical {_same_bits(outs[True], outs[False])}",
              flush=True)


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
        rhat = [round(d.r_hat, 5)
                for d in tr.diagnostics(rank_normalized=True)]
        q = [0, 0.01, 0.5, 0.99, 1]
        print(f"RESULT adapt {name}: rank-r_hat by parameter {rhat}; "
              f"step size quantiles {q}: "
              f"{np.round(np.quantile(tr.step_size, q), 4).tolist()}; "
              f"accept {np.round(np.quantile(tr.accept_rate(), q), 3)}; "
              f"timings {tr.timings}", flush=True)


def _funnel(rt, dim):
    """Neal's funnel of chip_smoke.py at `dim` dimensions: y and a
    (dim - 1)-vector, built here so that another checkout's package
    builds it too."""
    y = rt.Normal(0.0, 3.0).latent()
    xv = rt.Normal(0.0, (y / 2).exp()).latent_vec(dim - 1)
    return rt.Model.track_({y} | set(xv.to_list()))


def columnfree(label: str) -> None:
    import torch

    import chip_smoke as cs
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device("cuda")
    lanes_rule = hasattr(F, "LANE_STEPS")
    gen = torch.Generator(device=device).manual_seed(3)
    shapes = []
    for what, dim, n, n_it, explicit, order, cap in FREE_SHAPES:
        if not lanes_rule and cap is not None:
            continue
        cd = _funnel(rt, dim).density()
        if n == cs.THROUGHPUT_CHAINS:
            q0 = torch.zeros((dim, n), device=device)
            kw = dict(step_size=cs.THROUGHPUT_EPS)
        else:
            q0 = torch.randn((dim, n), device=device, generator=gen)
            kw = dict(step_size=0.3 + 0.6 * torch.rand(
                n, device=device, generator=gen), inv_mass_diag=0.5
                + 1.5 * torch.rand((n, dim), device=device, generator=gen))
        # every draw collected, as the main path does (its first
        # FREE_COLLECT coordinates past them), but at the throughput shape
        kw.update(n_steps=5, n_iterations=n_it, seed=1,
                  collect_every=int(n != cs.THROUGHPUT_CHAINS),
                  collect_idx=None if dim <= FREE_COLLECT
                  else list(range(FREE_COLLECT)))
        if explicit:
            kw["noise"] = (
                torch.randn((n_it, dim, n), device=device, generator=gen),
                torch.rand((n_it, n), device=device, generator=gen)
                .clamp(min=1.1920929e-7))
        if not lanes_rule:
            order = (None, None)
        elif cap is not None:
            # every lane's registers or a slot, whatever the size: the
            # model's emission made now, under this cap
            _emit_as(cd, {"LANE_STATE_MAX": cap})
        shapes.append((what, cd, q0, kw, order))
    if lanes_rule:
        jobs = list(dict.fromkeys((cd, lanes) for _, cd, _, _, order
                                  in shapes for lanes in order))
        with ThreadPoolExecutor(len(jobs)) as pool:
            list(pool.map(lambda job: F.build(*job), jobs))
    rule = getattr(F, "lanes_per_chain", None)
    try:
        for what, cd, q0, kw, order in shapes:
            first = None
            for lanes in order:
                if lanes is not None:
                    F.lanes_per_chain = lambda em, n, lanes=lanes: lanes
                out, ms = kernel_ms(F, cd, q0, kw, device,
                                    FREE_REPS.get(what, 3))
                first = out if first is None else first
                agree = cs.agreement(out, first)[0]
                print(f"RESULT columnfree {label} {what}, "
                      f"{'as built' if lanes is None else f'L={lanes}'}: "
                      f"{q0.shape[1]} chains x {kw['n_iterations']} it x 5 "
                      f"steps {ms:.4f} ms, accept "
                      f"{float(out[2].mean()):.4f}, {agree:.4f} of chains "
                      f"within 1e-4 rel of the first run", flush=True)
    finally:
        if rule is not None:
            F.lanes_per_chain = rule


def zoo(n_steps: int, n_draws: int, dtype: str, families) -> None:
    import torch

    import chip_smoke as cs
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    device = torch.device("cuda")
    models = cs.zoo_models(rt, device)
    names = families or list(models)
    _build_runs({name: models[name] for name in names})
    cfg = SamplerConfig(cs.ZOO_WARMUP, n_draws, sampler=HMC(n_steps))
    for name in names:
        model, _, stat, data, _ = models[name]
        mean_q, sd_q = cs.quadrature(*cs.zoo_log_posterior(name, data))
        tr = model.sample(cfg, n_chains=CHAINS, seed=0, kernel="fused!",
                          device=device, dtype=getattr(torch, dtype))
        x = tr.evaluate(stat)
        steps = np.quantile(tr.step_size, [0.01, 0.5, 0.99])
        print(f"RESULT zoo {name}, HMC({n_steps}), {dtype} warmup: "
              f"{CHAINS} chains x ({cs.ZOO_WARMUP} + {n_draws}): mean "
              f"{abs(float(x.mean()) - mean_q) / sd_q:.4f} posterior SD "
              f"from the quadrature's, SD {float(x.std()) / sd_q - 1:+.4f} "
              f"off, rank-r_hat {cs.rank_rhat(tr):.5f}, accept "
              f"{float(np.mean(tr.accept_rate())):.3f}, step size "
              f"quantiles (0.01, 0.5, 0.99) {np.round(steps, 7).tolist()}, "
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
    elif argv[:1] == ["columnfree"] and len(argv) == 2:
        columnfree(argv[1])
    elif argv[:1] == ["forms"] and len(argv) == 2:
        forms(argv[1])
    elif argv[:1] == ["gather-tiles"] and len(argv) == 2:
        gather_tiles(argv[1])
    elif argv[:1] == ["gp-layouts"] and len(argv) == 2:
        gp_layouts(argv[1])
    elif argv[:1] == ["split"] and len(argv) == 2:
        split(argv[1])
    elif argv[:1] == ["tile-sizes"] and len(argv) == 2:
        tile_sizes(argv[1])
    elif argv[:1] == ["steps"] and len(argv) == 2:
        steps(argv[1])
    elif argv[:1] == ["loaders"] and len(argv) == 2:
        loaders(argv[1])
    elif argv[:1] == ["lse"] and len(argv) == 2:
        lse(argv[1])
    elif argv[:1] == ["zoo"] and len(argv) >= 4:
        zoo(int(argv[1]), int(argv[2]), argv[3], argv[4:])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
