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
    python3 rainier_tpu_torch/tools/kernel_ab.py tiles LABEL [MODEL ...]
    python3 rainier_tpu_torch/tools/kernel_ab.py lanes
    python3 rainier_tpu_torch/tools/kernel_ab.py layouts
    python3 rainier_tpu_torch/tools/kernel_ab.py adapt
    python3 rainier_tpu_torch/tools/kernel_ab.py columnfree LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py resident-lanes LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py philox-split LABEL [MODEL ...]
    python3 rainier_tpu_torch/tools/kernel_ab.py forms LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py gather-tiles LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py gp-layouts LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py zoo STEPS DRAWS DTYPE [FAMILY ...]
    python3 rainier_tpu_torch/tools/kernel_ab.py split LABEL [MODEL ...]
    python3 rainier_tpu_torch/tools/kernel_ab.py tile-sizes LABEL [MODEL ...]
    python3 rainier_tpu_torch/tools/kernel_ab.py gather-steps LABEL [MODEL ...]
    python3 rainier_tpu_torch/tools/kernel_ab.py gather-paths LABEL [MODEL ...]
    python3 rainier_tpu_torch/tools/kernel_ab.py eadd-select LABEL [DIR]
    python3 rainier_tpu_torch/tools/kernel_ab.py steps LABEL [MODEL ...]
    python3 rainier_tpu_torch/tools/kernel_ab.py loaders LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py lse LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py counts LABEL [MODEL ...]
    python3 rainier_tpu_torch/tools/kernel_ab.py row-sass LABEL [MODEL ...]
    python3 rainier_tpu_torch/tools/kernel_ab.py row-loads LABEL [MODEL ...]
    python3 rainier_tpu_torch/tools/kernel_ab.py lse-probe LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py gp-split LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py gp-blocks LABEL
    python3 rainier_tpu_torch/tools/kernel_ab.py kernel-sass LABEL MODEL [MODEL ...]

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
each as its launch decides (built at the lanes a chain of the wrapper's
rule for its chains), built from the ``rainier_tpu_torch`` that
the import finds, as ``plain`` does: run it with another checkout's root
on PYTHONPATH and with this one's, in turns, to compare two trees; then
each model's density alone (``rt_logp_grad_launch``) at CHECK_POINTS
states (its CHAINS states, then the first of them again: the shape of
chip_smoke.py's density checks); or only the models named after LABEL.
Prints one line per model tagged LABEL, with its tile's rows and
whether the launch streamed, after ptxas's report of each function of
its build (stack frame, spills, a kernel's registers: a device function
reported apart is called, not inlined).

``resident-lanes``: the resident register models (``RESIDENT_MODELS``:
the README regression and SBC's two families at SBC_ROWS rows, each
synthesized from ZOO_SEED) at 1024, 4096 and 16,384 chains × 1000
iterations × 5 steps, every draw collected, from a short scan-path
warmup's states repeated to the chains, at each (lanes a chain, chains
a block) of ``RESIDENT_LAYOUTS`` (the wrapper's ``lanes_per_chain`` and
``chains_per_block`` replaced for the run, as ``columnfree`` does), in
order and back; each width is a model of its own, built from a copy of
``csrc/`` whose chains with rows run on that many lanes
(``_rows_on_lanes``; the package runs them on a warp).  Prints each build's ptxas report, then one line per
model, chains and layout, tagged LABEL: ms, the fraction of chains
within 1e-4 relative of the first layout's (a width sums the rows in
another order), and whether the run has the bits of that width's first
(the chains a block leave a chain's arithmetic as it is).

``philox-split``: the register models with rows whose chains split
their Philox groups over their lanes (``PHILOX_MODELS``: the README
regression, the logistics, the mixture and the zoo's negative binomial,
or the models of ``tiles`` named after LABEL), at ``tiles``' shapes,
built as the tree stands and from a copy of ``csrc/`` whose such models
draw every group in every lane (``chip_smoke.EVERY_LANE_PHILOX``), in
the order A B B A.  Prints one line per model and build, tagged LABEL,
with whether its outputs are the first run's bits and ptxas's report
of the build's ``fused_hmc`` kernels.

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

``forms``: the kernels of the density forms the emitter took last
(``chip_smoke.py``'s latent GP at 64 inputs, 1024 chains × 25 iterations
of HMC(12), and at 256 inputs ("latent GP 256", L past the shared
memory, × 5 of HMC(12)); its MVNormal logistic at 32 features, × 100 of
HMC(5), from
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
passes' L staged in the block's shared memory and read in tiles of its
rows (emitted with a ``stage_budget`` of 0 bytes), in the order A B B A,
and the density alone at 576 states.  Prints one line per layout,
tagged LABEL, with whether its draws are the first layout's bit for bit
(both sum in one order).

``split``: the row loop's time split into its parts on five models of
``tiles`` (the 32-feature MVNormal logistic, the marginalized mixture,
the 100k logistic, the zoo's zero-inflated geometric and the README
regression, 1024 chains × SPLIT_ITERS iterations, the README the median
of SPLIT_REPS launches), each built from
a copy of ``csrc/`` with one part removed (``SPLIT_PARTS``: the tile fill
past the first two tiles, the rows, the butterflies or the lanes'
reduce-scatter, the tile loop's barriers, Philox and Box-Muller (the
momenta a constant), the scalar passes (``rt_logp_grad``,
``rt_rows_pre`` and ``rt_rows_post`` as constants of their types, the
rows' adjoints kept live), each constant one the compiler cannot see
through), or from a header whose rows' divisions by a value that is not
a literal are products (``HEADER_PARTS``, "no divisions": timing only),
each loop as its launch decides, in the order base, parts, parts
reversed, base.  The slot models (``SLOT_MODELS``: GLMMPoisson2 and
glmm_large, named after LABEL, apart from the others) are split into
``SLOT_SPLIT``'s parts instead: the passes over the chain's state, its
rows' row-invariant passes, the clears of its gathered adjoints, the
rows, their scatters and the warp barrier after each step, and, in a
tree whose scatters merge several steps, that merge (``SLOT_SPLIT_STEPS``).  The copies patch whichever tree the import finds
(the one before the row loop's redesign or a later one), as ``row-sums``
does.  Models named after LABEL (any model of ``tiles``, such as ``zoo
neg_binomial`` at HMC(4), the MVNormal logistic or the logistic in two
row spaces, each from the start ``tiles`` times it from) are split in
place of the three.  Prints one line per
model and build, tagged LABEL.

``tile-sizes``: the three models of ``split``, GLMMPoisson2 and
glmm_large (``TILE_SIZE_MODELS``, SPLIT_ITERS iterations) with tiles of
at most 256, 1024 and 4096 rows (``emit_cuda.TILE_ROWS_MAX`` replaced for
their emission; each takes the size rule's tile under it), in the order
256 1024 4096 4096 1024 256, each loop as its launch decides, each with
its density alone at CHECK_POINTS states.

``gather-steps``: the slot models (``SLOT_MODELS``: GLMMPoisson2 and
glmm_large, or those named after LABEL) with their rows over a slot in
device memory run 1, 2, 4 and 8 steps of 32 at once
(``emit_cuda.GATHER_STEP`` replaced for their emission), GLMMPoisson2 as
emitted (its slot in shared memory, one step) and with its slot in
device memory (``LOCAL_STATE_MAX`` 0 for its emission) at 1 and 4 steps,
each at TILE_ITERS iterations, in the order of ``GATHER_LAYOUTS`` and
back, with its density alone at CHECK_POINTS states.  Merged steps add
an entry's step sums before it, so the bits may differ from one step's:
each run prints its accept rate and whether it has the bits of the
first run in its memory.

``gather-paths``: the slot models (or those named after LABEL) built
from ``csrc/`` as it stands and from a copy without the scatter's paths
for indices that run in lane and row order (``GENERAL_PATHS``: every
step through ``__match_any_sync``, every merge through the loop over the
leaders), TILE_ITERS iterations, in the order A B B A, each held to the
first run's bits, with its density alone at CHECK_POINTS states.

``eadd-select``: the index column read whole (``chip_smoke.py``'s form,
3 entries, at 301 and 100,000 rows) with its adjoint sums as emitted
(``RT_EADD`` adding at the entry of a per-thread array) and as a select
over the entries (``EADD_SELECT``, a copy of ``csrc/rt_math.cuh``), the
density at 64 points against the plain version, and each build's PTX
(``rt.inspection.ptx``) and SASS (``cuobjdump -sass``) of the 301-row
model written to DIR (default ``profiles/eadd``, which git ignores).

``steps``: the kernels of the mixture, the zoo's negative binomial,
large Poisson and zero-inflated geometric, the README regression, the
100k logistic and the 32-feature MVNormal logistic (``STEP_MODELS``, at
TILE_ITERS iterations) with each lane summing 1, 2, 4 and 8 rows a step
(``emit_cuda.ROW_STEP`` replaced for their emission, whatever the row's
width and operations), in the order 1 2 4 8 8 4 2 1, each held to the first
run's bits; or only the models named after LABEL.

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

``counts``: the count likelihoods of the zoo (``COUNT_FAMILIES``: the
negative binomial, the large Poisson, the binomial, and the
zero-inflated geometric as the control), or the models named after
LABEL (zoo families by name, ``GLMMPoisson2``, ``glmm_large``): a zoo
family from its fit's final states, ε and Σ̂ (``Model.sample(kernel=
"fused!")`` as ``chip_smoke.py``'s zoo phase fits it, f64 warmup), 1024
chains × ``ZOO_PARITY_ITERS`` of HMC(4) as its ``zoo_parity`` runs them;
a GLMM as ``tiles`` runs it.  Each is built as the tree emits it; where
its rows call ``lgammaf``, with every ``lgammaf`` of its row functions
replaced by zero (the text so replaced: ``rt_row`` and ``rt_row_step``
only); where its rows leave their data-only terms to the pass once a
launch, with the rows keeping them (``_terms_in_rows``) and, for a
register model, from copies of ``csrc/`` that sum what the rows keep in
f64 every row, every 16 or 32 rows, or in f32 (``COUNT_SUMS``); timed in
the order A B ... B A, with ptxas's registers, and each build's density
alone at CHECK_POINTS of those states.  Prints one line per model,
build and order, tagged LABEL.

``row-sass``: the SASS of the row functions of each model named (zoo
families by name, default the four of ``counts`` and the README
regression, ``SASS_MODELS``: the 100k logistic, the MVNormal logistic
and the logistic in two row spaces, whose rows are Bernoulli-logit rows,
the marginalized mixture, whose row is a LogSumExp of two terms, and the
README regression, whose row divided by σ three times), compiled on
their own:
for each row space S a probe kernel that sums ``RtSpace<S>::row`` over a
lane's rows of a tile, one that sums ``RtSpace<S>::step`` over its steps
where the space sums several rows a step, and, where the header has
them, one that sums ``RtSpace<S>::row_const`` over the rows' columns,
each built with nvcc for sm_90a and read by ``cuobjdump -sass``.
Prints, for each probe, its instructions (and a step's a row), MUFU
operations by kind (EX2, LG2, RCP, ...), branches (BRA and CALL) and
FCHK (an IEEE division's test for its slow path), static counts of the
function, whose loop body is one row or step, or several rows where
nvcc unrolls it, plus the loop's own few instructions, tagged LABEL;
each model's SASS is written to ROW_SASS_DIR.

``row-loads``: the logistic regressions of ``SASS_MODELS`` (or the
models of ``tiles`` named after LABEL) with each row of w floats, w one
short of a multiple of 4, as emitted (w scalar shared-memory loads a
row) and padded to w + 1 floats and read as (w + 1) / 4 16-byte loads
(``_vector_loads``: the emitted text so replaced; lane l's row at a
stride of w + 1 floats, 8 lanes a phase without a bank conflict), at
TILE_ITERS iterations, in the order A B B A, each held to the first
run's bits, with ptxas's registers, and each build's density alone at
CHECK_POINTS states.

``lse-probe``: ``csrc/lse_probe.cu`` on the card: the shares of a
LogSumExp of two terms as the rows compute them (``rt_lse_pair_share``
over ``rt_recip``) against the IEEE f32 quotient, for every f32 e in
[0, 1], and the f64 form (``rt_lse_share``) beside them.  Prints how
many e differ for each, and the least and most of them, tagged LABEL.

``gp-split``: ``chip_smoke.py``'s latent GP at 256 inputs (1024 chains ×
5 iterations of HMC(12)) built as emitted and from headers with its
product passes reading a constant in place of L, with its scalar
likelihood terms removed (their straight-line code, or their lane
loop's count made 0), and with both (``GP_SPLIT``), in the order A B C D
D C B A from one scan-path warmup's states; ptxas's report of each
build's functions and each build's density alone at DENSITY_POINTS
states.  Runs on any tree since the GP's, as ``split`` does.  Prints
one line per build and order, tagged LABEL.

``gp-blocks``: the latent GP at 256 inputs (5 iterations of HMC(12))
with 4 and 8 chains a block, tiles of 32 and 64 rows of L, and L copied
and read 16 bytes at a time or 4 (``GP_BLOCKS``:
``fused_hmc.chains_per_block`` replaced for the run, as ``lanes`` does,
``emit_cuda.MAT_TILE_ROWS`` and ``MAT_VEC4`` for the emission), and at 64
inputs (L staged, 25 iterations) with 4 and 8, each order A B ... B A,
each run's final q summed (a tile's rows and the chains a block leave
the sums' order as it is, so the bits agree).  Prints one line per
build and order, tagged LABEL.

``kernel-sass``: each model named (a model of ``tiles``, or a form of
``forms`` as "form NAME") built as the tree the import finds emits it:
its library's SASS (``cuobjdump -sass``, addresses stripped) counted and
hashed, then its kernel timed twice, as ``tiles`` or ``forms`` times it.
Run with another checkout's root on PYTHONPATH and with this one's, A B
B A, it tells a kernel whose code two trees share (the same hash) from
one that moved.  Prints one line per model and run, tagged LABEL.

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
                "logistic regression", "zoo zero_inflated_geometric",
                "README regression")
SPLIT_ITERS = 20
# launches timed a build in ``split`` (others: 3): the README
# regression's 20 iterations take a few tenths of a millisecond
SPLIT_REPS = {"README regression": 20}
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


# the passes over a slot's state: (loop variable, count, what follows)
_STATE_PASSES = (
    ("k", "RT_GROUPS", " {\n        uint32_t w[4]"),
    ("d", "RT_DIM", " {\n    p[d] = p[d] + h * rt_gs(g, sc, d);"),
    ("d", "RT_DIM", " {\n    p[d] = p[d] + eps * rt_gs(gn, sc, d);"),
    ("d", "RT_DIM", " RT_PASS_ADD(k, d, p[d] * p[d]);"),
    ("d", "RT_DIM", " {\n    p[d] = p[d] + h * rt_gs(gn, sc, d);"),
    ("d", "RT_DIM", " {\n    q[d] = qn[d];"))
# a step's scatters over the workspace, and the warp barrier after them:
# before the slot's redesign (_SCATTER, _ROW_SYNC), and after it, one step
# and several at a time (_SCATTER_1, _SCATTER_K, each with its barrier)
_SCATTER = ("    for (int g = 0; g < RtGathers<S>::value; ++g)\n"
            "      rt_scatter(ainv, sidx[g], sval[g]);\n")
_ROW_SYNC = "    RT_WARP_SYNC();\n"
_SCATTER_1 = ("      rt_scatter(ainv, sidx[g], sval[g]);\n    }\n"
              "    RT_WARP_SYNC();\n")
_SCATTER_K = ("        rt_scatter_steps<kK, kG>(ainv, sidx, sval, g);\n"
              "      }\n      RT_WARP_SYNC();\n")


# a value the compiler cannot see through (the split's constants), so that
# a constant in place of a part folds nothing of what follows it
_OPAQUE = ('#include "philox.cuh"\n', '#include "philox.cuh"\n'
           '#ifdef __CUDA_ARCH__\n#define RT_OPAQUE(v, bits) '
           'asm volatile("mov.f32 %0, " #bits ";" : "=f"(v))\n#else\n'
           '#define RT_OPAQUE(v, bits) ((v) = 0.5f)\n#endif\n')
_PHILOX = ("        rt_philox4x32_10(w, seed, (uint32_t)c);\n"
           "#pragma unroll\n"
           "        for (int j = 0; j < 2; ++j) {\n"
           "          const int d = 2 * k + j;\n"
           "          if (d < RT_DIM)\n"
           "            p[d] = rt_box_muller(rt_uniform_from_bits(w[2 * j]),\n"
           "                                       rt_uniform_from_bits(w[2 * j + 1]));\n"
           "          else if (d == RT_DIM)\n"
           "            u = rt_uniform_from_bits(w[2 * j]);\n"
           "        }\n")
_PHILOX_CONST = ("        (void)w;\n"
                 "#pragma unroll\n"
                 "        for (int j = 0; j < 2; ++j) {\n"
                 "          const int d = 2 * k + j;\n"
                 "          if (d < RT_DIM)\n"
                 "            RT_OPAQUE(p[d], 0f3F000000);\n"
                 "          else if (d == RT_DIM)\n"
                 "            RT_OPAQUE(u, 0f3F000000);\n"
                 "        }\n")
_LANE_PHILOX = "      rt_lane_momenta(p, u, it, seed, (uint32_t)c);\n"
_LANE_PHILOX_CONST = ("#pragma unroll\n"
                      "      for (int d = 0; d < RT_DIM; ++d) "
                      "RT_OPAQUE(p[d], 0f3F000000);\n"
                      "      RT_OPAQUE(u, 0f3F000000);\n")


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
        [("    v[k] = k == 0 ? lp[0] : k < RT_ACC_N ? acc[k - 1] : 0.0;\n"
          "  rt_lane_sums<RT_LANES, RT_ACC_P, RT_ACC_N>(v, tot);\n",
          "    if (k < RT_ACC_N) tot[k] = k == 0 ? lp[0] : acc[k - 1];\n"),
         ("    tot[k] = rt_warp_sum<RT_LANES>(k == 0 ? lp[0] : acc[k - 1]);\n",
          "    tot[k] = k == 0 ? lp[0] : acc[k - 1];\n")],
        [("  const double lp_acc = rt_acc_sum(lp_lanes, 1, 0) + "
          "rt_consts_sum(rows);\n",
          "  const double lp_acc = lp_lanes[0] + rt_consts_sum(rows);\n"),
         ("  const double lp_acc = rt_acc_sum(lp_lanes, 1, 0);\n",
          "  const double lp_acc = lp_lanes[0];\n"),
         ("    ainv[k] = (float)rt_acc_sum(ainv_acc, RT_NINV_DENSE_ALLOC, k);\n",
          "    ainv[k] = (float)ainv_acc[k];\n")],
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
    # the parts of a slot model's density call and iteration (SLOT_SPLIT)
    "no state passes": [[(f"  RT_FOR({d}, {n}){rest}",
                          f"  RT_FOR({d}, 0){rest}")
                         for d, n, rest in _STATE_PASSES]],
    "no pre/post": [
        [("  rt_rows_pre(x, inv RT_WHOLE(cols) RT_SCR(scr));\n", ""),
         ("  rt_rows_post(x, ainv, g RT_WHOLE(cols) RT_SCR(scr));\n", "")]],
    "no clears": [[("  rt_gathered_zero(lanes, ainv);\n", "")]],
    "no scatters": [[(_SCATTER, _SCATTER.replace(
        "rt_scatter(ainv, sidx[g], sval[g])", "lp_t += 0.0f * sval[g]"))],
                    [(_SCATTER_1, _SCATTER_1.replace(
                        "rt_scatter(ainv, sidx[g], sval[g])",
                        "lp_t += 0.0f * sval[g]")),
                     (_SCATTER_K, _SCATTER_K.replace(
                         "rt_scatter_steps<kK, kG>(ainv, sidx, sval, g)",
                         "for (int j = 0; j < kK; ++j) "
                         "lp_t += 0.0f * sval[j * kG + g]"))]],
    "no merge": [[("  if (runs) {\n", "  if (false) {\n"),
                  ("  } else {\n#pragma unroll\n    for (int j = 1; j < kK;",
                   "  } else if (false) {\n#pragma unroll\n"
                   "    for (int j = 1; j < kK;")]],
    "no row syncs": [[(_SCATTER + _ROW_SYNC, _SCATTER)],
                     [(_SCATTER_1, _SCATTER_1.replace(_ROW_SYNC, "")),
                      (_SCATTER_K, _SCATTER_K.replace(
                          "      RT_WARP_SYNC();\n", ""))]],
    # the momenta and the uniform a constant, in place of Philox and
    # Box-Muller (every lane's draw, and the lanes' split draw)
    "no Philox": [[_OPAQUE, (_PHILOX, _PHILOX_CONST),
                   (_LANE_PHILOX, _LANE_PHILOX_CONST)]],
    # rt_logp_grad, rt_rows_pre and rt_rows_post as constants of their
    # types: lp 0 and g 0, every row-invariant value 1, and the rows'
    # adjoints kept live by a vanishing share of them in g
    "no scalar passes": [[
        _OPAQUE,
        ("  float lp = rt_logp_grad(x, g RT_WHOLE(cols) RT_SCR(scr));\n",
         "  float lp;\n  RT_OPAQUE(lp, 0f00000000);\n#pragma unroll\n"
         "  for (int d_ = 0; d_ < RT_DIM; ++d_) g[d_] = 0.0f;\n"),
        ("  rt_rows_pre(x, inv RT_WHOLE(cols) RT_SCR(scr));\n",
         "#pragma unroll\n  for (int k_ = 0; k_ < RT_NINV_ALLOC; ++k_)\n"
         "    RT_OPAQUE(inv[k_], 0f3F800000);\n"),
        ("  rt_rows_post(x, ainv, g RT_WHOLE(cols) RT_SCR(scr));\n",
         "#pragma unroll\n  for (int k_ = 0; k_ < RT_NINV; ++k_)\n"
         "    g[k_ % RT_DIM] += 1e-30f * ainv[k_];\n")]],
}
# ``split`` of a model whose chain state lies in a slot (SLOT_MODELS):
# the passes over the state (the momenta, kicks, drifts, p·p and the
# accept's copy), rt_rows_pre and rt_rows_post, the clears of the
# gathered adjoints, the rows, their scatters and the warp barrier after
# each step, each removed in a build of its own; the other models'
# parts are ROW_SPLIT
ROW_SPLIT = ("no fill", "no rows", "no butterfly", "no barriers",
             "no Philox", "no scalar passes", "no divisions")
SLOT_SPLIT = ("no state passes", "no pre/post", "no clears", "no rows",
              "no scatters", "no row syncs")
# after the slot's redesign, also the merge of several steps' scatters
# (rt_scatter_steps), removed where the tree has it
SLOT_SPLIT_STEPS = (*SLOT_SPLIT, "no merge")
SLOT_MODELS = ("GLMMPoisson2", "glmm_large")
# the five forms that ``forms`` times: (iterations, leapfrog steps) at
# PERF.md §6's shapes, the launches each timed over, and the scan-path
# warmup iterations of HMC(5) their states come from
FORM_RUNS = {"latent GP": (25, 12), "latent GP 256": (5, 12),
             "MVNormal logistic 32": (100, 5),
             "form index column read whole": (20, 4),
             "form vector per row": (20, 4),
             "form row-varying gather": (20, 4)}
FORM_REPS, FORM_WARMUP = 20, 100
# ``gather-tiles``: the rows of the row-varying gather's tiles, in order;
# ``gp-layouts``: the GP's layouts by the staging budget each is emitted
# with (None: the emitter's own), in order; both also time the density
# alone at DENSITY_POINTS states
GATHER_TILES = (256, 1024, 2048, 4096, 4096, 2048, 1024, 256)
GP_LAYOUTS = {"shared memory": None, "tiles": 0}
GP_ORDER = ("shared memory", "tiles", "tiles",
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
    ("#if defined(RT_WS_FLOATS) || defined(RT_ROW_CONSTS)\n"
     "  lp = (float)((double)lp + lp_acc);\n#else\n"
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


def _register_runs(device, want=("README regression", "logistic regression",
                                 "GLMMPoisson2")):
    """{name: (model, (q0, ε, Σ̂), iterations, leapfrog steps)} for the
    README regression, the 100k-row logistic regression and GLMMPoisson2
    at CHAINS chains, those of them in `want`."""
    import chip_smoke as cs
    import rainier_tpu_torch as rt

    runs = {}
    if "README regression" in want:
        readme = cs.readme_regression(rt)[0]
        runs["README regression"] = (readme, _warm(readme, CHAINS, device),
                                     1000, 5)
    if "logistic regression" in want:
        logit, x, ys = cs.logistic_regression(rt)
        runs["logistic regression"] = (logit, _laplace_start(
            cs.logistic_design(x), ys, CHAINS, device), 100, 5)
    if "GLMMPoisson2" in want:
        glmm = cs.glmm_poisson(rt)
        runs["GLMMPoisson2"] = (glmm, _warm(glmm, CHAINS, device), 1000, 5)
    return runs


def _row_runs(device, names=()):
    """{name: (model, (q0, ε, Σ̂), iterations, leapfrog steps)} for every
    model with rows that chip_smoke.py drives, or those of them `names`
    names: CHAINS chains and TILE_ITERS iterations of HMC(5), the 2M-row
    logistic CHAINS_2M chains and ITERS_2M of HMC(8)."""
    import chip_smoke as cs
    import rainier_tpu_torch as rt

    every = (*TILE_ITERS, "logistic regression 2M")
    want = set(names or every)
    unknown = want - set(every)
    if unknown:
        raise SystemExit(f"kernel_ab: no model {sorted(unknown)}")
    runs = {name: (model, start, TILE_ITERS[name], 5) for name, (
        model, start, _, _) in _register_runs(device, want).items()}
    if want & {"MVNormal logistic", "logistic regression, two row spaces"}:
        logit, x, ys = cs.logistic_regression(rt)
        start = _laplace_start(cs.logistic_design(x), ys, CHAINS, device)
    if "MVNormal logistic" in want:
        mv, alpha, betas = cs.mvnormal_logistic(rt, x, ys)
        runs["MVNormal logistic"] = (mv, _laplace_start(
            cs.mv_design(mv.density(), x, alpha, betas), ys, CHAINS,
            device), TILE_ITERS["MVNormal logistic"], 5)
    if "logistic regression, two row spaces" in want:
        runs["logistic regression, two row spaces"] = (
            cs.split_logistic(rt, x, ys), start,
            TILE_ITERS["logistic regression, two row spaces"], 5)
    if "glmm_large" in want:
        large = cs.glmm_large(rt)
        runs["glmm_large"] = (large, _warm(large, CHAINS, device),
                              TILE_ITERS["glmm_large"], 5)
    more = [n for n in want if n.startswith(
        ("MVNormal logistic 32", "marginalized", "zoo "))]
    for name, model in (_more_row_models(rt, cs, device, more).items()
                        if more else ()):
        runs[name] = (model, _start(model, name, device), TILE_ITERS[name],
                      TILE_STEPS.get(name, 5))
    if "logistic regression 2M" in want:
        logit2m, x2, ys2 = cs.logistic_regression(rt, ROWS_2M)
        runs["logistic regression 2M"] = (logit2m, _laplace_start(
            cs.logistic_design(x2), ys2, CHAINS_2M, device), ITERS_2M, 8)
    return {name: runs[name] for name in every if name in runs}


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


def _build(cd, n=CHAINS, csrc=None):
    """The kernel of a model with rows at the lanes a chain of the
    wrapper's rule for a launch over n chains, from the sources in `csrc`
    (default the package's; ``F.build``)."""
    from rainier_tpu_torch.compute import emit_cuda
    from rainier_tpu_torch.ops import fused_hmc as F

    lanes = F.lanes_per_chain(emit_cuda.emit(cd), n)
    return F.build(cd, lanes) if csrc is None else F.build(cd, lanes, csrc)


def _as_built(F, cd, build, n=CHAINS, csrc=None):
    """The build `build` (``F.build``'s, from the sources in `csrc`,
    default the package's) as the kernel that a launch of `cd` over n
    chains takes."""
    kernels, _, em = build
    F._BUILT[cd] = (F.CSRC if csrc is None else Path(csrc),
                    {F.lanes_per_chain(em, n): (kernels, em)})


def _build_runs(runs, csrc=None):
    """Every run's kernel at its chains' lanes, from the sources in
    `csrc` (default the package's), one nvcc each, all started
    together."""
    with ThreadPoolExecutor(len(runs)) as pool:
        list(pool.map(lambda run: _build(run[0].density(),
                                         run[1][0].shape[1], csrc),
                      runs.values()))


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
            _as_built(F, cd, built[name], q0.shape[1])
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
            cds = [run[0].density() for run in runs.values()]
            for cd in cds:
                F._BUILT.pop(cd, None)
            with ThreadPoolExecutor(len(cds)) as pool:
                for name, b in zip(runs, pool.map(
                        lambda cd, path=path: _build(cd, csrc=path), cds)):
                    built[label, name] = b
                    print(f"built {label}, {name}: {b[1]:.2f} s", flush=True)
    for name, run in runs.items():
        for label in ("f32 tiles", "f64 rows", "f64 rows", "f32 tiles"):
            _time_runs({name: run}, device, f"row-sums {label},",
                       {name: built[label, name]})


def _ptxas(log):
    """ptxas's report of each function of a build's `-Xptxas=-v` output
    that has one: its stack frame, spills and, for a kernel, registers
    (a device function with a report of its own is called, not
    inlined)."""
    import re

    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            out.append(f"{cur}: stack frame {m.group(1)} bytes, spill "
                       f"stores {m.group(2)}, loads {m.group(3)}")
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur and out and out[-1].startswith(cur):
            out[-1] += f", {m.group(1)} registers"
            cur = None
    return out


def tiles(label: str, names=()) -> None:
    import torch

    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device(DEVICE)
    runs = _row_runs(device, names)
    _build_runs(runs)
    if device.type == "cuda":
        for name, run in runs.items():
            kernels = _build(run[0].density(), run[1][0].shape[1])[0]
            for line in _ptxas(kernels.log):
                print(f"RESULT tiles {label} {name}: ptxas {line}",
                      flush=True)
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


def _variant_csrc(csrc, tmp, changes, name="fused_hmc.cu"):
    """A copy of the sources `csrc` in `tmp` with `changes` (SPLIT_PARTS'
    alternatives) applied to the source `name`: the first alternative
    whose texts the tree holds."""
    d = Path(tmp)
    shutil.copytree(csrc, d)
    src = (d / name).read_text()
    for alt in changes:
        if all(src.count(old) == 1 for old, _ in alt):
            for old, new in alt:
                src = src.replace(old, new)
            (d / name).write_text(src)
            return d
    raise RuntimeError(f"{name} holds none of {changes!r}")


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


def _row_mults(src):
    """The header `src` with every division of its row functions by a
    value that is not a literal a multiplication (timing only: the bits
    differ)."""
    import re

    out = src
    for head in _ROW_FUNCTIONS:
        at = out.find(head)
        while at >= 0:
            end = out.index("\n}\n", at)
            out = out[:at] + re.sub(r" / (?![-\d])", " * ",
                                    out[at:end]) + out[end:]
            at = out.find(head, end)
    return out


# ``split``'s parts that change the model's header, not ``csrc/``
HEADER_PARTS = {"no divisions": _row_mults}


def split(label: str, names=()) -> None:
    import dataclasses

    import torch

    from rainier_tpu_torch.compute import emit_cuda
    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device(DEVICE)
    names = tuple(names) or SPLIT_MODELS
    runs = _row_runs(device, names)
    models = {name: run[0] for name, run in runs.items()}
    starts = {name: run[1] for name, run in runs.items()}
    slot = set(names) <= set(SLOT_MODELS)
    if not slot and set(names) & set(SLOT_MODELS):
        raise SystemExit("kernel_ab split: the slot models "
                         f"{SLOT_MODELS} are split apart from the others")
    steps = "rt_scatter_steps" in (F.CSRC / "fused_hmc.cu").read_text()
    builds = ("base", *((SLOT_SPLIT_STEPS if steps else SLOT_SPLIT)
                        if slot else ROW_SPLIT))
    csrc = F.CSRC
    built = {}
    with tempfile.TemporaryDirectory() as tmp:
        for what in builds:
            path = csrc if what in ("base", *HEADER_PARTS) else \
                _variant_csrc(csrc, Path(tmp) / what.replace(" ", "_"),
                              SPLIT_PARTS[what])
            cds = [models[name].density() for name in names]
            ems = {cd: emit_cuda.emit(cd) for cd in cds}
            for cd in cds:
                F._BUILT.pop(cd, None)
                if what in HEADER_PARTS:
                    emit_cuda._EMITTED[cd] = dataclasses.replace(
                        ems[cd], source=HEADER_PARTS[what](ems[cd].source))
            try:
                with ThreadPoolExecutor(len(cds)) as pool:
                    for name, b in zip(names, pool.map(
                            lambda cd, path=path: _build(cd, csrc=path),
                            cds)):
                        built[what, name] = b
            finally:
                emit_cuda._EMITTED.update(ems)
    for name in names:
        cd = models[name].density()
        log = built["base", name][0].log
        print(f"RESULT split {label} {name}: ptxas " + " | ".join(
            line.split("ptxas info    : ")[-1].strip()
            for line in log.splitlines()
            if "registers" in line or "spill" in line), flush=True)
        for what in (*builds, *builds[::-1]):
            _as_built(F, cd, built[what, name])
            em = built[what, name][2]
            steps = TILE_STEPS.get(name, 5)
            out, ms, streamed = _run_kernel(F, cd, starts[name], SPLIT_ITERS,
                                            steps, device,
                                            SPLIT_REPS.get(name, 3))
            print(f"RESULT split {label} {name}, {what}: {CHAINS} chains x "
                  f"{SPLIT_ITERS} it x {steps} steps {ms:.3f} ms, tiles of "
                  f"{em.tile_rows} rows, "
                  f"{'streamed' if streamed else 'synchronous'}, accept "
                  f"{float(out[2].mean()):.4f}", flush=True)


# ``tile-sizes``: the models, and the most rows of a tile each is timed
# at, in order (each model's tile the size rule's under that most)
TILE_SIZE_MODELS = (*SPLIT_MODELS, "GLMMPoisson2", "glmm_large")
TILE_SIZES = (256, 1024, 4096, 4096, 1024, 256)


def tile_sizes(label: str, names=()) -> None:
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

    names = tuple(names) or TILE_SIZE_MODELS
    runs, starts = {}, {}
    for name in names:
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
    for name in names:
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


# ``gather-steps``: each slot model's layouts, (steps at once, the slot
# in shared memory where it fits), in order
GATHER_LAYOUTS = {"GLMMPoisson2": ((1, True), (1, False), (4, False)),
                  "glmm_large": ((1, False), (2, False), (4, False),
                                 (8, False))}


def gather_steps(label: str, names=()) -> None:
    import torch

    import chip_smoke as cs
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device(DEVICE)
    make = {"GLMMPoisson2": cs.glmm_poisson, "glmm_large": cs.glmm_large}
    names = tuple(names) or SLOT_MODELS
    runs, starts = {}, {}
    for name in names:
        for k, shared in GATHER_LAYOUTS[name]:
            model = make[name](rt)
            if name not in starts:
                starts[name] = _warm(model, CHAINS, device)
            _emit_as(model.density(), {
                "GATHER_STEP": k,
                **({} if shared else {"LOCAL_STATE_MAX": 0})})
            runs[name, k, shared] = (model, starts[name])
    _build_runs(runs)
    for name in names:
        order = GATHER_LAYOUTS[name]
        first = {}
        for k, shared in (*order, *order[::-1]):
            model, start = runs[name, k, shared]
            em = F.emit_cuda.emit(model.density())
            out, ms, streamed = _run_kernel(F, model.density(), start,
                                            TILE_ITERS[name], 5, device)
            out = [x if x is None else x.clone() for x in out]
            first.setdefault(em.shared, out)
            tag = (f"gather-steps {label} {name}, {k} steps at once, slot "
                   f"in {'shared' if em.shared else 'device'} memory")
            print(f"RESULT {tag}: {CHAINS} chains x {TILE_ITERS[name]} it "
                  f"{ms:.3f} ms, "
                  f"{'streamed' if streamed else 'synchronous'}, accept "
                  f"{float(out[2].mean()):.4f}, the bits of the first run "
                  f"in that memory {_same_bits(out, first[em.shared])}",
                  flush=True)
            _density_alone(model, _check_points(start[0]), device, tag)


# ``gather-paths``: the scatter without its paths for indices that run in
# lane order (rt_group_sum) and in row order (rt_scatter_steps)
GENERAL_PATHS = [[("  if (sorted || (__popc(down) == 1 && k31 < k0)) {\n",
                   "  if (false) {\n"),
                  ("  if (runs) {\n", "  if (false) {\n")]]


def gather_paths(label: str, names=()) -> None:
    import torch

    import chip_smoke as cs
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.compute import emit_cuda
    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device(DEVICE)
    make = {"GLMMPoisson2": cs.glmm_poisson, "glmm_large": cs.glmm_large}
    names = tuple(names) or SLOT_MODELS
    models = {name: make[name](rt) for name in names}
    starts = {name: _warm(m, CHAINS, device) for name, m in models.items()}
    builds, csrc, built = ("as built", "general paths"), F.CSRC, {}
    with tempfile.TemporaryDirectory() as tmp:
        for what in builds:
            path = csrc if what == builds[0] else _variant_csrc(
                csrc, Path(tmp) / "general", GENERAL_PATHS)
            cds = [models[name].density() for name in names]
            for cd in cds:
                F._BUILT.pop(cd, None)
            with ThreadPoolExecutor(len(cds)) as pool:
                for name, b in zip(names, pool.map(
                        lambda cd, path=path: _build(cd, csrc=path), cds)):
                    built[what, name] = b
    for name in names:
        cd, first = models[name].density(), None
        for what in (*builds, *builds[::-1]):
            _as_built(F, cd, built[what, name])
            out, ms, streamed = _run_kernel(F, cd, starts[name],
                                            TILE_ITERS[name], 5, device)
            out = [x if x is None else x.clone() for x in out]
            first = out if first is None else first
            tag = f"gather-paths {label} {name}, {what}"
            print(f"RESULT {tag}: {CHAINS} chains x {TILE_ITERS[name]} it "
                  f"{ms:.3f} ms, accept {float(out[2].mean()):.4f}, the "
                  f"bits of the first run {_same_bits(out, first)}",
                  flush=True)
            _density_alone(models[name], _check_points(starts[name][0]),
                           device, tag)


# ``eadd-select``: the index column's adjoint sums by entry as a select
# over the entries, on the card and in host code (csrc/rt_math.cuh)
EADD_SELECT = [[
    ("#define RT_EADD(name, k, i, j, v) name[j] += (v)\n",
     "#define RT_EADD(name, k, i, j, v) \\\n"
     "  _Pragma(\"unroll\") for (int e_ = 0; e_ < (k); ++e_) \\\n"
     "    name[e_] += e_ == (j) ? (double)(v) : 0.0\n"),
    ("#define RT_EADD(name, k, i, j, v) name##_l[(i) % RT_LANES][j] += (v)\n",
     "#define RT_EADD(name, k, i, j, v) \\\n"
     "  for (int e_ = 0; e_ < (k); ++e_) \\\n"
     "    name##_l[(i) % RT_LANES][e_] += e_ == (j) ? (double)(v) : 0.0\n")]]
EADD_ROWS, EADD_POINTS = (301, 100_000), 64


def eadd_select(label: str, out_dir: str = "profiles/eadd") -> None:
    import subprocess

    import torch

    import chip_smoke as cs
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device(DEVICE)
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    csrc = F.CSRC
    with tempfile.TemporaryDirectory() as tmp:
        for what in ("as emitted", "select"):
            path = csrc if what == "as emitted" else _variant_csrc(
                csrc, Path(tmp) / "select", EADD_SELECT, "rt_math.cuh")
            for rows in EADD_ROWS:
                cs.FORM_ROWS, cs.FORM_GROUPS = rows, 3
                model = cs.form_models(rt)["index column read whole"][0]
                cd = model.density()
                kernels = _build(cd, csrc=path)[0]
                q = torch.as_tensor(np.random.default_rng(0).normal(
                    size=(cd.n_vars, EADD_POINTS)), dtype=torch.float32,
                    device=device)
                lp, g = F.logp_grad(cd, q)
                lpp, gp = F.logp_grad_reference(cd, q)
                print(f"RESULT eadd-select {label} {what}, {rows} rows: max "
                      f"|dlp| {float((lp - lpp).abs().max()):.3e}, max |dg| "
                      f"/ max |g| "
                      f"{float((g - gp).abs().max() / gp.abs().max()):.3e}; "
                      f"g of point 0 {g[:, 0].tolist()}, plain "
                      f"{gp[:, 0].tolist()}", flush=True)
                if rows != EADD_ROWS[0]:
                    continue
                stem = Path(out_dir) / f"eadd_{what.replace(' ', '_')}"
                stem.with_suffix(".ptx").write_text(
                    rt.inspection.ptx(model, csrc=path))
                stem.with_suffix(".sass").write_text(subprocess.run(
                    [str(Path(F._nvcc()).parent / "cuobjdump"), "-sass",
                     kernels.path], capture_output=True,
                    text=True).stdout)


# ``steps``: the models and the rows a step each is timed at, in order
STEP_MODELS = ("marginalized mixture", "zoo neg_binomial",
               "zoo large_poisson", "zoo zero_inflated_geometric",
               "README regression", "logistic regression",
               "MVNormal logistic 32")
STEP_ORDER = (1, 2, 4, 8, 8, 4, 2, 1)


def steps(label: str, names=()) -> None:
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

    names = tuple(names) or STEP_MODELS
    runs = {}
    for name in names:
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
    for name in names:
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


def lse_pair_probe():
    """csrc/lse_probe.cu built (nvcc, a plain C interface, cached by
    content hash like the kernel) and run once on the card: ({"e / s",
    "1 / s", "f64 e / s"}: (values of e in [0, 1] whose bits differ from
    the IEEE quotient's, the least such e, the most), ms of the launch)."""
    import ctypes
    import hashlib
    import subprocess

    import torch

    from rainier_tpu_torch.ops import fused_hmc as F

    h = hashlib.sha256()
    for name in ("lse_probe.cu", "rt_math.cuh"):
        h.update((F.CSRC / name).read_bytes())
    so = F.BUILD_DIR / f"lse_probe_{h.hexdigest()[:24]}.so"
    if not so.exists():
        F.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f".{so.name}.{os.getpid()}")
        subprocess.run([F._nvcc(), *F.NVCC_FLAGS[:-1], "-I", str(F.CSRC),
                        "-o", str(tmp), str(F.CSRC / "lse_probe.cu")],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    fn = ctypes.CDLL(str(so)).rt_lse_probe_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p] * 2, ctypes.c_int
    out = torch.empty(9, dtype=torch.int32, device="cuda")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    rc = fn(out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    end.record()
    if rc != 0:
        raise RuntimeError(f"lse probe launch failed: cudaError {rc}")
    torch.cuda.synchronize()
    v = [int(x) & 0xFFFFFFFF for x in out.cpu().tolist()]

    def e_of(bits):
        return float(np.array([bits], dtype=np.uint32).view(np.float32)[0])

    return ({what: (v[k], e_of(v[3 + k]) if v[k] else None,
                    e_of(v[6 + k]) if v[k] else None)
             for k, what in enumerate(("e / s", "1 / s", "f64 e / s"))},
            start.elapsed_time(end))


def lse_probe(label: str) -> None:
    counts, ms = lse_pair_probe()
    for what, (n, lo, hi) in counts.items():
        print(f"RESULT lse-probe {label} {what}: {n} of the 1065353217 f32 e "
              f"in [0, 1] differ from the IEEE quotient (least e {lo}, most "
              f"{hi}); the probe {ms:.3f} ms", flush=True)


# ``gp-split``: the latent GP at 256 inputs (FORM_RUNS "latent GP 256")
# built as emitted and from headers with (a) its product passes reading a
# constant in place of L, (b) its scalar likelihood terms removed, (c)
# both (_gp_parts), in the order base a b c c b a base
GP_SPLIT = ("base", "constant L", "no scalar terms", "both")


def _constant_l(src):
    """The header `src` with every RT_MAT<c> read of L a constant (four
    at a time where the tiles are read so)."""
    import re

    src = re.sub(r"#define (RT_MAT\d+_4)\(r, j\) .*",
                 r"#define \1(r, j) rt_f4{0.0625f, 0.0625f, 0.0625f, "
                 r"0.0625f}", src)
    return re.sub(r"#define (RT_MAT\d+(?:_T)?)\(r, j\) .*",
                  r"#define \1(r, j) 0.0625f", src)


def _without_terms(src):
    """The header `src` with the scalar likelihood terms of rt_logp_grad
    removed: as straight-line code, every top-level value of the function
    other than a loop's sum, its adjoint and every line that reads them;
    as a lane loop (the terms grouped), that loop's count made 0."""
    import re

    if "// the scalar terms of " in src:
        return re.sub(r"(// the scalar terms of [^\n]*\n(?:[^\n]*\n)*?"
                      r"\s*for \(int i = RT_LANE; i < )\d+", r"\g<1>0", src)
    head = src.index("RT_HD float rt_logp_grad(")
    end = src.index("  return lp;\n}", head)
    body = src[head:end].split("\n")
    gone = {m.group(1) for line in body for m in [re.match(
        r"  const float v(\d+) = (?!\(float\)r\d+;)", line)] if m}
    ref = re.compile(r"\b[va](" + "|".join(sorted(gone)) + r")\b")
    out = []
    for line in body:
        if line.startswith("  const float lp = "):
            terms = [t for t in line[len("  const float lp = "):-1].split(
                " + ") if not ref.fullmatch(t)]
            out.append("  const float lp = " + (" + ".join(terms) or "0.0f")
                       + ";")
        elif not (line.startswith("  ") and not line.startswith("   ")
                  and ref.search(line)):
            out.append(line)
    return src[:head] + "\n".join(out) + src[end:]


def gp_split(label: str) -> None:
    import dataclasses

    import torch

    from rainier_tpu_torch.compute import emit_cuda
    from rainier_tpu_torch.ops import fused_hmc as F

    import chip_smoke as cs
    import rainier_tpu_torch as rt

    device = torch.device(DEVICE)
    name = "latent GP 256"
    models = {what: cs.latent_gp(rt, cs.GP_WIDE_INPUTS)[0]
              for what in GP_SPLIT}
    start = _warm(models["base"], CHAINS, device, FORM_WARMUP)
    parts = {"base": (), "constant L": (_constant_l,),
             "no scalar terms": (_without_terms,),
             "both": (_constant_l, _without_terms)}
    runs = {}
    for what, model in models.items():
        cd = model.density()
        em = emit_cuda.emit(cd)
        src = em.source
        for f in parts[what]:
            src = f(src)
        emit_cuda._EMITTED[cd] = dataclasses.replace(em, source=src)
        runs[what] = (model, start, *FORM_RUNS[name])
    _build_runs(runs)
    q = start[0][:, :DENSITY_POINTS].contiguous()
    for what, (model, *_rest) in runs.items():
        print(f"RESULT gp-split {label} {what}: ptxas " + " | ".join(
            _ptxas(F.build(model.density(), emit_cuda.LANES)[0].log)),
            flush=True)
    for what in (*GP_SPLIT, *GP_SPLIT[::-1]):
        _time_runs({name: runs[what]}, device, f"gp-split {label} {what},",
                   reps=FORM_REPS)
    for what in GP_SPLIT:
        _density_alone(runs[what][0], q, device, f"gp-split {label} {what}")


# ``gp-blocks``: the latent GP at 256 inputs with W chains a block, tiles
# of T rows of L and L copied and read 16 bytes at a time or not ((W, T,
# 16-byte) in order, A B C D D C B A), and at 64 inputs (L staged) with W
# chains a block
GP_BLOCKS = ((8, 64, False), (8, 64, True), (4, 32, False), (8, 32, True))
GP64_BLOCKS = (4, 8, 8, 4)


def gp_blocks(label: str) -> None:
    import torch

    import chip_smoke as cs
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device(DEVICE)
    wide = {(t, v): cs.latent_gp(rt, cs.GP_WIDE_INPUTS)[0]
            for _, t, v in GP_BLOCKS}
    start = _warm(next(iter(wide.values())), CHAINS, device, FORM_WARMUP)
    for (t, v), model in wide.items():
        _emit_as(model.density(), {"MAT_TILE_ROWS": t, "MAT_VEC4": v})
    gp = cs.latent_gp(rt)[0]
    runs = {**{key: (model, start, *FORM_RUNS["latent GP 256"])
               for key, model in wide.items()},
            "64": (gp, _warm(gp, CHAINS, device, FORM_WARMUP),
                   *FORM_RUNS["latent GP"])}
    _build_runs(runs)
    rule = F.chains_per_block
    try:
        for w, t, v in (*GP_BLOCKS, *GP_BLOCKS[::-1],
                        *((w, None, None) for w in GP64_BLOCKS)):
            F.chains_per_block = lambda em, n, w=w: w
            what = f"latent GP {'64' if t is None else 256}, W={w}" + (
                f", tiles of {t} rows{', 16-byte' if v else ''}" if t
                else "")
            out = _time_runs({what: runs["64" if t is None else (t, v)]},
                             device, f"gp-blocks {label}", reps=FORM_REPS)
            print(f"RESULT gp-blocks {label} {what}: final q sum "
                  f"{float(out[0].double().sum())!r}", flush=True)
    finally:
        F.chains_per_block = rule


def kernel_sass(label: str, names=()) -> None:
    import hashlib
    import re
    import subprocess

    import torch

    import chip_smoke as cs
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device(DEVICE)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in names:
        if name.startswith("form "):
            model = cs.form_models(rt)[name[len("form "):]][0]
            run = (model, _warm(model, CHAINS, device, FORM_WARMUP),
                   *FORM_RUNS[name])
        else:
            run = _row_runs(device, (name,))[name]
        _build(run[0].density())
        so = max(F.BUILD_DIR.glob("fused_hmc_*.so"),
                 key=lambda path: path.stat().st_mtime)
        sass = subprocess.run([cuobjdump, "-sass", str(so)], check=True,
                              capture_output=True, text=True).stdout
        body = [re.sub(r"/\*[0-9a-f]+\*/", "", line).strip()
                for line in sass.splitlines()
                if re.search(r"/\*[0-9a-f]{4,}\*/", line)]
        print(f"RESULT kernel-sass {label} {name}: {len(body)} SASS lines, "
              f"hash {hashlib.sha256(chr(10).join(body).encode()).hexdigest()[:16]}",
              flush=True)
        for _ in range(2):
            _time_runs({name: run}, device, f"kernel-sass {label}",
                       reps=FORM_REPS)


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


# ``counts``: the zoo's count likelihoods, in order, and the builds each
# is timed as: the tree's emission, and the same text with every lgammaf
# of its row functions replaced by zero (where they call any); and, on a
# tree that sums the rows left by their data-only terms in f64 every
# RT_ROW_GROUP rows, copies of csrc/ that sum them in f64 every row and
# in f32 (COUNT_SUMS: the text of fused_hmc.cu replaced)
COUNT_FAMILIES = ("neg_binomial", "large_poisson", "binomial",
                  "zero_inflated_geometric")
COUNT_BUILDS = ("as emitted", "row lgammaf zeroed", "terms in the rows")
COUNT_SUMS = {
    "rows in f64 every row": [[("#define RT_ROW_GROUP 8\n",
                                "#define RT_ROW_GROUP 1\n")]],
    "rows in f64 every 16 rows": [[("#define RT_ROW_GROUP 8\n",
                                    "#define RT_ROW_GROUP 16\n")]],
    "rows in f64 every 32 rows": [[("#define RT_ROW_GROUP 8\n",
                                    "#define RT_ROW_GROUP 32\n")]],
    "rows in f32": [[("#ifdef RT_ROW_CONSTS\ntypedef double rt_row_sum;\n",
                      "#ifdef RT_ROW_CONSTS\ntypedef float rt_row_sum;\n")]]}
_ROW_FUNCTIONS = ("RT_HD float rt_row(", "RT_HD void rt_row_step(")


def _rows_without_lgamma(src):
    """The header `src` with every ``lgammaf(`` of its row functions (a
    header of one row space: rt_row and rt_row_step) replaced by
    ``0.0f * (``: the row's value without the terms, at the cost of a
    multiply."""
    out, inside = [], False
    for line in src.split("\n"):
        inside = inside or line.startswith(_ROW_FUNCTIONS)
        out.append(line.replace("lgammaf(", "0.0f * (") if inside else line)
        inside = inside and line != "}"
    return "\n".join(out)


def _zoo_fit_start(model, device):
    """(final q (dim, n), ε (n,), Σ̂ (n, dim)) of `model` (a zoo family's)
    fitted as chip_smoke.py's zoo phase fits it: Model.sample(kernel=
    "fused!") at CHAINS chains, ZOO_WARMUP f64 warmup + ZOO_DRAWS draws of
    HMC(ZOO_STEPS), seed 0."""
    import torch

    import chip_smoke as cs
    from rainier_tpu_torch.sampler import HMC, SamplerConfig

    cfg = SamplerConfig(cs.ZOO_WARMUP, cs.ZOO_DRAWS,
                        sampler=HMC(cs.ZOO_STEPS))
    tr = model.sample(cfg, n_chains=CHAINS, seed=0, kernel="fused!",
                      device=device, dtype=torch.float64)
    return (torch.as_tensor(tr.final_q.T.copy(), dtype=torch.float32,
                            device=device),
            torch.as_tensor(tr.step_size, dtype=torch.float32,
                            device=device),
            torch.as_tensor(tr.mass.diag, dtype=torch.float32,
                            device=device))


def _terms_in_rows(cd):
    """Emit `cd` with its rows keeping their data-only terms, as before
    the pass once a launch took them (the plain version keeps its own
    roots); False on a tree whose row spaces list no such terms."""
    from rainier_tpu_torch.compute import emit_cuda

    split = cd.row_split()
    if not any(getattr(sp, "consts", ()) for sp in split.spaces):
        return False
    cd._row_split = split._replace(spaces=tuple(
        sp._replace(consts=(), kept=()) for sp in split.spaces))
    emit_cuda.emit(cd, emit_cuda.SMEM_BYTES_MAX)
    return True


def _count_run(rt, cs, name, device):
    """(model, build(), iterations, leapfrog steps) of a model ``counts``
    times: a zoo family from its fit's final states, GLMMPoisson2 and
    glmm_large from TILE_ITERS' warmup, as ``tiles`` times them."""
    if name == "GLMMPoisson2":
        return (cs.glmm_poisson(rt), lambda m: _warm(m, CHAINS, device),
                TILE_ITERS[name], 5)
    if name == "glmm_large":
        return (cs.glmm_large(rt), lambda m: _warm(m, CHAINS, device),
                TILE_ITERS[name], 5)
    key = f"zoo {name}"
    return (_more_row_models(rt, cs, device, [key])[key],
            lambda m: _zoo_fit_start(m, device), cs.ZOO_PARITY_ITERS,
            cs.ZOO_STEPS)


def counts(label: str, names=()) -> None:
    import dataclasses

    import torch

    import chip_smoke as cs
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.compute import emit_cuda
    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device(DEVICE)
    names = tuple(names) or COUNT_FAMILIES
    src = (F.CSRC / "fused_hmc.cu").read_text()
    sums = [what for what, alts in COUNT_SUMS.items()
            if all(src.count(old) == 1 for old, _ in alts[0])]
    runs, shapes = {}, {}
    for name in names:
        for what in (*COUNT_BUILDS, *sums):
            model, start, n_it, n_steps = _count_run(rt, cs, name, device)
            shapes[name] = (start, n_it, n_steps)
            cd = model.density()
            if what == COUNT_BUILDS[2]:
                if not _terms_in_rows(cd):
                    continue
            em = emit_cuda.emit(cd)
            if what == COUNT_BUILDS[1]:
                if not _rows_lgamma(em.source):
                    continue
                emit_cuda._EMITTED[cd] = dataclasses.replace(
                    em, source=_rows_without_lgamma(em.source))
            if what in sums and (em.workspace or "RT_ROW_CONSTS" not in
                                 em.source):
                continue
            runs[name, what] = (model, None)
    csrc = F.CSRC
    with tempfile.TemporaryDirectory() as tmp:
        for what in (None, *sums):
            path = csrc if what is None else _variant_csrc(
                csrc, Path(tmp) / what.replace(" ", "_"), COUNT_SUMS[what])
            group = {key: run for key, run in runs.items()
                     if key[1] == what or what is None
                     and key[1] not in sums}
            if group:
                _build_runs(group, path)
    for name in names:
        first, n_it, n_steps = shapes[name]
        start = first(runs[name, COUNT_BUILDS[0]][0])
        builds = [what for what in (*COUNT_BUILDS, *sums)
                  if (name, what) in runs]
        for what in builds:
            model = runs[name, what][0]
            em = emit_cuda.emit(model.density())
            log = F.build(model.density(), emit_cuda.LANES)[0].log
            print(f"RESULT counts {label} {name}, {what}: row "
                  f"{em.row_ops} operations, lgammaf in the row functions "
                  f"{_rows_lgamma(em.source)}; ptxas " + " | ".join(
                      line.split("ptxas info    : ")[-1].strip()
                      for line in log.splitlines()
                      if "registers" in line or "spill" in line),
                  flush=True)
        for what in (*builds, *builds[::-1]):
            model = runs[name, what][0]
            out, ms, streamed = _run_kernel(F, model.density(), start, n_it,
                                            n_steps, device)
            print(f"RESULT counts {label} {name}, {what}: {CHAINS} chains "
                  f"x {n_it} it x {n_steps} steps {ms:.3f} ms, "
                  f"{'streamed' if streamed else 'synchronous'}, accept "
                  f"{float(out[2].mean()):.4f}", flush=True)
        for what in builds:
            _density_alone(runs[name, what][0], _check_points(start[0]),
                           device, f"counts {label} {name}, {what}")


def _rows_lgamma(src):
    """The calls of lgammaf in the row functions of the header `src`."""
    return _rows_without_lgamma(src).count("0.0f * (") - src.count(
        "0.0f * (")


# ``row-sass``: the probe kernels, compiled with the tree's fused_hmc.cu
# and the model's header (a register model whose rows take no columns and
# no chain state: the zoo's, the logistic regressions'): for each row
# space S, one that sums RtSpace<S>::row over a lane's rows, one that sums
# RtSpace<S>::step over its steps where the space has them, and, where
# the header has them, one that sums the rows' data-only terms
_PROBE_HEAD = '#include "fused_hmc.cu"\n'
_PROBE_ROW = """
extern "C" __global__ void rt_row_probe_s{s}(const float* x,
                                            const float* inv, float* ainv,
                                            float* out, int n) {{
  typedef RtSpace<{s}> Sp;
  float s = 0.0f;
  for (int i = (int)threadIdx.x; i < n; i += 32)
    s += Sp::row(x + (size_t)i * Sp::kW, inv, ainv);
  out[threadIdx.x] = s;
}}
"""
_PROBE_STEP = """
extern "C" __global__ void rt_step_probe_s{s}(const float* x,
                                             const float* inv, float* ainv,
                                             float* out, int n) {{
  typedef RtSpace<{s}> Sp;
  float s = 0.0f;
  for (int i = (int)threadIdx.x; i < n; i += 32 * Sp::kStep) {{
    float o[Sp::kStep];
    Sp::step(x + (size_t)i * Sp::kW, 32 * Sp::kW, inv, ainv, o);
#pragma unroll
    for (int k = 0; k < Sp::kStep; ++k) s += o[k];
  }}
  out[threadIdx.x] = s;
}}
"""
_PROBE_CONST = """
#ifdef RT_ROW_CONSTS
extern "C" __global__ void rt_row_const_probe_s{s}(RtCols cols, int n,
                                                  float* out) {{
  float s = 0.0f;
  for (int i = (int)threadIdx.x; i < n; i += 32)
    s += RtSpace<{s}>::row_const(cols, i);
  out[threadIdx.x] = s;
}}
#endif
"""
# the models ``row-sass`` probes beside the zoo's families: the
# Bernoulli-logit rows of chip_smoke.py's logistic regressions
SASS_MODELS = ("logistic regression", "MVNormal logistic",
               "logistic regression, two row spaces")


def _space_steps(em):
    """The rows a lane's step sums in each row space of `em` (its
    header's RT_ROW_STEP, or each RtSpace<s>'s kStep)."""
    import re

    if len(em.spaces) == 1:
        m = re.search(r"#define RT_ROW_STEP (\d+)", em.source)
        return [int(m.group(1)) if m else 1]
    return [int(k) for k in re.findall(
        r"struct RtSpace<\d+> \{\n  enum \{[^}]*kStep = (\d+)", em.source)]


def _probe_source(em):
    """The probe kernels' source for the header of `em`."""
    out = [_PROBE_HEAD]
    for s, step in enumerate(_space_steps(em)):
        out.append(_PROBE_ROW.format(s=s))
        if step > 1:
            out.append(_PROBE_STEP.format(s=s))
        out.append(_PROBE_CONST.format(s=s))
    return "".join(out)


def _sass_counts(sass):
    """{function: (instructions, {MUFU kind: count}, BRA, CALL, FCHK)} of
    ``cuobjdump -sass`` output, NOPs not counted (FCHK: an IEEE f32
    division's test for its slow path)."""
    import re

    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = [0, {}, 0, 0, 0]
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                      line)
        if name is None or m is None or m.group(1).startswith("NOP"):
            continue
        op = m.group(1)
        rec = out[name]
        rec[0] += 1
        if op.startswith("MUFU"):
            rec[1][op] = rec[1].get(op, 0) + 1
        rec[2] += op.startswith("BRA")
        rec[3] += op.startswith("CALL")
        rec[4] += op.startswith("FCHK")
    return {k: tuple(v) for k, v in out.items()}


def _sass_models(rt, cs, device, names):
    """{name: model} of ``row-sass``'s names: zoo families by name, the
    models of SASS_MODELS, the marginalized mixture and the README
    regression by theirs."""
    zoo = [n for n in names if n not in SASS_MODELS
           and n not in ("marginalized mixture", "README regression")]
    out = {n: m for n, m in ((n, _more_row_models(
        rt, cs, device, [f"zoo {n}"])[f"zoo {n}"]) for n in zoo)}
    if set(names) & set(SASS_MODELS):
        logit, x, ys = cs.logistic_regression(rt)
        out.update({"logistic regression": logit,
                    "MVNormal logistic": cs.mvnormal_logistic(rt, x, ys)[0],
                    "logistic regression, two row spaces":
                        cs.split_logistic(rt, x, ys)})
    if "marginalized mixture" in names:
        out["marginalized mixture"] = cs.marginal_mixture(rt)[0]
    if "README regression" in names:
        out["README regression"] = cs.readme_regression(rt)[0]
    return {n: out[n] for n in names}


# where ``row-sass`` writes each model's probe SASS (git ignores it)
ROW_SASS_DIR = "profiles/row_sass"


def row_sass(label: str, names=()) -> None:
    import subprocess

    import torch

    import chip_smoke as cs
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.compute import emit_cuda
    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device(DEVICE)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    models = _sass_models(rt, cs, device, tuple(names) or (
        *COUNT_FAMILIES, "README regression"))
    for name, model in models.items():
        em = emit_cuda.emit(model.density())
        if em.workspace or not em.spaces or any(
                d in em.source for d in ("RT_ROW_COLS", "RT_ROW_STATE")):
            print(f"RESULT row-sass {label} {name}: not a register model "
                  "whose rows read only their tile, no probe", flush=True)
            continue
        with tempfile.TemporaryDirectory() as tmp:
            d = Path(tmp)
            (d / emit_cuda.HEADER_NAME).write_text(em.source)
            (d / "probe.cu").write_text(_probe_source(em))
            subprocess.run(
                [F._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-cubin", "-I", str(d), "-I",
                 str(F.CSRC), "-o", str(d / "probe.cubin"),
                 str(d / "probe.cu")], check=True, capture_output=True)
            sass = subprocess.run([cuobjdump, "-sass",
                                   str(d / "probe.cubin")], check=True,
                                  capture_output=True, text=True).stdout
        out = Path(ROW_SASS_DIR) / f"{name.replace(' ', '_')}.sass"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(sass)
        steps = _space_steps(em)
        for fn, (n, mufu, bra, call, fchk) in sorted(
                _sass_counts(sass).items()):
            if "probe" not in fn:
                continue
            s = int(fn.rsplit("_s", 1)[1])
            sp = em.spaces[s]
            rows = steps[s] if fn.startswith("rt_step_probe") else 1
            print(f"RESULT row-sass {label} {name}, {fn}: {n} instructions"
                  f" ({n / rows:.1f} a row over {rows} row"
                  f"{'s' if rows > 1 else ''}), MUFU {sum(mufu.values())} "
                  f"{mufu}, BRA {bra}, CALL {call}, FCHK {fchk} (row "
                  f"{sp.row_ops} operations as emitted)", flush=True)


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
    forms of FORM_RUNS at CHAINS chains."""
    import chip_smoke as cs
    import rainier_tpu_torch as rt

    gp = cs.latent_gp(rt)[0]
    gpw = cs.latent_gp(rt, cs.GP_WIDE_INPUTS)[0]
    _, x, ys = cs.logistic_regression(rt, p=cs.MV32_FEATURES)
    mv, alpha, betas = cs.mvnormal_logistic(rt, x, ys)
    starts = {"latent GP": (gp, _warm(gp, CHAINS, device, FORM_WARMUP)),
              "latent GP 256": (gpw, _warm(gpw, CHAINS, device,
                                           FORM_WARMUP)),
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


def _vector_loads(src):
    """The header `src` with each space's rows of w floats, w one short
    of a multiple of 4, padded to w + 1 floats, and its row and step
    functions reading each row as (w + 1) / 4 float4 loads in place of w
    scalar ones (the tile loader, its copies unchanged, puts each row at
    the wider stride).  Spaces of other widths are left as they are."""
    import re

    def loads(name, ptr, w):
        return "".join(
            f"  const float4 {name}_{j} = reinterpret_cast<const float4*>"
            f"({ptr})[{j}];\n" for j in range((w + 1) // 4))

    def rows_of(text, w):
        text = re.sub(r"\bx\[(\d+)\]", lambda m: "x4_{}.{}".format(
            int(m.group(1)) // 4, "xyzw"[int(m.group(1)) % 4]), text)
        text = re.sub(r"\bx_R(\d+)\[(\d+)\]", lambda m: "x4R{}_{}.{}".format(
            m.group(1), int(m.group(2)) // 4, "xyzw"[int(m.group(2)) % 4]),
            text)
        text = re.sub(r"(float rt_row\(|float row\()([^{]*\{\n)",
                      lambda m: m.group(0) + loads("x4", "x", w), text)
        return re.sub(r"(  const float\* x_R(\d+) = x \+ \2 \* stride;\n)",
                      lambda m: m.group(1) + loads(f"x4R{m.group(2)}",
                                                   f"x_R{m.group(2)}", w),
                      text)

    one = re.search(r"#define RT_ROW_W (\d+)\n", src)
    if "#define RT_SPACES" not in src:
        w = int(one.group(1))
        if w % 4 != 3:
            return src
        src = src.replace(one.group(0), f"#define RT_ROW_W {w + 1}\n")
        head = src.index("RT_HD float rt_row(")
        end = src.index("RT_HD void rt_fill_tile(")
        return src[:head] + rows_of(src[head:end], w) + src[end:]
    out, widest = [], 0
    parts = re.split(r"(?=\n// row space \d+: )", src)
    for part in parts:
        m = re.search(r"enum \{ kW = (\d+),", part)
        w = int(m.group(1)) if m else 0
        if m and w % 4 == 3:
            part = part.replace(m.group(0), f"enum {{ kW = {w + 1},")
            fill = part.index("static RT_HD void fill(")
            part = rows_of(part[:fill], w) + re.sub(
                rf"\* {w} \+", f"* {w + 1} +", part[fill:])
            w += 1
        widest = max(widest, w)
        out.append(part)
    src = "".join(out)
    return re.sub(r"#define RT_ROW_W \d+\n", f"#define RT_ROW_W {widest}\n",
                  src)


def row_loads(label: str, names=()) -> None:
    import dataclasses

    import torch

    from rainier_tpu_torch.compute import emit_cuda
    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device(DEVICE)
    builds = ("as emitted", "16-byte loads")
    runs = {}
    for what in builds:
        for name, (model, start, n_it, n_steps) in _row_runs(
                device, tuple(names) or SASS_MODELS).items():
            cd = model.density()
            em = emit_cuda.emit(cd)
            if what != builds[0]:
                emit_cuda._EMITTED[cd] = dataclasses.replace(
                    em, source=_vector_loads(em.source))
            runs[name, what] = (model, start, n_it, n_steps)
    _build_runs(runs)
    for (name, what), (model, *_rest) in runs.items():
        regs = [line for line in _ptxas(F.build(
            model.density(), emit_cuda.LANES)[0].log) if "fused_hmc" in line]
        print(f"RESULT row-loads {label} {name}, {what}: ptxas "
              + " | ".join(r.split(": ", 1)[1] for r in regs), flush=True)
    for name in dict.fromkeys(n for n, _ in runs):
        first = None
        for what in (*builds, *builds[::-1]):
            model, start, n_it, n_steps = runs[name, what]
            out, ms, streamed = _run_kernel(F, model.density(), start, n_it,
                                            n_steps, device)
            first = out if first is None else first
            print(f"RESULT row-loads {label} {name}, {what}: "
                  f"{start[0].shape[1]} chains x {n_it} it x {n_steps} "
                  f"steps {ms:.3f} ms, "
                  f"{'streamed' if streamed else 'synchronous'}, the first "
                  f"run's bits: {_same_bits(out, first)}", flush=True)
        for what in builds:
            model, start, _, _ = runs[name, what]
            _density_alone(model, _check_points(start[0]), device,
                           f"row-loads {label} {name}, {what}")


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


# ``resident-lanes``: the resident register models (the README regression
# and SBC's two families at SBC_ROWS rows), the chain counts, the layouts
# (lanes a chain, chains a block) timed at each in order and back, and the
# iterations of HMC(5) each run takes, every draw collected
RESIDENT_MODELS = ("README regression", "SBC binomial",
                   "SBC zero_inflated_geometric")
RESIDENT_CHAINS = (1024, 4096, 16384)
RESIDENT_LAYOUTS = ((32, 8), (16, 8), (16, 16), (8, 8), (8, 32))
RESIDENT_ITERS, RESIDENT_REPS = 1000, 5


def _rows_on_lanes(lanes):
    """``_variant_csrc``'s change that runs a chain with rows on `lanes`
    lanes, 32 / lanes chains a warp, in place of a warp."""
    return [[("#define RT_LANES 32\n#endif\n"
              "static_assert(RT_LANES == 32, \"a chain with rows is one "
              "warp\");\n",
              f"#define RT_LANES {lanes}\n#endif\n")]]


def _resident_models(rt, cs, device):
    """{name: model} of RESIDENT_MODELS: the README regression, and each
    SBC family observing SBC_ROWS rows synthesized on `device`."""
    out = {"README regression": cs.readme_regression(rt)[0]}
    for name, sbc in cs.zoo(rt):
        if f"SBC {name}" in RESIDENT_MODELS:
            data = sbc.synthesize(cs.SBC_ROWS, cs.ZOO_SEED, device)[0]
            dist, _ = sbc.fn([p.latent() for p in sbc.priors])
            out[f"SBC {name}"] = rt.Model.observe(data.astype(np.float64),
                                                  dist)
    return out


def _tiled_start(start, n):
    """A warmup's (q0 (dim, m), ε (m,), Σ̂ (m, dim)) repeated to n chains."""
    q0, eps, imd = start
    reps = -(-n // q0.shape[1])
    return (q0.repeat(1, reps)[:, :n].contiguous(), eps.repeat(reps)[:n],
            imd.repeat(reps, 1)[:n])


def resident_lanes(label: str) -> None:
    import torch

    import chip_smoke as cs
    import rainier_tpu_torch as rt
    from rainier_tpu_torch.compute import emit_cuda
    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device(DEVICE)
    widths = sorted({lanes for lanes, _ in RESIDENT_LAYOUTS})
    # a model of its own for each width, each built from its sources
    models = {lanes: _resident_models(rt, cs, device) for lanes in widths}
    names = list(models[widths[0]])
    starts = {name: _warm(models[widths[0]][name], CHAINS, device,
                          FORM_WARMUP) for name in names}
    jobs = [(name, lanes) for lanes in widths for name in names]
    with tempfile.TemporaryDirectory() as tmp:
        srcs = {lanes: F.CSRC if lanes == emit_cuda.LANES else _variant_csrc(
            F.CSRC, Path(tmp) / f"lanes_{lanes}", _rows_on_lanes(lanes))
            for lanes in widths}
        with ThreadPoolExecutor(len(jobs)) as pool:
            built = dict(zip(jobs, pool.map(lambda job: F.build(
                models[job[1]][job[0]].density(), emit_cuda.LANES,
                srcs[job[1]]), jobs)))
    for (name, lanes), (kernels, _, em) in built.items():
        print(f"RESULT resident-lanes {label} {name}, L={lanes}: "
              f"{em.n_rows} rows, state "
              f"{'in a slot' if em.workspace else 'in registers'}, ptxas "
              + " | ".join(_ptxas(kernels.log)), flush=True)
    rules = (F.lanes_per_chain, F.chains_per_block)
    try:
        for name in names:
            for n in RESIDENT_CHAINS:
                q0, eps, imd = _tiled_start(starts[name], n)
                kw = dict(step_size=eps, inv_mass_diag=imd, n_steps=5,
                          n_iterations=RESIDENT_ITERS, seed=1,
                          collect_every=1)
                first, by_lanes = None, {}
                for lanes, w in (*RESIDENT_LAYOUTS,
                                 *RESIDENT_LAYOUTS[::-1]):
                    F.lanes_per_chain = lambda em, n, lanes=lanes: lanes
                    F.chains_per_block = lambda em, n, w=w: w
                    out, ms = kernel_ms(F, models[lanes][name].density(),
                                        q0, kw, device, RESIDENT_REPS)
                    first = out if first is None else first
                    same = by_lanes.setdefault(lanes, out)
                    bits = all(bool(torch.equal(a, b))
                               for a, b in zip(out, same))
                    print(f"RESULT resident-lanes {label} {name}, L={lanes},"
                          f" W={w}: {n} chains x {RESIDENT_ITERS} it x 5 "
                          f"steps {ms:.4f} ms, accept "
                          f"{float(out[2].mean()):.4f}, "
                          f"{cs.agreement(out, first)[0]:.4f} of chains "
                          f"within 1e-4 rel of L=32, the bits of L={lanes}'s"
                          f" first run {bits}", flush=True)
    finally:
        F.lanes_per_chain, F.chains_per_block = rules


# ``philox-split``: the register models with rows whose chains split
# their Philox groups over their lanes, timed as built and as built from
# a copy of ``csrc/`` whose such models draw every group in every lane
# (chip_smoke.EVERY_LANE_PHILOX), at ``tiles``' shapes
PHILOX_MODELS = ("README regression", "logistic regression",
                 "MVNormal logistic", "logistic regression, two row spaces",
                 "marginalized mixture", "zoo neg_binomial")
PHILOX_BUILDS = ("split", "every lane")


def philox_split(label: str, names=()) -> None:
    import torch

    import chip_smoke as cs
    from rainier_tpu_torch.compute import emit_cuda
    from rainier_tpu_torch.ops import fused_hmc as F

    device = torch.device(DEVICE)
    runs = _row_runs(device, tuple(names) or PHILOX_MODELS)
    csrc = F.CSRC
    built = {}
    with tempfile.TemporaryDirectory() as tmp:
        every = _variant_csrc(csrc, Path(tmp) / "csrc", cs.EVERY_LANE_PHILOX)
        for what, path in zip(PHILOX_BUILDS, (csrc, every)):
            jobs = [(name, run[0].density(), F.lanes_per_chain(
                emit_cuda.emit(run[0].density()), run[1][0].shape[1]))
                for name, run in runs.items()]
            for _, cd, _ in jobs:
                F._BUILT.pop(cd, None)
            with ThreadPoolExecutor(len(jobs)) as pool:
                for (name, _, _), b in zip(jobs, pool.map(
                        lambda job, path=path: F.build(job[1], job[2], path),
                        jobs)):
                    built[what, name] = b
    for name, (model, start, n_it, n_steps) in runs.items():
        cd = model.density()
        first = None
        for what in (*PHILOX_BUILDS, *PHILOX_BUILDS[::-1]):
            _as_built(F, cd, built[what, name], start[0].shape[1])
            out, ms, _ = _run_kernel(F, cd, start, n_it, n_steps, device)
            first = out if first is None else first
            same = all(a is b or bool(torch.equal(a, b))
                       for a, b in zip(out, first))
            print(f"RESULT philox-split {label} {name}, {what}: "
                  f"{start[0].shape[1]} chains x {n_it} it x {n_steps} steps"
                  f" {ms:.3f} ms, the bits of the first run {same}; ptxas "
                  + " | ".join(line for line in _ptxas(
                      built[what, name][0].log) if "fused_hmc" in line),
                  flush=True)


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
    elif argv[:1] == ["tiles"] and len(argv) >= 2:
        tiles(argv[1], argv[2:])
    elif argv[:1] == ["lanes"]:
        lanes()
    elif argv[:1] == ["layouts"]:
        layouts()
    elif argv[:1] == ["adapt"]:
        adapt()
    elif argv[:1] == ["columnfree"] and len(argv) == 2:
        columnfree(argv[1])
    elif argv[:1] == ["resident-lanes"] and len(argv) == 2:
        resident_lanes(argv[1])
    elif argv[:1] == ["philox-split"] and len(argv) >= 2:
        philox_split(argv[1], argv[2:])
    elif argv[:1] == ["forms"] and len(argv) == 2:
        forms(argv[1])
    elif argv[:1] == ["gather-tiles"] and len(argv) == 2:
        gather_tiles(argv[1])
    elif argv[:1] == ["gp-layouts"] and len(argv) == 2:
        gp_layouts(argv[1])
    elif argv[:1] == ["split"] and len(argv) >= 2:
        split(argv[1], argv[2:])
    elif argv[:1] == ["tile-sizes"] and len(argv) >= 2:
        tile_sizes(argv[1], argv[2:])
    elif argv[:1] == ["gather-steps"] and len(argv) >= 2:
        gather_steps(argv[1], argv[2:])
    elif argv[:1] == ["gather-paths"] and len(argv) >= 2:
        gather_paths(argv[1], argv[2:])
    elif argv[:1] == ["eadd-select"] and len(argv) in (2, 3):
        eadd_select(*argv[1:])
    elif argv[:1] == ["steps"] and len(argv) >= 2:
        steps(argv[1], argv[2:])
    elif argv[:1] == ["loaders"] and len(argv) == 2:
        loaders(argv[1])
    elif argv[:1] == ["lse"] and len(argv) == 2:
        lse(argv[1])
    elif argv[:1] == ["lse-probe"] and len(argv) == 2:
        lse_probe(argv[1])
    elif argv[:1] == ["gp-split"] and len(argv) == 2:
        gp_split(argv[1])
    elif argv[:1] == ["gp-blocks"] and len(argv) == 2:
        gp_blocks(argv[1])
    elif argv[:1] == ["kernel-sass"] and len(argv) >= 3:
        kernel_sass(argv[1], argv[2:])
    elif argv[:1] == ["counts"] and len(argv) >= 2:
        counts(argv[1], argv[2:])
    elif argv[:1] == ["row-sass"] and len(argv) >= 2:
        row_sass(argv[1], argv[2:])
    elif argv[:1] == ["row-loads"] and len(argv) >= 2:
        row_loads(argv[1], argv[2:])
    elif argv[:1] == ["zoo"] and len(argv) >= 4:
        zoo(int(argv[1]), int(argv[2]), argv[3], argv[4:])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
