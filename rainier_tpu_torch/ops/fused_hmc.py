"""Fused HMC sampling phase: CUDA kernel for Hopper, its wrapper, and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``rainier_tpu/ops/hmc_pallas.py::fused_hmc``
(the one ``pl.pallas_call`` of the JAX package, hmc_pallas.py:506), which
keeps every chain's state in VMEM for the whole sampling run, including
its resident-column, row-tiled, streamed-column and untiled branches
(hmc_pallas.py:157-222, 280-381, 483-497).  The untiled branch evaluates
the density over whole columns of any lengths; here the rows of each
length are a row space with its own tile loop, and the columns no row
reads row by row are read whole by the code outside the rows, so the
wrapper passes every column's pointer and the rows of each space.  The
CUDA kernel (``csrc/fused_hmc.cu``) runs the whole sampling phase in one
launch: momentum refresh (Philox4x32-10 + Box-Muller,
``csrc/philox.cuh``), ``n_steps`` kick-drift-kick leapfrog steps with the
model's density and gradient from C generated out of the Real DAG
(``compute/emit_cuda.py``), the Metropolis accept, and the accept-rate
and divergence sums.  A model without rows gives each chain
``lanes_per_chain`` lanes of a warp: up to ``emit_cuda.LANE_STATE_MAX``
parameters each lane holds the whole state in registers and the lanes
split the Philox groups, 16 lanes up to 1024 chains and fewer as the
chains grow (``LANE_STEPS``, measured), one thread past 16,384 chains
(bench.py's 524,288 among them); past it, at any count, a chain is a warp
whose lanes split the passes over the state and the density's vector
loops, its state in a slot in the block's shared memory (in the
workspace past ``emit_cuda.LOCAL_STATE_MAX``).  A model with data gives
each chain one warp:
its RowSum likelihoods are summed over row tiles that the block's
threads load into shared memory together, and within a tile the warp's
32 lanes split the rows (lane l takes rows l, l + 32, ...), their
sums met once a density call by a reduce-scatter that leaves the same
bits in every lane; a block holds ``chains_per_block`` such warps, which all read each
tile.  Up to ``emit_cuda.LANE_STATE_MAX`` parameters and row-invariant
values every lane holds the whole chain state and runs the rest of the
iteration redundantly; past it each chain's arrays live in a slot, and
every pass over them is split over the lanes: in the block's shared
memory where a block's slots fit beside its tiles (GLMMPoisson2, 146
parameters: ``emit_cuda.shared_slot``), else in a workspace that this
wrapper allocates with ``torch.empty``, one slot a chain, the ragged
edge's copies included (``benchmarks/models.py::glmm_large``, 10,002).  X·β and its adjoint are f32 multiply-adds in the
kernel's body, on the CUDA cores.  An integer index column
(``IntColumn``, the GLMMs' site and year) is an int32 field of the tile;
a ``Gather`` by it reads the chain's row-invariant vector at a clamped
per-row index, and its adjoint adds there (``mode="clip"`` of the JAX
kernel's gather, hmc_pallas.py:157 with
rainier_tpu/compute/interp.py:379-383), in a fixed order without
atomics: into each lane's own copy, summed over the lanes once a density
call, or, over a slot, added by the warp step by step, a fixed tree over
the lanes of one entry, several steps at once over a slot in device
memory.
A density that reads a vector whole (the L·z of an ``MVNormal`` past 16
dimensions, the source of a gather by an index column read whole) holds
it in a scratch array of ``EmittedDensity.scratch`` floats, in the
chain's slot where there is one, which this wrapper's workspace then
includes; over the workspace the product passes read L from the block's
shared memory, staged there once a launch, or, where it does not fit, in
tiles of its rows that the block's threads copy there as the passes run.
The literals of a group of scalar terms that the chain's lanes split (the
latent GP's y) are a table that this wrapper binds after the columns
(:func:`column_pointers`).  The wrapper refuses, naming the bytes, a
launch whose workspace does not fit the card's free memory.
``collect_idx`` stores only the chosen coordinates of each draw, so a
large model's draws need not hold all its coordinates.

What bounds it on the H100: f32 ALU work and SFU work (``expf``,
``logf``, ``cosf``, ``sqrtf``) of the density, its adjoints and the RNG,
where enough chains run to fill the card.  Without rows, one thread a
chain leaves 1024 chains on 32 SMs, one warp each, each iteration one
dependent path of ~1,700 operations, more than half of them Philox (the
funnel, 2.39 ms at 1024 chains × 1000 iterations × 5 steps on an H100,
1.09 ms with explicit noise); 16 lanes a chain draw one Philox group
each and spread the chains over 16 times as many warps (0.89 ms), and
what bounds it then is the density and leapfrog path that every lane
runs, as the explicit-noise time shows (1.03 ms; PERF.md §6).  With
data, the row terms: n_rows × (row operations) per density
call and chain, on columns read from L2 where they fit it (the 100k × 11
floats of the logistic regression are 4.4 MB, against a 50 MB L2).  With
one warp a chain, 1024 chains are 1024 warps, 8 on each SM in blocks of
8 chains, and a block's 256 threads load each tile once for its 8
chains, so the L2 traffic of the tiles falls with W, and the time with
it (PERF.md §6: the 100k logistic's kernel 793 ms at W = 8, 1,166 ms at
W = 4).  With 8 warps an SM the latency of each tile's copies and of
each row's dependent chain is what holds the kernel back, so every
launch with rows streams its tiles (``stream_columns``, the Pallas
kernel's streamed branch, hmc_pallas.py:186-191, 305-351): each thread
issues its share of tile t + 1 as ``cp.async`` copies into one of two
shared-memory slots, then computes tile t's rows from the other; tiles
are as large as two fit a block's shared memory (up to 4096 rows); a row
of many operations and few floats is summed four rows a lane's step,
their dependent chains overlapping; and the lanes' sums meet once a
density call.  Larger columns (the 2M-row logistic's 88 MB) come from
device memory in every density call; its 512 chains run 4 to a block,
so that 128 blocks keep the SMs busy.  A slot model is bound by the
latency of its rows' scatters and gathers and of its passes over the
slot (about 23 a density call).  PERF.md holds every kernel's time
beside its bound.

A row's additive terms that read only the data (a count likelihood's
``lgamma(y + 1)``) are the same in every density call, so the rows leave
them out, and each launch first sums them over the rows, once, into a
double a row space that this wrapper allocates (``_launch_setup``); the
density adds it to its rows' sum in f64 (csrc/fused_hmc.cu,
``RT_ROW_CONSTS``).

Build: nvcc compiles the template plus the model's generated
``rt_model.h`` for ``sm_90a``, with a plain C interface, into
``_build/fused_hmc_<sha256>.so`` at first use (the hash covers the
sources, the generated header and the flags), which is loaded with
ctypes.  The same library holds ``rt_logp_grad_launch``, the density and
gradient alone through the same tile loop, which checks the kernel's
density at full width.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
import weakref
from pathlib import Path
from typing import NamedTuple

import torch

from ..compute import emit_cuda
from ..compute import real as R
from ..compute.compiler import NoRowSplit

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("fused_hmc.cu", "philox.cuh", "rt_math.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

TWO_PI = 6.28318530717958648
_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


# ---------------------------------------------------------------------------
# Philox4x32-10 in PyTorch: the same bits as csrc/philox.cuh
# ---------------------------------------------------------------------------


def _mulhilo(m: int, a: torch.Tensor):
    """(hi, lo) 32-bit halves of m·a for uint32 values held in int64.
    torch has no uint64 multiply, so a is split into 16-bit limbs and
    every partial product stays below 2^49."""
    x = (a >> 16) * m
    y = (a & 0xFFFF) * m
    s = y + ((x & 0xFFFF) << 16)
    return (x >> 16) + (s >> 32), s & _MASK


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding uint32 values."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 (in int64) → f32 uniform in (0, 1) by the exponent trick."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return (f - 1.0) + 1.1920929e-7


def philox_noise(seed: int, it: int, dim: int, n: int, device):
    """Iteration `it`'s momentum (dim, n) and Metropolis uniform (n,) for
    chains 0..n-1 — word layout as in csrc/philox.cuh."""
    n_words = 2 * dim + 1
    groups = (n_words + 3) // 4
    chain = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    grp = torch.arange(groups, dtype=torch.int64, device=device)[:, None]
    zero = torch.zeros_like(grp)
    words = torch.stack(philox4x32(zero + it, grp, zero, zero,
                                   seed & _MASK, chain), dim=1)
    u = uniform_from_bits(words.reshape(4 * groups, n)[:n_words])
    p = torch.sqrt(-2.0 * torch.log(u[0:2 * dim:2])) * torch.cos(
        TWO_PI * u[1:2 * dim:2])
    return p, u[2 * dim]


# ---------------------------------------------------------------------------
# shared argument handling
# ---------------------------------------------------------------------------


def _columns(density, columns, dev):
    """The model's data as the kernel takes it: one contiguous tensor on
    `dev` per column of ``density.columns``, int32 for an ``IntColumn``
    and float32 for the others, each shaped like its data (the row spaces
    differ in rows, and a column read whole has its own).  None means the
    model's own data."""
    if columns is None:
        columns = density.column_values(torch.float32, dev)
    columns = tuple(columns)
    if len(columns) != len(density.columns):
        raise ValueError(f"the model has {len(density.columns)} data "
                         f"columns, got {len(columns)}")
    for node, c in zip(density.columns, columns):
        want = tuple(node.values.shape)
        dtype = torch.int32 if isinstance(node, R.IntColumn) \
            else torch.float32
        if (not isinstance(c, torch.Tensor) or c.dtype != dtype
                or c.device != dev or not c.is_contiguous()
                or tuple(c.shape) != want):
            raise ValueError(
                f"{type(node).__name__} columns must be contiguous "
                f"{str(dtype).split('.')[-1]} tensors on {dev}; this one "
                f"must be shaped like its data {want}, got "
                + (f"{c.dtype} {tuple(c.shape)} on {c.device}, contiguous "
                   f"{c.is_contiguous()}" if isinstance(c, torch.Tensor)
                   else type(c).__name__))
    return columns


def _prepare(density, q0, step_size, inv_mass_diag, n_steps, n_iterations,
             collect_every, noise, columns):
    if n_steps < 1 or n_iterations < 1 or collect_every < 0:
        raise ValueError(f"need n_steps >= 1, n_iterations >= 1 and "
                         f"collect_every >= 0, got {n_steps}, "
                         f"{n_iterations}, {collect_every}")
    if q0.dim() != 2 or q0.dtype != torch.float32:
        raise ValueError(f"q0 must be a float32 (dim, n_chains) tensor, got "
                         f"{tuple(q0.shape)} {q0.dtype}")
    dim, n = q0.shape
    if dim != density.n_vars:
        raise ValueError(f"q0 has {dim} rows, the model {density.n_vars}")
    dev = q0.device
    columns = _columns(density, columns, dev)
    eps = torch.as_tensor(step_size, dtype=torch.float32, device=dev)
    eps = eps.reshape(-1).expand(n).contiguous()
    scale = None
    if inv_mass_diag is not None:
        imd = torch.as_tensor(inv_mass_diag, dtype=torch.float32, device=dev)
        if imd.shape not in ((dim,), (n, dim)):
            raise ValueError(f"inv_mass_diag must be ({dim},) or "
                             f"({n}, {dim}), got {tuple(imd.shape)}")
        scale = torch.sqrt(imd.T if imd.dim() == 2 else imd).contiguous()
    if noise is not None:
        p_noise, u_noise = (torch.as_tensor(t, dtype=torch.float32,
                                            device=dev).contiguous()
                            for t in noise)
        if (tuple(p_noise.shape) != (n_iterations, dim, n)
                or tuple(u_noise.shape) != (n_iterations, n)):
            raise ValueError("noise must be (p (n_iterations, dim, n), "
                             "u (n_iterations, n))")
        noise = (p_noise, u_noise)
    return q0.contiguous(), eps, scale, noise, columns


def _collect_idx(collect_idx, dim, dev):
    """``collect_idx`` as an int64 tensor on `dev` (None: every
    coordinate)."""
    if collect_idx is None:
        return None
    idx = torch.as_tensor(collect_idx, dtype=torch.int64, device=dev)
    if idx.dim() != 1 or idx.numel() == 0 or int(idx.min()) < 0 \
            or int(idx.max()) >= dim:
        raise ValueError(f"collect_idx must be a non-empty 1-d index into "
                         f"the {dim} coordinates")
    return idx


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

# rows per evaluation of the plain version's row terms: bounds the memory
# of its (rows, chains) intermediates
PLAIN_TILE_ROWS = 32768


def density_lanes(density, columns):
    """(x (dim, n)) -> (n,): the density in the kernel's order — the base
    terms, plus each row space's rows (``logp_rows_fn``) summed in f64
    over row slices and rounded to f32 once — differentiable by
    autograd.  The plain version of the kernel's density."""
    if not density.columns:
        lanes = density.logp_lanes_fn()
        return lambda x: lanes(x, ())
    try:
        base_fn, rows_fn = density.logp_rows_fn()
    except NoRowSplit as e:
        raise emit_cuda.UnsupportedNode(str(e)) from None

    def lp(x):
        rows = rows_fn(x, columns, PLAIN_TILE_ROWS)
        return base_fn(x, columns) + rows.to(x.dtype)

    return lp


def _lp_grad_fn(density, columns):
    lanes = density_lanes(density, columns)

    def lp_grad(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            lp = lanes(x)
            g = torch.autograd.grad(lp.sum(), x, allow_unused=True)[0] \
                if lp.requires_grad else None
        return lp.detach(), torch.zeros_like(x) if g is None else g

    return lp_grad


def logp_grad_reference(density, q, columns=None):
    """Plain version of ``rt_logp_grad_launch``: (lp (n,), g (dim, n)) at
    every column of q (dim, n)."""
    columns = _columns(density, columns, q.device)
    return _lp_grad_fn(density, columns)(q)


def fused_hmc_reference(density, q0, *, step_size, n_steps: int,
                        n_iterations: int, seed: int, inv_mass_diag=None,
                        collect_every: int = 0, collect_idx=None,
                        noise=None, columns=None):
    """The kernel's loop in PyTorch on (dim, n) tensors: the same order of
    operations, the density and gradient from :func:`density_lanes` and
    autograd, and the same Philox bits when ``noise`` is None.  Used on
    the CPU and to check the kernel; never by the card's main path."""
    q0, eps, scale, noise, columns = _prepare(
        density, q0, step_size, inv_mass_diag, n_steps, n_iterations,
        collect_every, noise, columns)
    cidx = _collect_idx(collect_idx, density.n_vars, q0.device)
    dim, n = q0.shape
    dev = q0.device
    sc = torch.ones_like(q0) if scale is None else \
        (scale if scale.dim() == 2 else scale[:, None]).expand(dim, n)
    eps = eps[None, :]
    lpg = _lp_grad_fn(density, columns)

    def lp_grad(qs):
        lp, g = lpg(qs * sc)
        return lp, sc * g

    q = q0 / sc
    lp, g = lp_grad(q)
    acc = torch.zeros(n, dtype=torch.float32, device=dev)
    div = torch.zeros(n, dtype=torch.float32, device=dev)
    n_out = n_iterations // collect_every if collect_every else 0
    n_collect = dim if cidx is None else cidx.numel()
    samples = torch.empty((n_out, n_collect, n), dtype=torch.float32,
                          device=dev) if collect_every else None
    for it in range(n_iterations):
        if noise is not None:
            p0, u = noise[0][it], noise[1][it]
        else:
            p0, u = philox_noise(seed, it, dim, n, dev)
        h0 = -lp + 0.5 * torch.sum(p0 * p0, dim=0)
        p = p0 + 0.5 * eps * g
        qn = q + eps * p
        lpn, gn = lp_grad(qn)
        for _ in range(n_steps - 1):
            p = p + eps * gn
            qn = qn + eps * p
            lpn, gn = lp_grad(qn)
        p = p + 0.5 * eps * gn
        h1 = -lpn + 0.5 * torch.sum(p * p, dim=0)
        la = torch.clamp(-(h1 - h0), max=0.0)
        la = torch.where(torch.isfinite(h0) & torch.isfinite(h1), la,
                         torch.full_like(la, -float("inf")))
        take = torch.log(u) < la
        q = torch.where(take, qn, q)
        lp = torch.where(take, lpn, lp)
        g = torch.where(take, gn, g)
        acc = acc + torch.exp(la)
        div = div + torch.isinf(la).to(torch.float32)
        if collect_every and it % collect_every == collect_every - 1:
            x = q * sc
            samples[it // collect_every] = x if cidx is None else x[cidx]
    return q * sc, samples, acc / n_iterations, div


# ---------------------------------------------------------------------------
# kernel build and launch
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the fused kernel is built from "
                           "csrc/ at first use on a machine with the CUDA "
                           "toolkit")
    return path


# the arguments shared by rt_fused_hmc_launch and rt_fused_hmc_host, and by
# rt_logp_grad_launch and rt_logp_grad_host: the column pointers, then the
# rows of each row space (row_counts), and the threads of a block and the
# streaming flag last (the launches add the doubles that their pass over
# the rows' data-only terms fills, and the CUDA stream; the host entries
# keep theirs on the stack)
HMC_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                + [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int])
LOGP_GRAD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                      + [ctypes.c_int, ctypes.c_int])


class Kernels(NamedTuple):
    """The two entry points of one model's library (ctypes functions)."""

    fused_hmc: object
    logp_grad: object
    log: str        # nvcc's output for the build: registers, spills
    path: str       # the library's file


@functools.lru_cache(maxsize=None)
def _load(so_path: str) -> Kernels:
    lib = ctypes.CDLL(so_path)
    hmc = lib.rt_fused_hmc_launch
    hmc.argtypes = HMC_ARGTYPES + [ctypes.c_void_p] * 2
    hmc.restype = ctypes.c_int
    lpg = lib.rt_logp_grad_launch
    lpg.argtypes = LOGP_GRAD_ARGTYPES + [ctypes.c_void_p] * 2
    lpg.restype = ctypes.c_int
    log = Path(so_path).with_suffix(".log")
    return Kernels(hmc, lpg, log.read_text() if log.exists() else "",
                   so_path)


# density -> (the directory of sources it is built from, {lanes a chain:
# (Kernels, emitted)} of its builds in this process)
_BUILT = weakref.WeakKeyDictionary()


def build(density, lanes, csrc=None):
    """Emit the model's rt_model.h and compile the kernel for `lanes`
    lanes a chain, which a model without rows takes as the build's
    ``RT_LANES`` (a model with rows is a warp a chain whatever it is
    given), from the sources in `csrc` (default CSRC), cached by the
    content hash on disk, and per density and lanes in the process, so a
    launch neither emits nor hashes again.  A density is built from one
    directory of sources in a process, its first build's: a build that
    names none (a launch's) takes it, one that names another is refused.
    Returns (Kernels, build seconds, emitted)."""
    em = emit_cuda.emit(density)
    lanes = emit_cuda.LANES if em.spaces else lanes
    src, built = _BUILT.setdefault(
        density, (CSRC if csrc is None else Path(csrc), {}))
    if csrc is not None and Path(csrc) != src:
        raise ValueError(f"the density is built from {src}, not {csrc}")
    csrc = src
    if lanes in built:
        return built[lanes][0], 0.0, em
    defines = () if em.spaces else (f"-DRT_LANES={lanes}",)
    t0 = time.perf_counter()
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((csrc / name).read_bytes())
    h.update(em.source.encode())
    h.update(" ".join(NVCC_FLAGS + defines).encode())
    key = h.hexdigest()[:24]
    so = BUILD_DIR / f"fused_hmc_{key}.so"
    if not so.exists():
        inc = BUILD_DIR / key
        inc.mkdir(parents=True, exist_ok=True)
        (inc / emit_cuda.HEADER_NAME).write_text(em.source)
        tmp = BUILD_DIR / f".fused_hmc_{key}.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-I", str(inc), "-I",
               str(csrc), "-o", str(tmp), str(csrc / "fused_hmc.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stderr}\n{' '.join(cmd)}")
        so.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, so)
    built[lanes] = (_load(str(so)), em)
    return built[lanes][0], time.perf_counter() - t0, em


def _ptr(t):
    return None if t is None else t.data_ptr()


# chains in a block of a model with rows, each a warp of emit_cuda.LANES
# lanes, which share each row tile: WIDE_BLOCK where that still leaves
# BLOCKS_MIN blocks for the card's 132 SMs (1024 chains: 128 blocks of
# 8), else NARROW_BLOCK (512 chains: 128 blocks of 4).  On an H100 the
# 100k logistic's kernel at 1024 chains took 793 ms at W = 8, 1,166 ms at
# 4 and 1,911 ms at 2; the 2M-row logistic's at 512 chains 735 ms at 4
# and 819 ms at 8 (tools/kernel_ab.py lanes, PERF.md §6).  At most 8:
# csrc/fused_hmc.cu's launch bounds allow 256 threads.
WIDE_BLOCK, NARROW_BLOCK, BLOCKS_MIN = 8, 4, 128

# A model without rows: up to emit_cuda.LANE_STATE_MAX parameters every
# lane of a chain holds its whole state in registers and the lanes split
# the Philox groups.  A launch over n chains gives each chain the lanes of
# the first LANE_STEPS entry (most chains, lanes) with n <= most chains,
# and one thread past the last: more lanes shorten each chain's path, but
# once the chains' lanes fill the card the lanes' redundant density work
# costs more than that saves.  On an H100, the 10-dim funnel's kernel
# over 1000 iterations x 5 steps, every draw collected, in ms at 1, 2, 4,
# 8 and 16 lanes: 1024 chains 2.367, 1.511, 1.213, 0.915, 0.883 (32:
# 1.168); 2048 2.367, 1.511, 1.214, 0.919, 1.184; 4096 2.368, 1.512,
# 1.220, 1.220, 1.982; 8192 2.368, 1.519, 1.569, 2.028, 3.912; 16384
# 2.390, 1.952, 2.625, 4.021, 7.706; 32768 2.869, 3.233, 5.168, 7.906,
# 15.206; and 524,288 chains x 500 15.6 ms at 1 lane, 21.9 at 2
# (tools/kernel_ab.py columnfree, PERF.md §6).  Past LANE_STATE_MAX a
# chain is a warp (emit_cuda.LANES) whose lanes split the passes over its
# slot: the funnel at 1000 dims took 495-500 ms at 1 lane and 16.7-17.1
# at 32 (1024 x 200 x 5).  Blocks hold 128 threads where the launch has
# WIDE_THREADS threads or more (a block of 128 on every SM), else 32, to
# spread few threads over more SMs.
LANE_STEPS = ((1024, 16), (2048, 8), (4096, 4), (16384, 2))
WIDE_THREADS = 128 * 132


def lanes_per_chain(em, n: int) -> int:
    """Threads that run one chain of a launch over n chains: a warp for a
    model with rows, which its lanes split, or with a slot; otherwise the
    lanes of the first LANE_STEPS entry whose chains n does not exceed,
    else one."""
    if em.spaces or em.workspace:
        return emit_cuda.LANES
    return next((lanes for most, lanes in LANE_STEPS if n <= most), 1)


def chains_per_block(em, n: int) -> int:
    """Chains of each block for a launch over n chains: for a model with
    rows, or whose product passes read their matrices in tiles
    (``em.mat_tiles``), warps that share each tile (WIDE_BLOCK or
    NARROW_BLOCK); else, without rows, 128 threads' worth, or 32 to
    spread a small launch over more SMs.  The 256-input GP's kernel took
    2.845 ms at 8 chains a block and tiles of 64 rows of L, 2.935 at 8
    and 32 rows, 3.870 at 4 and 32, 6.163 at 4 and 64 (one block an SM:
    4 warps), its 64-input one 0.895 / 0.899 ms at 4 / 8 with L staged
    (1024 chains, H100 at 700 W, tools/kernel_ab.py gp-blocks, PERF.md
    §6; L read 4 bytes at a time)."""
    if em.spaces or em.mat_tiles:
        return WIDE_BLOCK if n >= WIDE_BLOCK * BLOCKS_MIN else NARROW_BLOCK
    lanes = lanes_per_chain(em, n)
    return (128 if n * lanes >= WIDE_THREADS else 32) // lanes


def threads_per_block(em, n: int) -> int:
    """Threads of each block for a launch over n chains."""
    return chains_per_block(em, n) * lanes_per_chain(em, n)


def workspace_bytes(em, n: int) -> int:
    """Bytes of the device workspace a launch over n chains allocates: one
    slot for every chain of its blocks, the ragged edge's copies included
    (0 for a model without one, or with its slots in shared memory)."""
    if em.shared:
        return 0
    w = chains_per_block(em, n)
    return 4 * em.workspace * w * -(-n // w)


def free_bytes(device) -> int:
    """Free memory of `device`: the card's, or the host's for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def workspace_check(em, n: int, device):
    """None if a launch over n chains of the emitted density `em` has
    room for its workspace on `device`, else why not, naming the bytes."""
    need = workspace_bytes(em, n)
    free = free_bytes(device) if need else 0
    if need > free:
        return (f"the fused kernel's workspace for {n} chains is {need} "
                f"bytes ({em.workspace} floats a chain), over the "
                f"{free} bytes free on {device}")
    return None


def l2_bytes(device):
    """The L2 cache of a CUDA `device` in bytes; None on another device."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).L2_cache_size


def streams(density, stream_columns, device) -> bool:
    """Whether a launch streams its row tiles: True and False force it;
    None streams on a CUDA `device` wherever the model has row tiles, and
    nothing streams on another device.  The JAX package's rule
    (``rainier_tpu/ops/hmc_pallas.py:187-188``) streams only past the
    TPU's VMEM budget, where its resident columns no longer fit; on the
    H100 the streamed loop, which has tile t + 1's copies in flight while
    tile t's rows run, beat the synchronous loop on every model with rows,
    the columns inside L2 or not (the 32-feature MVNormal logistic's
    kernel 0.49 of its time, the 100k logistic's 0.62, the marginalized
    mixture's 0.97; tools/kernel_ab.py stream, PERF.md §6).  True on a
    model whose columns are all read whole, or that has none, raises: it
    has no tiles."""
    tiles = bool(density.columns) and bool(density.row_split().spaces)
    if stream_columns is None:
        return tiles and torch.device(device).type == "cuda"
    if stream_columns and not tiles:
        raise ValueError("stream_columns=True needs data columns read row "
                         "by row: the model has none, so there are no "
                         "tiles to stream")
    return bool(stream_columns)


def column_pointers(em, columns, device=None):
    """The pointer array the kernel's entry points take for `columns`
    (the tensors of the emitted density `em`'s columns), with each group
    of scalar terms' table of literals after them (``em.tables``, made on
    `device`, by default the columns'), and the tensors that the
    pointers point into, to be kept alive while the kernel runs."""
    dev = device if device is not None else (
        columns[0].device if columns else "cpu")
    held = (*columns, *[torch.tensor(t, dtype=torch.float32, device=dev)
                        for t in em.tables])
    return (ctypes.c_void_p * max(len(held), 1))(
        *[c.data_ptr() for c in held]), held


def row_counts(em):
    """The rows of each row space of the emitted density `em`, as the
    kernel's entry points take them (an int array; null without rows)."""
    return (ctypes.c_int * len(em.spaces))(
        *[s.n_rows for s in em.spaces]) if em.spaces else None


def _launch_setup(density, columns, n, dev, stream_columns=None):
    """(Kernels, (column pointer array, the tensors it points into), rows
    of each row space, threads, workspace, whether the tiles stream, the
    f64 sums of each row space's data-only terms that the launch's first
    pass fills) for a launch over n chains;
    raises, before building, on a row the kernel's tile cannot hold, on a
    workspace the card has no room for, and on ``stream_columns`` without
    tiles."""
    em = emit_cuda.emit(density)
    if em.row_width and not em.tile_rows:
        raise ValueError(
            f"a row of the model's columns is {em.row_width} floats: even "
            f"a {emit_cuda.TILE_ROWS_MIN}-row tile needs "
            f"{4 * em.row_width * emit_cuda.TILE_ROWS_MIN} bytes of shared "
            f"memory, over the {emit_cuda.SMEM_BYTES_MAX} a block can use")
    reason = workspace_check(em, n, dev)
    if reason is not None:
        raise ValueError(reason)
    stream = streams(density, stream_columns, dev)
    kernels = build(density, lanes_per_chain(em, n))[0]
    ptrs, held = column_pointers(em, columns, dev)
    ws = torch.empty(workspace_bytes(em, n) // 4, dtype=torch.float32,
                     device=dev) if workspace_bytes(em, n) else None
    consts = torch.empty(max(len(em.spaces), 1), dtype=torch.float64,
                         device=dev)
    return kernels, (ptrs, held), row_counts(em), threads_per_block(em, n), \
        ws, stream, consts


def fused_hmc(density, q0, *, step_size, n_steps: int, n_iterations: int,
              seed: int, inv_mass_diag=None, collect_every: int = 0,
              collect_idx=None, noise=None, columns=None,
              stream_columns=None):
    """HMC with ``n_steps`` leapfrog steps × ``n_iterations`` for every
    chain of ``q0`` (dim, n_chains), the whole run in one kernel.

    Argument names follow ``rainier_tpu.ops.fused_hmc``: ``step_size`` is
    a scalar or (n_chains,) per-chain ε; ``inv_mass_diag`` the adapted Σ̂
    diagonal, (dim,) shared or (n_chains, dim) per chain, or None
    (identity); ``collect_every`` k > 0 also returns every k-th draw,
    of the coordinates ``collect_idx`` (an index array; None: all).
    ``noise=(p (n_iterations, dim, n), u (n_iterations, n))`` replaces the
    in-kernel Philox streams with explicit momenta and uniforms (the
    ``host_rng`` counterpart).  ``columns``: one contiguous tensor per
    ``density.columns`` on q0's device (int32 for an ``IntColumn``,
    float32 otherwise), or None for the model's own data.
    ``stream_columns``: None streams the row tiles through two slots of
    shared memory wherever the model has rows, True and False force it
    (:func:`streams`); the results are the same bit for bit.

    On CUDA tensors this launches the kernel or raises; on CPU tensors it
    checks ``stream_columns`` and runs :func:`fused_hmc_reference`, which
    streams nothing.  Returns (final q (dim, n),
    samples (n_out, n_collect, n) or None, accept rate (n,), divergences
    (n,)).
    """
    return prepare_fused_hmc(
        density, q0, step_size=step_size, n_steps=n_steps,
        n_iterations=n_iterations, seed=seed, inv_mass_diag=inv_mass_diag,
        collect_every=collect_every, collect_idx=collect_idx, noise=noise,
        columns=columns, stream_columns=stream_columns)()


def prepare_fused_hmc(density, q0, *, step_size, n_steps: int,
                      n_iterations: int, seed: int, inv_mass_diag=None,
                      collect_every: int = 0, collect_idx=None, noise=None,
                      columns=None, stream_columns=None):
    """Everything :func:`fused_hmc` does before its launch — checks,
    columns, build, workspace, outputs — and a function that then
    launches it: each call of ``launch()`` runs the kernel once into the
    same outputs, counts the launch, and returns what :func:`fused_hmc`
    returns.  Timing ``launch()`` alone times the kernel without the
    host's setup.  On CPU tensors ``launch()`` runs the plain version."""
    kw = dict(step_size=step_size, n_steps=n_steps,
              n_iterations=n_iterations, seed=seed,
              inv_mass_diag=inv_mass_diag, collect_every=collect_every,
              collect_idx=collect_idx, noise=noise, columns=columns)
    if q0.device.type == "cpu":
        streams(density, stream_columns, "cpu")
        return lambda: fused_hmc_reference(density, q0, **kw)
    if q0.device.type != "cuda":
        raise ValueError(f"fused_hmc runs on CUDA or CPU tensors, not "
                         f"{q0.device}")
    q0, eps, scale, noise, columns = _prepare(
        density, q0, step_size, inv_mass_diag, n_steps, n_iterations,
        collect_every, noise, columns)
    dim, n = q0.shape
    dev = q0.device
    pos, n_collect, expand = _collect_pos(collect_idx, emit_cuda.emit(density),
                                          dev)
    kernels, (ptrs, columns), rows, threads, ws, stream_cols, consts = \
        _launch_setup(density, columns, n, dev, stream_columns)
    qf = torch.empty((dim, n), dtype=torch.float32, device=dev)
    acc = torch.empty((n,), dtype=torch.float32, device=dev)
    div = torch.empty((n,), dtype=torch.float32, device=dev)
    samples = torch.empty((n_iterations // collect_every, n_collect, n),
                          dtype=torch.float32, device=dev) \
        if collect_every else None
    p_noise, u_noise = noise if noise is not None else (None, None)
    args = (n, _ptr(q0), _ptr(scale),
            int(scale is not None and scale.dim() == 2), _ptr(eps),
            _ptr(p_noise), _ptr(u_noise), _ptr(qf), _ptr(samples),
            _ptr(acc), _ptr(div), n_iterations, n_steps, collect_every,
            _ptr(pos), n_collect, seed & _MASK, ptrs, rows, _ptr(ws),
            threads, int(stream_cols), _ptr(consts))
    # the tensors whose pointers `args` holds, alive as long as `launch`
    held = (q0, scale, eps, noise, columns, qf, samples, acc, div, pos, ws,
            consts)

    def launch():
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = kernels.fused_hmc(*args, stream)
        if rc != 0:
            raise RuntimeError(f"fused_hmc kernel launch failed: cudaError "
                               f"{rc}")
        fused_hmc.launches += 1
        fused_hmc.streamed += stream_cols
        out = samples if samples is None or expand is None \
            else samples[:, expand]
        return qf, out, acc, div

    launch.held = held
    return launch


# kernel launches, and those of them that streamed their column tiles
fused_hmc.launches = 0
fused_hmc.streamed = 0


def _collect_pos(collect_idx, em, dev):
    """The kernel's form of ``collect_idx`` for the emitted model `em`:
    (int32 (dim,) slot of each coordinate among the stored ones or -1, or
    None for all; stored count; None, or the index that takes the stored
    coordinates to ``collect_idx``).  A model without a workspace stores
    every coordinate, and its draws are sliced."""
    dim = em.n_vars
    idx = _collect_idx(collect_idx, dim, dev)
    if idx is None or not em.workspace:
        return None, dim, idx
    uniq, inverse = torch.unique(idx, return_inverse=True)
    keep = idx if uniq.numel() == idx.numel() else uniq
    pos = torch.full((dim,), -1, dtype=torch.int32, device=dev)
    pos[keep] = torch.arange(keep.numel(), dtype=torch.int32, device=dev)
    return pos, keep.numel(), None if keep is idx else inverse


def logp_grad(density, q, columns=None, stream_columns=None):
    """The model's log-density and gradient at every column of q
    (dim, n): (lp (n,), g (dim, n)).  On CUDA tensors this launches
    ``rt_logp_grad_launch`` — the kernel's own density function and tile
    loop, streamed as :func:`fused_hmc` decides — or raises; on CPU
    tensors it checks ``stream_columns`` and runs
    :func:`logp_grad_reference`."""
    return prepare_logp_grad(density, q, columns, stream_columns)()


def prepare_logp_grad(density, q, columns=None, stream_columns=None):
    """:func:`logp_grad` split as :func:`prepare_fused_hmc` splits
    :func:`fused_hmc`: the setup now, and ``launch()`` that runs
    ``rt_logp_grad_launch`` once into the same outputs, counts it, and
    returns (lp, g); on CPU tensors the plain version."""
    if q.device.type == "cpu":
        streams(density, stream_columns, "cpu")
        return lambda: logp_grad_reference(density, q, columns)
    if q.device.type != "cuda" or q.dim() != 2 or \
            q.dtype != torch.float32 or q.shape[0] != density.n_vars:
        raise ValueError(f"q must be a float32 ({density.n_vars}, n) CUDA "
                         f"tensor, got {tuple(q.shape)} {q.dtype} on "
                         f"{q.device}")
    q = q.contiguous()
    columns = _columns(density, columns, q.device)
    n = q.shape[1]
    kernels, (ptrs, columns), rows, threads, ws, stream_cols, consts = \
        _launch_setup(density, columns, n, q.device, stream_columns)
    lp = torch.empty((n,), dtype=torch.float32, device=q.device)
    g = torch.empty_like(q)
    args = (n, _ptr(q), _ptr(lp), _ptr(g), ptrs, rows, _ptr(ws), threads,
            int(stream_cols), _ptr(consts))

    def launch():
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            rc = kernels.logp_grad(*args, stream)
        if rc != 0:
            raise RuntimeError(f"logp_grad kernel launch failed: cudaError "
                               f"{rc}")
        logp_grad.launches += 1
        logp_grad.streamed += stream_cols
        return lp, g

    launch.held = (q, columns, lp, g, ws, consts)
    return launch


logp_grad.launches = 0
logp_grad.streamed = 0


def op_count(em, n_steps: int, rng: bool = True) -> int:
    """f32 and 32-bit integer operations of ONE chain iteration of the
    kernel, for the bound in PERF.md and chip_smoke.py: the density +
    gradient ``n_steps`` times (its row terms over every row included,
    with each row's gathers and adjoint scatters), the leapfrog
    arithmetic, kinetic energies, the accept, and with `rng` the
    on-device Philox (explicit noise is bytes instead).  The draws'
    stores are bytes, not operations; the launch's one pass over the
    rows' data-only terms is ``em.const_ops()``, beside this."""
    dim = em.n_vars
    per_grad = em.density_ops() + 2 * dim      # x = q·sc, g = sc·∇
    leap = n_steps * 4 * dim + 2 * dim         # kicks + drifts, half kicks
    kinetic = 2 * 2 * dim + 4                  # k0, k1, h0, h1
    accept = 10                                # la, guard, log u, acc, div
    groups = (2 * dim + 1 + 3) // 4
    philox = groups * (10 * 8 + 9 * 2)         # rounds + key bumps
    philox += (2 * dim + 1) * 4 + dim * 6      # bits→f32, Box-Muller
    return n_steps * per_grad + leap + kinetic + accept + philox * rng
