"""Code generator: Real DAG → C source of ``logp`` and its gradient.

The JAX package's fused kernel evaluates a model by tracing
``logp_lanes_fn`` inside the kernel body and calling ``jax.grad`` there
(rainier_tpu/ops/hmc_pallas.py:282-301).  A CUDA kernel can do neither, so
this module plays the part of the reference's Gradient + bytecode codegen
(rainier-compute Gradient.scala, ir/*): it writes

    RT_HD float rt_logp_grad(const float* q, float* g)

for ONE chain in natural coordinates — the forward pass in topological
order, then reverse-mode adjoints in reverse order.  Scalars and vectors
of at most ``UNROLL_MAX`` elements are straight-line code over scalars.
A longer vector (a ``VectorParameter(k)`` and everything that broadcasts
from it) is a loop over its elements ``i`` whose body is the same scalar
code for element i: the forward pass emits one loop per run of such
nodes (a stage, ended by whatever reads the vector as a scalar: a
``VecSum`` sums it in f64, a constant-index ``Gather`` captures one
element), and the reverse pass one loop per run that recomputes the
body's values, seeds their adjoints from the stage's readers, and runs
their adjoints back; a scalar's adjoint summed over the elements is
accumulated in f64.

Each derivative follows the convention of ``jax.grad`` (the reference):
``min``/``max`` split the adjoint at ties, ``abs`` has derivative 1 at 0,
``pow``'s exponent adjoint uses ``log(x == 0 ? 1 : x)``, ``lgamma``'s is
a hand-written digamma, and ``softplus``/``logistic`` use stable forms.

A model with data is emitted in the split of
``CompiledDensity.row_split``: the base terms (prior and every likelihood
that is not a top-level ``RowSum`` reading columns row by row) as
``rt_logp_grad``, and the children of the top-level ``RowSum``s as per-row
functions that read one row of their columns from a tile and accumulate
their adjoints.  The ``RowSum``s whose columns have one length form a
row space: one row function, one tile layout and one tile loader each.
A header of one space names them ``rt_row`` and ``rt_fill_tile``; one of
several defines ``RT_SPACES`` and an
``RtSpace<s>`` each.  The nodes under a row function that do not vary by
row are *row-invariant*: ``rt_rows_pre`` computes the ones the rows read
once per density call, the row functions accumulate their adjoints over
the rows, and ``rt_rows_post`` runs their reverse pass once after the
last row — reverse mode through a broadcast, as the lanes evaluator's
(1, C)-against-(n, C) broadcasting is.  ``MatVec`` is p multiply-adds per
row, and a ``Column`` view of a ``MatColumn`` that the tile holds reads
the matrix's entry.  A space's tiles hold as many rows as two of them
fit a block's shared memory, at most ``TILE_ROWS_MAX`` (``tile_rows``).
The tile loader (``_fill``, ``rt_fill_tile``) issues a thread's share of
a tile as asynchronous copies, a batch of rows at a time, which the tile
loop waits for at once or, in a launch that streams its columns through
two tile slots (every launch with rows, unless told not to), a tile
later; a space whose rows fit one tile is loaded once a launch
(``RT_RESIDENT``).  A
row of at least ``ROW_STEP_OPS`` operations and at most
``ROW_STEP_FLOATS`` floats also comes as ``rt_row_step``, which sums
``ROW_STEP`` of a lane's rows: their forward passes first, in one block
of straight-line code, then their reverse passes in row order
(``_row_step``).  A ``LogSumExp``'s adjoint in a row reads the
shifted exponentials of its forward pass and divides them by their sum
without a branch (``rt_lse_share``).

Outside the rows a column is read whole, from its device pointer, the
way the JAX kernel's untiled branch reads its columns
(rainier_tpu/ops/hmc_pallas.py:282-301): a column that a base term reads,
or that a row reads through what sums or indexes it (a ``RowSum`` or
``VecSum`` of it, a ``Gather`` from it, the ``MatVec`` of a matrix by a
vector) is a vector of its k rows, ``cols.c<j>[i]``, a loop past
``UNROLL_MAX`` rows; the ``MatVec`` of a matrix read whole by a vector of
at most ``UNROLL_MAX`` elements is a vector of its rows, and its reverse
pass adds the matrix's transpose times the adjoint into the vector's.
The values are read at every call, never baked into the source, so
``Model.with_data`` swaps them under one build.  Such a header defines
``RT_WHOLE_COLS``, and its functions outside the rows take the columns.

A node that reads a vector past the unroll whole, not element by
element, is a stage of its own, and the vector is held where the node
can address any element: a parameter in q and g, anything else in the
density's scratch ``scr`` (``RT_SCRATCH`` floats a call: per thread in a
register model, in the chain's slot over the workspace), written by the
loop that computes it, its adjoint taken back by that loop's reverse.
Two such readers:

* the ``MatVec`` of a matrix read whole by a vector past the unroll (an
  ``MVNormal`` latent of 17 or more dimensions: L·z) is computed by a
  pass of its own into scr, the lanes of a slot splitting its rows, and
  read there like a parameter, a constant-index ``Gather`` of it
  included; its adjoint is added there, and a second pass, the lanes
  splitting the columns, adds Lᵀ times it into the vector's.  Over the
  workspace the passes read L where _mat_layout puts it: in the block's
  shared memory, staged once a launch at a row stride of p + 1 floats
  (the 64 × 64 factor of a 64-input GP takes 16.6 KB), or, where it does
  not fit beside the slots or tiles (a 256-input GP's, 263 KB), a
  transposed copy for the forward pass, bound after the columns; a
  register model reads it from its device pointer, every lane the same
  address.  Warp barriers order the passes with what the other lanes
  read;
* a ``Gather`` by an ``IntColumn`` read whole (a nested ``RowSum`` of a
  gather) reads the source at each row's clamped index; its adjoints are
  summed in f64 by source entry and added to the source's adjoint after
  the last.  Its loops split their elements over the chain's lanes even
  in a register model (lane l takes l, l + 32, ...), where each lane
  keeps partial sums, the adjoints' by entry in a per-thread array up to
  ``ENTRY_LOCAL_MAX`` entries and in the slot, a copy a lane, past them;
  the lanes' sums meet in the butterfly in a fixed order, with no
  atomics, so every lane holds the same bits and the kernel is
  bit-reproducible.

An ``IntColumn`` is an int32 field of the tile row, carried bit for bit in
its float slot, so every int32 index is exact.  A ``Gather`` of a
row-invariant vector by it reads ``inv[k + clamp(i, 0, K - 1)]`` from the
vector's contiguous block of the row-invariant values (the clamp is
``mode="clip"`` of the lanes evaluator's take) and scatters its adjoint
to entry ``k + clamp(i, 0, K - 1)``.  A chain with rows is a warp whose
32 lanes split the rows, and lanes hit one entry together, so the
scatter must sum them in a fixed order without atomics: in per-thread
arrays the row adds into its lane's own ``ainv``, which the kernel sums
over the lanes after the last row; over the workspace the row hands the
entry and the adjoint back (``sidx[g]``, ``sval[g]``, one pair per
per-row gather, ``RT_GATHERS`` or ``RtSpace<s>::kGathers``), and the warp
adds each step's into the chain's ``ainv`` (``rt_scatter``).  A
``Lookup`` by an ``IntColumn`` compares the int index with each table
entry, as for a float index.

The row-invariant values that only a per-row gather reads have their
adjoints accumulated over all rows; the ones every row reads come first
in ``inv`` (``RT_NINV_DENSE``), each lane sums their adjoints over its
rows of a tile, and the kernel adds the lanes' in f32 per tile and f64
across tiles.  A row-invariant vector of the rows' length that a row
reads by element (``b * Column`` with b of n elements over n rows: the
lanes evaluator's (n, C) against (n, 1)) is element i at row i: the tile
holds each row's index after its columns (``rix``), the row reads
``inv[k + rix]`` and adds its adjoint at that entry, which no other row
of the space has, so it needs no hand-back and no scatter.  Over the
workspace, where the vector is a parameter vector or an elementwise
function of one, the row reads the parameter from the chain's state at
``rix`` (``q[a + rix]``), computes the function there, and adds the
adjoint to ``g[a + rix]``: the vector has no copy in inv or ainv, and
rt_rows_pre and rt_rows_post no pass over it (``RT_ROW_STATE``: such a
row function takes the chain's state, gradient and own ainv).  A
``Gather`` by an ``IntColumn`` whose source varies by row rebuilds the
source's per-row subgraph at row ``clamp(index, 0, n - 1)``, under names
of its own, and runs its adjoints back in the row.  The tile loader
reads each row's index, clamps it, and loads the source's columns at
that row into fields of the tile after the row's own (and ``rix``), so
the block's threads make one random read a row for all its chains and
the row reads only the tile.  A gather inside a rebuilt source reads
its source's columns from their device pointers, and then the row
functions take the columns (``RT_ROW_COLS``).  Rebuilding costs the
source's operations a row again, where the alternative, the source over
all rows in a workspace filled by a first pass, costs a second pass over
the rows and n floats a chain.

A model over ``LANE_STATE_MAX`` parameters or row-invariant values keeps
its chain state in a slot of a workspace (``RT_WS_FLOATS`` floats a
chain, csrc/fused_hmc.cu; in device memory, or for a model without rows
up to ``LOCAL_STATE_MAX`` parameters in the block's shared memory): its
functions then take ``__restrict__`` pointers,
its loops split their elements over the ``RT_LANES`` lanes of the chain
(lane l takes l, l + 32, ...) and are unrolled by eight, so that loads of
several elements are in flight, their sums are lane partials added up by
``RT_SUM``, an element read as a scalar comes from its lane
(``RT_BCAST``), and a parameter's scalar adjoint is added to ``g`` by lane
0 alone.  Smaller models emit exactly the text they did before the
workspace existed.

A model without rows runs each chain on ``RT_LANES`` lanes, an aligned
group of a warp's (csrc/fused_hmc.cu; ``ops/fused_hmc.py::lanes_per_chain``
chooses how many).  Up to ``LANE_STATE_MAX`` parameters its text is the
one-thread text above, every lane holding the whole state and running
the density, and the build defines ``RT_LANES``: one text serves every
lane count.  Past it, the workspace code above, the chain's slot in the
block's shared memory up to ``LOCAL_STATE_MAX`` parameters
(``RT_WS_SHARED``) and in the device workspace past it, a warp a chain
(``RT_LANES`` 32 unless the build defines it), with every vector of more
than one element a loop split over the lanes.  Scalars run in every
lane, with the same bits in each.  A model that multiplies a matrix read
whole by a vector (an ``MVNormal`` prior without rows) keeps its vectors
of up to ``UNROLL_MAX`` unrolled there, in every lane; a longer vector's
product is held in scr (above).

Outside the envelope, :class:`UnsupportedNode` names what is wrong, the
forms the lanes evaluator cannot broadcast either: a ``Gather`` whose
index is neither a constant nor an ``IntColumn`` (a float index), a
``MatColumn`` other than as ``MatVec``'s matrix, a per-row value of a
vector width other than 1 or the rows', and one ``RowSum`` over columns
of two lengths; and an ``IntColumn`` used as a value, a row-invariant
vector of the rows' length read both by element and whole, and a
``MatVec`` whose vector varies by row.
"""

from __future__ import annotations

import math
import re
import weakref
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from . import real as R
from .compiler import NoRowSplit, find_columns

HEADER_NAME = "rt_model.h"


class UnsupportedNode(NotImplementedError):
    """The graph holds a node the CUDA emitter does not cover yet."""


# Row tiles: the power of two that holds all of a space's rows, at most
# TILE_ROWS_MAX, halved until two tiles fit the shared memory one block
# can use on an H100 (the tile loop fills one slot while the block reads
# the other); below TILE_ROWS_MIN rows the kernel does not take the
# model.  A tile's fill, its barriers and its wait cost the same however
# few rows it holds, so the tiles are as large as the shared memory lets
# them be (tile_rows)
TILE_ROWS_MAX = 4096
TILE_ROWS_MIN = 32
SMEM_BYTES_MAX = 232448
# Each thread of a tile loader takes FILL_BATCH rows at a time, fewer
# where it would hold more than FILL_VALUES values (_fill)
FILL_BATCH, FILL_VALUES = 8, 32
# A row of at least ROW_STEP_OPS operations and at most ROW_STEP_FLOATS
# floats in its tile is summed ROW_STEP rows a step by each lane
# (_row_step, row_step), where the kernel keeps the row-invariant values
# in registers: a register model, or a workspace model whose rows read
# every row-invariant value densely and at most INV_REGS_MAX of them
# (csrc/fused_hmc.cu, RT_INV_REGS)
ROW_STEP, ROW_STEP_OPS, ROW_STEP_FLOATS = 4, 48, 16
INV_REGS_MAX = 64

# Vectors longer than this are emitted as loops over their elements; the
# funnel's 9, the README's 3 and the logistic's 10 stay unrolled
UNROLL_MAX = 16

# Over this many parameters a chain without rows keeps its slot in the
# kernel's device-memory workspace, not in the block's shared memory
LOCAL_STATE_MAX = 256
# Over this many parameters or row-invariant values a chain's state lives
# in a slot, not in per-thread arrays: there every lane of a chain holds
# the whole state, and past a few dozen floats an array each spills to
# local memory that all the lanes read and write, where the slot splits
# each pass over the lanes (GLMMPoisson2, 146 parameters: 756 ms against
# 1,239 ms for 1024 chains x 500 iterations on an H100; the funnel at 100
# dims, 1.7-1.8 ms against 22.3 at one thread a chain for 1024 x 200 x 5;
# tools/kernel_ab.py layouts and columnfree, PERF.md §6)
LANE_STATE_MAX = 32

# Lanes of a chain with rows, or with a slot: the 32 threads of a warp
# split its rows and, over the slot, its passes (csrc/fused_hmc.cu,
# RT_LANES)
LANES = 32
# The most threads of a block (csrc/fused_hmc.cu, RT_MAX_THREADS)
BLOCK_THREADS_MAX = 256

# A loop that reads an index column whole splits its elements over the
# chain's lanes, and each lane sums its elements' adjoints of the gather's
# source by entry in f64: in a per-thread array up to ENTRY_LOCAL_MAX
# entries (a register model's every parameter vector), past it in the
# chain's slot, a copy a lane (RT_EADD, RT_EADD_SLOT in csrc/rt_math.cuh)
ENTRY_LOCAL_MAX = 32

# The workspace's arrays do not overlap: said to nvcc, it may issue the
# loads of later elements before the stores of earlier ones
_RESTRICT = " __restrict__"


def tile_rows(row_width: int, n_rows: int = TILE_ROWS_MAX) -> int:
    """Rows per tile of a space of `n_rows` rows of `row_width` floats:
    the power of two that holds them all, at least TILE_ROWS_MIN and at
    most TILE_ROWS_MAX, halved until two tiles fit shared memory (0 when
    even two TILE_ROWS_MIN-row tiles do not)."""
    r = min(TILE_ROWS_MAX, max(TILE_ROWS_MIN, 1 << (n_rows - 1).bit_length()))
    while 2 * r * row_width * 4 > SMEM_BYTES_MAX and r >= TILE_ROWS_MIN:
        r //= 2
    return r if r >= TILE_ROWS_MIN else 0


def row_step(row_width: int, row_ops: int) -> int:
    """Rows a lane sums in one step of straight-line code (_row_step):
    ROW_STEP for a row of at least ROW_STEP_OPS operations, whose
    dependent chain is long enough that several rows' chains overlapping
    pays for the step's registers, and of at most ROW_STEP_FLOATS floats,
    whose rows' values fit the registers beside the rest; else one.  On an
    H100, four rows a step took the marginalized mixture's kernel (59
    operations a row, one float) and the 100k logistic's (76, 11) to 0.70
    and 0.90 of their time, and made the zero-inflated geometric's (25,
    1) 7%, the README regression's (39, 4) 1%, the negative binomial's
    (17, 1) 3% and the 32-feature MVNormal logistic's (196, 33) 10%
    slower (tools/kernel_ab.py steps, PERF.md §6)."""
    return ROW_STEP if (row_ops >= ROW_STEP_OPS
                        and row_width <= ROW_STEP_FLOATS) else 1


@dataclass(frozen=True)
class EmittedDensity:
    source: str           # the rt_model.h text
    n_vars: int
    ops: int              # f32 operations of one logp + gradient, apart
                          # from the row terms: the base terms plus the
                          # row-invariant forward and reverse passes
    spaces: tuple = ()    # SpaceTiles of each row space, in the kernel's
                          # order (empty: no row terms)
    n_inv: int = 0        # row-invariant values the row functions read
    workspace: int = 0    # floats of one chain's slot in the kernel's
                          # workspace (0: state in registers)
    shared: bool = False  # the slot lies in the block's shared memory,
                          # not in the device-memory workspace
    scratch: int = 0      # floats of scr a density call uses (the
                          # products held there, buffered vectors)
    staged: int = 0       # floats of the block's shared memory that the
                          # product passes' matrices take (_mat_layout)
    transposed: tuple = ()  # the columns whose transposed copies the
                            # wrapper binds after the columns

    @property
    def n_rows(self) -> int:
        """Rows of every row space."""
        return sum(s.n_rows for s in self.spaces)

    @property
    def row_width(self) -> int:
        """Floats of the widest space's row (0: no row terms)."""
        return max((s.row_width for s in self.spaces), default=0)

    @property
    def tile_rows(self) -> int:
        """The fewest rows of a space's tile (0: a row too wide)."""
        return min((s.tile_rows for s in self.spaces), default=0)

    @property
    def row_ops(self) -> int:
        """f32 operations of one row's forward + adjoints, the most of any
        space."""
        return max((s.row_ops for s in self.spaces), default=0)

    def row_bytes(self) -> int:
        """Bytes of every space's tiles over all its rows."""
        return sum(4 * s.n_rows * s.row_width for s in self.spaces)

    def density_ops(self) -> int:
        """f32 operations of one density + gradient over all rows."""
        return self.ops + sum(s.n_rows * s.row_ops for s in self.spaces)


def _lit(v: float) -> str:
    v = float(np.float32(v))
    if math.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    return f"{v!r}f" if "e" in repr(v) or "." in repr(v) else f"{v!r}.0f"


# forward expression and f32 op count per unary op (x: input)
_UNARY = {
    "neg": ("(-{x})", 1), "exp": ("expf({x})", 1), "log": ("logf({x})", 1),
    "log1p": ("log1pf({x})", 1), "expm1": ("expm1f({x})", 1),
    "abs": ("fabsf({x})", 1), "sqrt": ("sqrtf({x})", 1),
    "sin": ("sinf({x})", 1), "cos": ("cosf({x})", 1),
    "tan": ("tanf({x})", 1), "asin": ("asinf({x})", 1),
    "acos": ("acosf({x})", 1), "atan": ("atanf({x})", 1),
    "sinh": ("sinhf({x})", 1), "cosh": ("coshf({x})", 1),
    "tanh": ("tanhf({x})", 1), "logistic": ("rt_sigmoid({x})", 3),
    "logit": ("(logf({x}) - log1pf(-{x}))", 4),
    "softplus": ("rt_softplus({x})", 5), "lgamma": ("lgammaf({x})", 1),
}

# adjoint contribution to the input per unary op (a: output adjoint,
# v: output value, x: input value) and its op count
_UNARY_ADJ = {
    "neg": ("(-{a})", 1), "exp": ("{a} * {v}", 1),
    "log": ("{a} / {x}", 1), "log1p": ("{a} / (1.0f + {x})", 2),
    "expm1": ("{a} * ({v} + 1.0f)", 2),
    "abs": ("({x} >= 0.0f ? {a} : -{a})", 2), "sqrt": ("{a} * (0.5f / {v})", 2),
    "sin": ("{a} * cosf({x})", 2), "cos": ("{a} * (-sinf({x}))", 3),
    "tan": ("{a} * (1.0f + {v} * {v})", 3),
    "asin": ("{a} / sqrtf(1.0f - {x} * {x})", 4),
    "acos": ("(-{a}) / sqrtf(1.0f - {x} * {x})", 5),
    "atan": ("{a} / (1.0f + {x} * {x})", 3),
    "sinh": ("{a} * coshf({x})", 2), "cosh": ("{a} * sinhf({x})", 2),
    "tanh": ("({a} + {a} * {v}) * (1.0f - {v})", 4),
    "logistic": ("{a} * {v} * (1.0f - {v})", 3),
    "logit": ("({a} / {x} + {a} / (1.0f - {x}))", 4),
    "softplus": ("{a} * expf({x} - {v})", 3),
    "lgamma": ("{a} * rt_digamma({x})", 20),
}

_BINARY = {"add": "({x} + {y})", "sub": ("({x} - {y})"),
           "mul": "({x} * {y})", "div": "({x} / {y})",
           "pow": "powf({x}, {y})", "min": "fminf({x}, {y})",
           "max": "fmaxf({x}, {y})"}

_PRED = {"eq": "==", "lt": "<", "gt": ">", "lte": "<=", "gte": ">="}


def _children_checked(node):
    if isinstance(node, R.Gather) and not isinstance(
            node.index, (R.Constant, R.IntColumn)):
        raise UnsupportedNode(
            "Gather by an index that is neither a constant nor an "
            "IntColumn is not supported by the CUDA emitter")
    return R.children_of(node)


class _Emitter:
    def __init__(self, cd, ws: bool = False, unroll: int = UNROLL_MAX):
        self.cd = cd
        self.ws = ws                      # state in the workspace
        self.unroll = unroll              # longest vector kept unrolled
        self.fwd: list[str] = []
        self.rev: list[str] = []
        self.vals: dict[int, list[str]] = {}
        self.adj: dict[int, list[str]] = {}
        self.grad: dict[int, bool] = {}
        self.params: set[int] = set()     # parameter nodes: adjoints in g
        self.scatters = 0      # per-row gathers' adjoints a row hands back
        self.n_dense = 0       # row-invariant values some row reads other
                               # than by a per-row gather (first in inv)
        self.fops = 0
        self.rops = 0
        self.lse: dict[int, tuple] = {}   # LogSumExp node → (its
                                          # exponentials, sums)
        self.mats: dict[int, int] = {}    # MatColumn → offset in the row
        self.ints: dict[int, str] = {}    # IntColumn → its int32 in the row
        self.inv_base: dict[int, int] = {}  # row-invariant node → its
                                            # first slot in inv / ainv
        self.col_index = {c.id: j for j, c in enumerate(cd.columns)}
        self.wmats: dict[int, int] = {}   # MatColumn read whole → its
                                          # index among the columns
        self.loop_len: dict[int, int] = {}  # vector emitted as a loop over
                                            # i → its length
        self.mult = 1          # elements one emitted line stands for
        self.loop_acc = None   # in a reverse loop body: scalar node id →
                               # its adjoint's f64 sum over the elements
        self.tag = ""          # prefix of the names (a rebuilt source's)
        self.addr = {}         # vector node → (value, adjoint) formats of
                               # its element {} (a parameter, a product
                               # held in the scratch, a buffered input)
        self.mv = {}           # MatVec read whole past the unroll → its
                               # value's and adjoint's offsets in scr
        self.buf = set()       # nodes buffered in scr for a whole reader
        self.sums = {}         # Gather by an index column read whole → the
                               # offset in scr of its f64 adjoint sums
        self.scratch = 0       # floats of scr the function uses
        self.wints = {}        # IntColumn read whole → its column index
        self.rowctx = None     # in a row function: its _RowCtx
        self.aligned = []      # (adjoint name, array, index, whether at
                               # the row's own index) of each vector read
                               # at a row
        self.subs = {}         # a row-varying Gather → (emitter, nodes)
                               # of its rebuilt source
        self.row_cols = False  # a row reads columns from their device
                               # pointers (a gather nested in a rebuilt
                               # source: _bind_row)
        self.split = ws        # the loop being emitted splits its
                               # elements over the lanes
        self.lanes = False     # some loop of a register model splits
        self.sum_mode = {}     # Gather by an index column read whole →
                               # where its adjoint sums lie ("local",
                               # "slot" or "plain": _gather_sums)
        self.products = {}     # over the workspace, the column index of
                               # each matrix a product pass reads → its
                               # (rows, columns) (_mat_layout)

    # -- helpers ----------------------------------------------------------
    def size(self, node) -> int:
        return self.loop_len.get(node.id) or len(self.vals[node.id])

    def el(self, node, i: int) -> str:
        v = self.vals[node.id]
        return v[i] if len(v) > 1 else v[0]

    def bsize(self, nodes) -> int:
        sizes = {self.size(n) for n in nodes} - {1}
        if len(sizes) > 1:
            raise UnsupportedNode(
                f"cannot broadcast vector lengths {sorted(sizes)}")
        return sizes.pop() if sizes else 1

    def alloc(self, n: int, align: int = 1) -> int:
        """n floats of scr at an offset that `align` divides; returns the
        offset."""
        self.scratch += -self.scratch % align + n
        return self.scratch - n

    def leaf(self, node) -> bool:
        """Whether the node's adjoint is an array outside the function's
        scalars (g, or scr for a product held there), which its own
        backward does not propagate."""
        return isinstance(node, (R.Parameter, R.VectorParameter)) \
            or node.id in self.mv

    def entry_add(self, node, i: int, expr: str) -> str:
        """The adjoint `expr` of element i of a Gather by an index column
        read whole, added to its f64 sum by source entry: in a loop split
        over the lanes to the lane's own sums (_gather_sums), in a slot
        outside a loop by lane 0 alone."""
        nid, k = node.id, self.size(node.source)
        j = f"j{self.tag}{nid}_{i}"
        mode = self.sum_mode[nid]
        if mode == "local":
            return f"  RT_EADD(d{nid}, {k}, i, {j}, {expr});"
        if mode == "slot":
            return f"  RT_EADD_SLOT(d{nid}, i, {j}, {expr});"
        if self.ws:
            return f"  if (RT_LANE == 0) d{nid}[{j}] += {expr};"
        return f"  d{nid}[{j}] += {expr};"

    def width(self, nodes) -> tuple[int, int]:
        """(length of the broadcast, expressions to emit): one, the loop
        body's, where a node is a loop."""
        n = self.bsize(nodes)
        return n, 1 if any(k.id in self.loop_len for k in nodes) else n

    def define(self, node, exprs: list[str], ops_each: int,
               n: int = 0) -> None:
        """Name each expression; a vector of length n > 1 given as one
        expression is a loop."""
        names = []
        for i, e in enumerate(exprs):
            name = f"v{self.tag}{node.id}" + (
                f"_{i}" if len(exprs) > 1 else "")
            self.fwd.append(f"  const float {name} = {e};")
            names.append(name)
        self.vals[node.id] = names
        if len(exprs) == 1 and n > 1:
            self.loop_len[node.id] = n
        self.fops += ops_each * len(exprs) * self.mult

    def acc(self, node, i: int, expr: str, ops: int) -> None:
        """adjoint(node)[i] += expr (broadcast children accumulate); in a
        loop body a scalar's adjoint sums over the elements in f64."""
        if not self.grad[node.id]:
            return
        if self.loop_acc is not None and node.id not in self.loop_len:
            j = i if len(self.adj[node.id]) > 1 else 0
            target = self.loop_acc.setdefault(
                (node.id, j), f"t{node.id}" + (
                    f"_{j}" if len(self.adj[node.id]) > 1 else ""))
            self.rev.append(_part_add(self.split, target, expr))
        else:
            a = self.adj[node.id]
            self.rev.append(_add_to(self, node.id,
                                    a[i if len(a) > 1 else 0], expr))
        self.rops += (ops + 1) * self.mult

    # -- forward ----------------------------------------------------------
    def forward(self, node) -> None:
        nid = node.id
        layout = self.cd.layout
        if nid in self.vals or nid in self.mats or nid in self.ints \
                or nid in self.wmats:
            return          # bound by the caller: a row's column or an input
        if nid in self.mv:
            self._held_product(node)
            return
        if isinstance(node, R.Constant):
            self.vals[nid] = [_lit(node.value)]
            self.grad[nid] = False
            return
        if isinstance(node, (R.Parameter, R.VectorParameter)):
            if node not in layout.parameters:
                raise UnsupportedNode(f"parameter {node!r} outside layout")
            a, b = layout.slices[layout.parameters.index(node)]
            self.addr[nid] = (f"q[{a} + {{}}]", f"g[{a} + {{}}]")
            if b - a > self.unroll:
                self.loop_len[nid] = b - a
                self.vals[nid] = [f"q[{a} + i]"]
                self.adj[nid] = [f"g[{a} + i]"]
            else:
                self.vals[nid] = [f"q[{j}]" for j in range(a, b)]
                self.adj[nid] = [f"g[{j}]" for j in range(a, b)]
            self.grad[nid] = True
            self.params.add(nid)
            return
        if isinstance(node, (R.Column, R.IntColumn, R.MatColumn)):
            self._whole_column(node)
            return
        kids = _children_checked(node)
        for k in kids:
            if (k.id in self.mats or k.id in self.wmats) and not (
                    isinstance(node, R.MatVec) and k is node.mat):
                raise UnsupportedNode(
                    "a MatColumn used other than as MatVec's matrix is not "
                    "supported by the CUDA emitter")
            if (k.id in self.ints or k.id in self.wints) and not (
                    isinstance(node, (R.Gather, R.Lookup))
                    and k is node.index):
                raise UnsupportedNode(
                    "an IntColumn used other than as the index of a Gather "
                    "or a Lookup is not supported by the CUDA emitter")
        if isinstance(node, R.Compare):
            self.grad[nid] = False
        elif isinstance(node, R.Select):
            self.grad[nid] = (self.grad[node.if_true.id]
                              or self.grad[node.if_false.id])
        elif isinstance(node, R.Lookup):
            self.grad[nid] = any(self.grad[t.id] for t in node.table)
        else:
            self.grad[nid] = any(self.grad[k.id] for k in kids)

        if isinstance(node, R.Unary):
            fmt, ops = _UNARY[node.op]
            n, m = self.width([node.child])
            self.define(node, [fmt.format(x=self.el(node.child, i))
                               for i in range(m)], ops, n)
        elif isinstance(node, R.Binary):
            n, m = self.width([node.left, node.right])
            self.define(node, [_BINARY[node.op].format(
                x=self.el(node.left, i), y=self.el(node.right, i))
                for i in range(m)], 1, n)
        elif isinstance(node, R.NArySum):
            n, m = self.width(node.children)
            self.define(node, ["(" + " + ".join(
                self.el(c, i) for c in node.children) + ")"
                for i in range(m)], len(node.children) - 1, n)
        elif isinstance(node, R.LogSumExp):
            # pairwise max, shifted exp sum: the lanes evaluator's formula;
            # in a row each shifted exponential is named, and the adjoint
            # reads it there rather than calling expf again (elsewhere the
            # adjoint calls it again, the text of the functions outside the
            # rows as it was)
            n, w = self.width(node.children)
            es, ss, outs = [], [], []
            for i in range(w):
                xs = [self.el(c, i) for c in node.children]
                m = xs[0]
                for x in xs[1:]:
                    m = f"fmaxf({m}, {x})"
                mname = f"m{self.tag}{nid}_{i}"
                sname = f"s{self.tag}{nid}_{i}"
                self.fwd.append(f"  const float {mname} = {m};")
                exps = [f"expf({x} - {mname})" for x in xs]
                if self.rowctx is not None:
                    names = [f"e{self.tag}{nid}_{i}_{k}"
                             for k in range(len(xs))]
                    self.fwd += [f"  const float {e} = {x};"
                                 for e, x in zip(names, exps)]
                    exps = names
                self.fwd.append(f"  const float {sname} = "
                                f"{' + '.join(exps)};")
                es.append(exps)
                ss.append(sname)
                outs.append(f"{mname} + logf({sname})")
            self.fops += n * 4 * len(node.children)
            self.define(node, outs, 2, n)
            self.lse[nid] = (es, ss)
        elif isinstance(node, R.Select):
            n, w = self.width([node.left, node.right, node.if_true,
                               node.if_false])
            op = _PRED[node.pred]
            conds = []
            for i in range(w):
                c = f"c{self.tag}{nid}_{i}"
                self.fwd.append(f"  const bool {c} = {self.el(node.left, i)}"
                                f" {op} {self.el(node.right, i)};")
                conds.append(c)
            self.define(node, [f"({c} ? {self.el(node.if_true, i)} : "
                               f"{self.el(node.if_false, i)})"
                               for i, c in enumerate(conds)], 2, n)
        elif isinstance(node, R.Compare):
            n, w = self.width([node.left, node.right])
            self.define(node, [f"rt_sign({self.el(node.left, i)} - "
                               f"{self.el(node.right, i)})"
                               for i in range(w)], 2, n)
        elif isinstance(node, R.Lookup):
            int_ix = self.ints.get(node.index.id)
            n, w = self.width(list(node.table) if int_ix else
                              [node.index] + list(node.table))
            outs = []
            for i in range(w):
                ix = f"i{self.tag}{nid}_{i}"
                src = int_ix or (self.el(node.index, i)
                                 if node.index.id in self.wints
                                 else f"rt_f2i({self.el(node.index, i)})")
                self.fwd.append(f"  const int {ix} = {src} - {node.low};")
                outs.append("(" + " + ".join(
                    f"({ix} == {k} ? {self.el(t, i)} : 0.0f)"
                    for k, t in enumerate(node.table)) + ")")
            self.define(node, outs, 2 * len(node.table), n)
        elif isinstance(node, (R.VecSum, R.RowSum)):
            # a child of one element is added once per row or element (the
            # lanes evaluator's v · count); a RowSum nested in a term sums
            # its child over whole columns
            c = node.child
            if c.id in self.loop_len:
                # the child's loop sums it into r<id> in f64
                self.define(node, [f"(float)r{nid}"], 0)
            elif self.size(c) == 1:
                self.define(node, [f"({self.el(c, 0)} * "
                                   f"{_lit(_count(node))})"], 1)
            else:
                self.define(node, ["(" + " + ".join(self.vals[c.id]) + ")"],
                            self.size(c) - 1)
        elif isinstance(node, R.MatVec):
            # one row of the matrix times a row-invariant vector; a matrix
            # read whole gives a vector of its rows
            p = node.mat.n_cols
            if self.size(node.vec) != p:
                raise UnsupportedNode(
                    f"MatVec of a {p}-column matrix by a vector of "
                    f"{self.size(node.vec)}")
            if node.mat.id in self.mats:
                rows, n = [None], 1
            elif node.vec.id in self.loop_len:
                # computed by a pass of its own into scr (_product_pass)
                self.mv[nid] = (self.alloc(node.mat.n_rows),
                                self.alloc(node.mat.n_rows))
                self._held_product(node)
                return
            else:
                n = node.mat.n_rows
                rows = ["i"] if n > self.unroll else list(range(n))
            self.define(node, ["(" + " + ".join(
                f"{self.mat_entry(node.mat, r, j)} * {self.el(node.vec, j)}"
                for j in range(p)) + ")" for r in rows], 2 * p - 1, n)
        elif isinstance(node, R.Gather):
            k = self.size(node.source)
            j = _static_slot(node, k)
            if self.rowctx is not None and self.rowctx.dep[node.source.id]:
                self._row_gather(node)
            elif j is not None and node.source.id in self.mv:
                self.define(node, [self.addr[node.source.id][0].format(j)],
                            0)
            elif j is not None and node.source.id in self.loop_len:
                # the source's loop keeps element j in k<id>
                self.define(node, [f"k{nid}"], 0)
            elif j is not None:
                self.define(node, [self.el(node.source, j)], 0)
            elif node.index.id in self.wints:
                # an index column read whole: each element's clamped index
                # into the source, read where it is held
                n, w = self.width([node.index])
                if node.source.id not in self.addr:
                    # buffered in scr by what computes it (_program)
                    vb, va = self.alloc(k), self.alloc(k)
                    self.buf.add(node.source.id)
                    self.addr[node.source.id] = (f"scr[{vb} + {{}}]",
                                                 f"scr[{va} + {{}}]")
                val = self.addr[node.source.id][0]
                outs = []
                for i in range(w):
                    jn = f"j{self.tag}{nid}_{i}"
                    self.fwd.append(f"  const int {jn} = rt_clampi("
                                    f"{self.el(node.index, i)}, 0, "
                                    f"{k - 1});")
                    outs.append(val.format(jn))
                self.define(node, outs, 3, n)
            else:
                # per-row index into the source's block of inv: clamp and
                # address, then the load
                base = self.inv_base[node.source.id]
                jn = f"j{self.tag}{nid}"
                self.fwd.append(f"  const int {jn} = rt_clampi("
                                f"{self.ints[node.index.id]}, 0, {k - 1});")
                self.define(node, [f"inv[{base} + {jn}]"], 3)
        else:
            raise UnsupportedNode(f"{type(node).__name__} is not yet "
                                  "supported by the CUDA emitter")
        if self.grad[nid]:
            names = [f"a{self.tag}{nid}" + (
                f"_{i}" if len(self.vals[nid]) > 1 else "")
                     for i in range(len(self.vals[nid]))]
            self.adj[nid] = names

    def _whole_column(self, node) -> None:
        """A column read whole, outside the rows of a top-level RowSum: a
        vector of its rows, each a load from its device pointer (a loop
        past UNROLL_MAX rows); a MatColumn only as MatVec's matrix, an
        IntColumn only as an index (its int32 loads)."""
        j, nid = self.col_index[node.id], node.id
        self.grad[nid] = False
        if isinstance(node, R.IntColumn):
            self.wints[nid] = j
        if isinstance(node, R.MatColumn):
            self.wmats[nid] = j
        elif node.n_rows > self.unroll:
            self.loop_len[nid] = node.n_rows
            self.vals[nid] = [f"cols.c{j}[i]"]
        else:
            self.vals[nid] = [f"cols.c{j}[{i}]" for i in range(node.n_rows)]

    def _held_product(self, node) -> None:
        """A MatVec of a matrix read whole by a vector longer than the
        unroll, held in scr (its value at mv[0], adjoint at mv[1]) by
        _product_pass: read there by element like a parameter, with its
        adjoint added there and taken back by the pass's transpose."""
        nid, n = node.id, node.mat.n_rows
        mo, ma = self.mv[nid]
        self.addr[nid] = (f"scr[{mo} + {{}}]", f"scr[{ma} + {{}}]")
        self.params.add(nid)
        self.grad[nid] = self.grad[node.vec.id]
        if n > self.unroll:
            self.loop_len[nid] = n
            self.vals[nid] = [f"scr[{mo} + i]"]
            self.adj[nid] = [f"scr[{ma} + i]"]
        else:
            self.vals[nid] = [f"scr[{mo + r}]" for r in range(n)]
            self.adj[nid] = [f"scr[{ma + r}]" for r in range(n)]

    def _row_gather(self, node) -> None:
        """A per-row Gather whose source varies by row: the source's
        per-row subgraph emitted again, under names of its own, at row
        clamp(index, 0, n - 1) (the JAX kernel's take over the whole
        source), and its adjoints run back in the row's reverse pass.
        The source's columns at that row are fields of the tile, which
        the loader fills from the gathered row (_gathered_fields)."""
        ctx, nid = self.rowctx, node.id
        jn = f"j{self.tag}{nid}"
        self.fwd.append(f"  const int {jn} = rt_clampi("
                        f"{self.ints[node.index.id]}, 0, "
                        f"{ctx.n_rows - 1});")
        sub = _Emitter(self.cd, self.ws, self.unroll)
        sub.tag = f"{self.tag}g{nid}_"
        # the row's own gathers read the source's columns from the tile,
        # where the loader put them at the gathered row; a gather inside
        # a rebuilt source reads them from their device pointers
        _bind_row(sub, ctx, jn, ctx.gathered.get(nid, {}) if not self.tag
                  else None)
        order = [n for n in R.topological([node.source])
                 if ctx.dep[n.id] or isinstance(n, R.Constant)]
        for n in order:
            sub.forward(n)
        self.row_cols = self.row_cols or sub.row_cols
        self.fwd += sub.fwd
        self.fops += sub.fops
        self.define(node, [sub.el(node.source, 0)], 0)
        self.subs[nid] = (sub, order)

    def _row_gather_adj(self, node, a) -> None:
        """The rebuilt source's reverse pass, seeded with the Gather's
        adjoint, in a block of its own."""
        sub, order = self.subs[node.id]
        if not sub.grad[node.source.id]:
            return
        sub.rev = []
        sub.scatters = self.scatters
        for n in reversed(order):
            sub.backward(n)
        self.rev += ["  {", *_indent([
            *_decls(sub, order), *_aligned_decls(sub),
            f"  {sub.adj[node.source.id][0]} += {a};", *sub.rev,
            *_aligned_adds(sub)]), "  }"]
        self.scatters = sub.scatters
        self.rops += sub.rops

    def mat_entry(self, mat, r, j) -> str:
        """Entry (r, j) of a MatColumn: column j of the tile's row (r is
        None), or of row r read whole (r an int, or "i" in a loop)."""
        if mat.id in self.mats:
            return self.mats[mat.id](j)
        p, c = mat.n_cols, self.wmats[mat.id]
        return (f"cols.c{c}[i * {p} + {j}]" if r == "i"
                else f"cols.c{c}[{r * p + j}]")

    # -- reverse ----------------------------------------------------------
    def backward(self, node) -> None:
        nid = node.id
        if not self.grad.get(nid) or self.leaf(node):
            return
        for i in range(len(self.vals[nid])):
            a = self.adj[nid][i]
            v = self.vals[nid][i]
            if isinstance(node, R.Unary):
                fmt, ops = _UNARY_ADJ[node.op]
                self.acc(node.child, i, fmt.format(
                    a=a, v=v, x=self.el(node.child, i)), ops)
            elif isinstance(node, R.Binary):
                self._binary_adj(node, i, a, v)
            elif isinstance(node, R.NArySum):
                for c in node.children:
                    self.acc(c, i, a, 0)
            elif isinstance(node, R.LogSumExp):
                es, ss = self.lse[nid]
                # in a row the division without a branch (rt_lse_share:
                # the bits of e / s)
                share = "rt_lse_share({}, {})" if self.rowctx is not None \
                    else "({} / {})"
                ops = 2 if self.rowctx is not None else 4
                for k, c in enumerate(node.children):
                    self.acc(c, i, f"{a} * {share.format(es[i][k], ss[i])}",
                             ops)
            elif isinstance(node, R.Select):
                c = f"c{self.tag}{nid}_{i}"
                self.acc(node.if_true, i, f"({c} ? {a} : 0.0f)", 1)
                self.acc(node.if_false, i, f"({c} ? 0.0f : {a})", 1)
            elif isinstance(node, R.Lookup):
                ix = f"i{self.tag}{nid}_{i}"
                for k, t in enumerate(node.table):
                    self.acc(t, i, f"({ix} == {k} ? {a} : 0.0f)", 1)
            elif isinstance(node, (R.VecSum, R.RowSum)):
                c = node.child
                if c.id in self.loop_len:
                    pass        # seeded in the child's loop
                elif self.size(c) == 1:
                    self.acc(c, 0, f"{a} * {_lit(_count(node))}", 1)
                else:
                    for j in range(self.size(c)):
                        self.acc(c, j, a, 0)
            elif isinstance(node, R.MatVec):
                # the matrix's transpose times the adjoint, into vec's
                r = None if node.mat.id in self.mats else (
                    "i" if nid in self.loop_len else i)
                for j in range(node.mat.n_cols):
                    self.acc(node.vec, j,
                             f"{a} * {self.mat_entry(node.mat, r, j)}", 1)
            elif isinstance(node, R.Gather):
                j = _static_slot(node, self.size(node.source))
                src = node.source
                if nid in self.subs:
                    self._row_gather_adj(node, a)
                elif j is not None and src.id in self.mv:
                    if self.grad[src.id]:
                        self.rev.append(_add_to(
                            self, src.id, self.addr[src.id][1].format(j),
                            a))
                        self.rops += 1
                elif j is not None and src.id in self.loop_len:
                    pass        # seeded in the source's loop
                elif j is not None:
                    self.acc(node.source, j, a, 0)
                elif node.index.id in self.wints:
                    # summed in f64 by source entry, each lane its own
                    # sums, added to the source's adjoint after the last
                    # (_gather_sums)
                    if self.grad[src.id]:
                        self.rev.append(self.entry_add(node, i, a))
                        self.rops += 2
                elif self.grad[node.source.id] and self.ws and \
                        self.inv_base[node.source.id] >= self.n_dense:
                    # the scatter into the chain's ainv, left to the warp:
                    # its lanes hit one entry together (csrc/fused_hmc.cu,
                    # rt_scatter)
                    base, g = self.inv_base[node.source.id], self.scatters
                    self.rev.append(f"  sidx[{g}] = {base} + "
                                    f"j{self.tag}{nid};")
                    self.rev.append(f"  sval[{g}] = {a};")
                    self.scatters += 1
                    self.rops += 2
                elif self.grad[node.source.id]:
                    # the scatter into the lane's own copy of ainv
                    base = self.inv_base[node.source.id]
                    self.rev.append(f"  ainv[{base} + j{self.tag}{nid}] "
                                    f"+= {a};")
                    self.rops += 2

    def _binary_adj(self, node, i, a, v):
        x, y = self.el(node.left, i), self.el(node.right, i)
        L, Rt = node.left, node.right
        op = node.op
        if op == "add":
            self.acc(L, i, a, 0)
            self.acc(Rt, i, a, 0)
        elif op == "sub":
            self.acc(L, i, a, 0)
            self.acc(Rt, i, f"(-{a})", 1)
        elif op == "mul":
            self.acc(L, i, f"{a} * {y}", 1)
            self.acc(Rt, i, f"{a} * {x}", 1)
        elif op == "div":
            self.acc(L, i, f"{a} / {y}", 1)
            self.acc(Rt, i, f"(-{a} * {x}) / ({y} * {y})", 4)
        elif op == "pow":
            self.acc(L, i, f"({y} == 0.0f ? 0.0f : {a} * {y} * "
                           f"powf({x}, {y} - 1.0f))", 4)
            self.acc(Rt, i, f"{a} * logf({x} == 0.0f ? 1.0f : {x}) * {v}", 3)
        elif op in ("min", "max"):
            # jax's balanced rule: ties split the adjoint in half
            self.acc(L, i, f"({x} == {v} ? ({y} == {v} ? 0.5f : 1.0f) : "
                           f"0.0f) * {a}", 3)
            self.acc(Rt, i, f"({y} == {v} ? ({x} == {v} ? 0.5f : 1.0f) : "
                            f"0.0f) * {a}", 3)
        else:  # pragma: no cover - BINARY_OPS is closed
            raise UnsupportedNode(op)


def _static_slot(node, k: int):
    """The slot a Gather from a k-vector reads when it is the same in every
    row: its constant index, clamped, or 0 for a scalar source; None for
    a per-row index."""
    if k == 1:
        return 0
    if isinstance(node.index, R.Constant):
        return min(max(int(node.index.value), 0), k - 1)
    return None


def _count(node) -> int:
    return node.k if isinstance(node, R.VecSum) else node.n_rows


def _add_to(em, nid: int, target: str, expr: str) -> str:
    """The statement target += expr for node nid's adjoint.  Over the
    workspace a parameter's adjoint outside a loop is an entry of g that
    every lane would add to at once, so lane 0 alone adds (the kernel
    syncs the warp before g is read)."""
    if em.ws and nid in em.params and nid not in em.loop_len:
        return f"  if (RT_LANE == 0) {target} += {expr};"
    return f"  {target} += {expr};"


def _seeds(em, roots) -> list[str]:
    """adjoint(root) += 1 for every root that depends on q (a loop's root
    is seeded in its loop)."""
    out = []
    for r in roots:
        if em.grad[r.id] and r.id not in em.loop_len:
            a = em.adj[r.id]
            out += [_add_to(em, r.id, a[i if len(a) > 1 else 0], "1.0f")
                    for i in range(em.size(r))]
    return out


def _decls(em, nodes) -> list[str]:
    """The scalar adjoints (a loop's are declared in its body)."""
    return [f"  float {a} = 0.0f;" for node in nodes
            if em.grad.get(node.id) and node.id not in em.loop_len
            and not em.leaf(node)
            for a in em.adj[node.id]]


def _indent(lines):
    return ["  " + line for line in lines]


class _Loop:
    """One loop of a function: vector nodes of one length k computed in
    one stage, and what reads them there (`outs`: (kind, vector node,
    reader) with kind "sum" for a VecSum or RowSum, "capture" for a
    constant-index Gather, "root" for a root of the function)."""

    def __init__(self, k):
        self.k = k
        self.outs = []
        self.body = []       # the nodes computed in the body, in order


def _program(em, roots, total=False, store=None, seed=None,
             reverse=True):
    """Code of one function over `roots` on the emitter `em`:
    (forward lines, reverse lines, terms of the roots' sum).

    Each node has a stage: a scalar that reads a loop's vector (its sum
    or one element) is one stage after it, and so is a node that reads a
    vector whole (a MatVec held in scr, a Gather by an index column read
    whole); every other node is at the latest of its children's.
    The forward pass emits, stage by stage, the products held in scr
    (_product_pass), the stage's scalars and then one loop per length
    over the vectors its readers need, recomputing vectors of earlier
    stages that the body reads; the reverse pass runs the stages
    backwards, each loop recomputing its body, seeding the adjoints of
    what its readers read and running the body's adjoints back, and a
    stage's products' transposes last.  A vector read whole that is
    neither a parameter nor such a product is buffered in scr by the
    loop or the lines that compute it, and its adjoint taken back from
    there.  A looped root adds to the total through an f64 sum (`total`),
    or `store(node, "i", value)` writes it out; `seed(node, "i")` is added
    to its adjoint (with `total`, 1).  `reverse=False` emits the forward
    pass only."""
    order = R.topological(roots)
    for node in order:                 # lengths and gradient flags
        em.forward(node)
    looped = dict(em.loop_len)
    whole = {}                         # reader id → the input it reads whole
    for node in order:
        if node.id in em.mv:
            whole[node.id] = node.vec
        elif isinstance(node, R.Gather) and node.index.id in em.wints:
            whole[node.id] = node.source
    stage = {}
    for node in order:
        stage[node.id] = max([stage[c.id] + (
            (c.id in looped and node.id not in looped)
            or whole.get(node.id) is c) for c in R.children_of(node)],
            default=0)
    loops = {}

    def out(kind, c, reader=None):
        key = (stage[c.id], looped[c.id])
        loops.setdefault(key, _Loop(key[1])).outs.append((kind, c, reader))

    flat = []                          # buffered inputs that are not loops
    gathers = [n for n in order if n.id in whole and n.id not in em.mv
               and em.grad[whole[n.id].id] and reverse]
    buffered = set()                   # each buffered input once
    for rid, c in whole.items():
        if c.id not in em.buf or c.id in buffered:
            continue
        buffered.add(c.id)
        if c.id in looped:
            out("buffer", c, next(n for n in order if n.id == rid))
        else:
            flat.append(c)
    for node in order:
        if node.id not in looped:
            for c in set(R.children_of(node)):
                if c.id not in looped or whole.get(node.id) is c or (
                        isinstance(node, R.Gather) and c.id in em.mv):
                    continue
                if not isinstance(node, (R.Gather, R.VecSum, R.RowSum)):
                    raise UnsupportedNode(
                        f"{type(node).__name__} reading a vector of "
                        f"{looped[c.id]} as a scalar is not supported by "
                        "the CUDA emitter")
                out("capture" if isinstance(node, R.Gather) else "sum", c,
                    node)
    for r in roots:
        if r.id in looped:
            out("root", r)
    for loop in loops.values():
        need = {c.id for _, c, _ in loop.outs}
        for node in reversed(order):
            if node.id in need:
                need.update(c.id for c in R.children_of(node)
                            if c.id in looped and whole.get(node.id) is not c)
        loop.body = [n for n in order if n.id in need]
    _split_loops(em, loops, gathers, whole, store)
    for g in gathers:
        if g.id not in em.sums and em.sum_mode[g.id] != "local":
            k = em.size(whole[g.id])
            em.sums[g.id] = em.alloc(
                2 * k * (LANES if em.sum_mode[g.id] == "slot" else 1), 2)

    em.vals, em.adj, em.lse, em.fops = {}, {}, {}, 0
    fwd, rev = [], []
    n_stages = max(stage.values(), default=0) + 1
    sync = ["  RT_WARP_SYNC();"] if em.ws else []
    for s in range(n_stages):
        em.fwd = fwd
        if any(stage[r] == s and whole[r].id in em.buf for r in whole):
            fwd += sync        # buffers written by other lanes
        for node in order:
            if stage[node.id] == s and node.id in em.mv:
                fwd += _product_pass(em, node)
        for g in gathers:
            if stage[g.id] == s:
                fwd += _gather_sums(em, g)
        for node in order:
            if stage[node.id] == s and node.id not in looped:
                em.forward(node)
                if node in flat:
                    fwd += _flat_buffer(em, node)
        for (ls, _), loop in sorted(loops.items()):
            if ls == s:
                fwd += _loop_forward(em, loop, total, store)
    terms = [t for r in roots for t in (
        [f"(float)r{r.id}"] if r.id in looped
        else [em.el(r, i) for i in range(em.size(r))])]
    # the lanes' own adjoint sums of the gathers that keep them in a
    # per-thread array, live from here to each one's flush
    rev += [f"  RT_EPART(d{g.id}, {em.size(whole[g.id])});" for g in gathers
            if em.sum_mode[g.id] == "local"]
    for s in reversed(range(n_stages if reverse else 0)):
        em.rev = rev
        for c in flat:
            if stage[c.id] == s and em.grad[c.id]:
                rev += sync
                for i in range(em.size(c)):
                    em.acc(c, i, em.addr[c.id][1].format(i), 0)
        for (ls, _), loop in sorted(loops.items(), reverse=True):
            if ls == s:
                rev += _loop_reverse(em, loop, total, seed)
        em.rev = rev
        for node in reversed(order):
            if stage[node.id] == s and node.id not in looped:
                em.backward(node)
        for g in gathers:
            if stage[g.id] == s:
                rev += _gather_sums(em, g, flush=True)
        for node in order:
            if stage[node.id] == s and node.id in em.mv:
                rev += _product_pass(em, node, transpose=True)
    em.fwd, em.rev = fwd, rev
    return fwd, rev, terms


def _split_loops(em, loops, gathers, whole, store) -> None:
    """Which loops split their elements over the chain's lanes
    (`loop.split`), and where each gather by an index column read whole
    sums its adjoints (`em.sum_mode`).  A workspace model splits every
    loop.  A register model, whose every lane holds the whole state,
    splits a loop that reads an index column whole where no lane needs
    what another computes for an element: its outputs are sums,
    captures and the function's total, it adds to no looped leaf's
    adjoint, and every gather in it from a source of at most
    ENTRY_LOCAL_MAX entries; its lanes' sums then meet in the butterfly,
    the same bits in every lane.  A gather in a loop that splits sums
    its adjoints by entry in each lane's own array ("local"), or past
    ENTRY_LOCAL_MAX in the lanes' copies in the slot ("slot"); otherwise
    whole ("plain")."""
    body = {id(loop): {n.id for n in loop.body} for loop in loops.values()}
    for loop in loops.values():
        loop.split = em.ws or (
            any(n.id in em.wints for n in loop.body)
            and all(kind in ("sum", "capture")
                    or (kind == "root" and store is None)
                    for kind, _, _ in loop.outs)
            and not any(em.leaf(n) and em.grad.get(n.id)
                        and n.id in em.loop_len for n in loop.body)
            and all(em.size(whole[g.id]) <= ENTRY_LOCAL_MAX
                    for g in gathers if g.id in body[id(loop)]))
    # a gather recomputed in several loops sums its adjoints one way
    changed = True
    while changed and not em.ws:
        changed = False
        for g in gathers:
            ls = [lp for lp in loops.values() if g.id in body[id(lp)]]
            if any(lp.split for lp in ls) and not all(lp.split for lp in ls):
                for lp in ls:
                    lp.split = False
                changed = True
    em.lanes = em.lanes or (not em.ws and any(
        lp.split for lp in loops.values()))
    for g in gathers:
        split = any(lp.split for lp in loops.values()
                    if g.id in body[id(lp)])
        em.sum_mode[g.id] = (
            "plain" if not split else
            "local" if em.size(whole[g.id]) <= ENTRY_LOCAL_MAX else "slot")


def _product_pass(em, node, transpose=False):
    """The MatVec of a matrix read whole by a vector longer than the
    unroll, computed into scr (its adjoint there set to 0), or, with
    `transpose`, its adjoint taken back: the matrix's transpose times the
    adjoint in scr, added into the vector's.  In a slot the lanes split
    the product's rows (its transpose's columns), each a sum over the
    other side, and a warp barrier on both sides orders them with what
    the other lanes read and write; there the passes read the matrix
    through RT_MAT<c> and RT_MAT<c>_T, where _mat_layout puts it (lane r
    reading row r of L from its device pointer would touch 32 cache
    lines a load), and the inner loops are unrolled by eight, so that
    several loads are in flight; each sum keeps its order, so the bits
    are those of the loop without the unroll."""
    mo, ma = em.mv[node.id]
    n, p = node.mat.n_rows, node.mat.n_cols
    c = em.wmats[node.mat.id]
    val, adj = em.addr[node.vec.id]
    sync = ["  RT_WARP_SYNC();"] if em.ws else []
    head = "  for (int {v} = RT_LANE; {v} < {n}; {v} += RT_LSTEP) {{" \
        if em.ws else "  for (int {v} = 0; {v} < {n}; ++{v}) {{"
    if em.ws:
        em.products[c] = (n, p)
        at, at_t, unroll = (f"RT_MAT{c}(r, j)", f"RT_MAT{c}_T(r, j)",
                            ["#pragma unroll 8"])
    else:
        at = at_t = f"cols.c{c}[r * {p} + j]"
        unroll = []
    if not transpose:
        em.fops += 2 * n * p
        return [*sync, head.format(v="r", n=n), "    float acc = 0.0f;",
                *unroll, f"    for (int j = 0; j < {p}; ++j)",
                f"      acc += {at} * {val.format('j')};",
                f"    scr[{mo} + r] = acc;", f"    scr[{ma} + r] = 0.0f;",
                "  }", *sync]
    if not em.grad[node.vec.id]:
        return []
    em.rops += 2 * n * p + p
    return [*sync, head.format(v="j", n=p), "    float acc = 0.0f;",
            *unroll, f"    for (int r = 0; r < {n}; ++r)",
            f"      acc += {at_t} * scr[{ma} + r];",
            f"    {adj.format('j')} += acc;", "  }", *sync]


def _mat_layout(products, block, budget=SMEM_BYTES_MAX):
    """Where the product passes of a workspace model read each matrix
    (`products`: column index → (rows n, columns p)): where the `block`
    bytes of the block's slots or tiles and the matrices at a row stride
    of p + 1 floats fit `budget` bytes of shared memory, staged there
    once a launch, where lane r of the forward pass, reading row r, and
    lane j of the transpose, reading column j, hit distinct banks; else
    the forward pass reads a transposed copy that the wrapper binds after
    the columns (cols.t<c>), and the transpose the matrix, both with
    neighbouring lanes on neighbouring addresses.  Returns (the header's
    lines: RT_MAT<c>, RT_MAT<c>_T, and where staged RT_SMEM_MATS and
    rt_stage_mats; the staged floats; the columns whose transposed
    copies are bound)."""
    if not products:
        return [], 0, ()
    if block + 4 * sum(n * (p + 1) for n, p in products.values()) > budget:
        return [line for c, (n, p) in sorted(products.items()) for line in (
            f"#define RT_MAT{c}(r, j) cols.t{c}[(j) * {n} + (r)]",
            f"#define RT_MAT{c}_T(r, j) cols.c{c}[(r) * {p} + (j)]")], 0, \
            tuple(sorted(products))
    defs, copies, off = [], [], 0
    for c, (n, p) in sorted(products.items()):
        defs += [f"#define RT_MAT{c}(r, j) cols.s{c}[(r) * {p + 1} + (j)]",
                 f"#define RT_MAT{c}_T(r, j) RT_MAT{c}(r, j)"]
        copies += [f"  for (int i = tid; i < {n * p}; i += nt)",
                   f"    smem[{off} + i / {p} * {p + 1} + i % {p}] = "
                   f"cols.c{c}[i];",
                   f"  cols.s{c} = smem + {off};"]
        off += n * (p + 1)
    return [
        *defs, f"#define RT_SMEM_MATS {off}", "",
        "// the matrices of the product passes, copied into the block's",
        "// shared memory by its threads tid of nt (csrc/fused_hmc.cu calls",
        "// it once a launch, then a barrier)",
        "RT_HD void rt_stage_mats(RtCols& cols, float* smem, int tid, "
        "int nt) {", *copies, "}"], off, ()


def _gather_sums(em, node, flush=False):
    """The f64 sums of a Gather by an index column read whole, one per
    source entry (d<id>): set to 0 before the forward pass has read
    anything, or, with `flush`, added to the source's adjoint once its
    reverse pass has added every element's.  By `em.sum_mode`: "local",
    each lane's sums in an array of its own (declared with the reverse
    pass), added up over the lanes in the butterfly's order and then to
    the adjoint, in a slot each entry by its lane; "slot", the lanes' copies
    in scr, entry e of lane l at e·RT_LANES + l, each entry's summed in
    the butterfly's order by the lane that adds it; "plain", one sum an
    entry in scr (in a slot the lanes split the entries).  A slot's
    passes have warp barriers around.  No atomics: the sums' order is
    fixed, so the kernel is bit-reproducible."""
    k, off, nid = em.size(node.source), em.sums.get(node.id), node.id
    mode = em.sum_mode[nid]
    sync = ["  RT_WARP_SYNC();"] if em.ws else []
    head = (f"  for (int k = RT_LANE; k < {k}; k += RT_LSTEP)" if em.ws
            else f"  for (int k = 0; k < {k}; ++k)")
    if not flush:
        if mode == "local":
            return []
        if mode == "slot":
            head = (f"  for (int k = RT_LANE; k < {k} * RT_LANES; "
                    "k += RT_LSTEP)")
        return [f"  double* d{nid} = (double*)(scr + {off});",
                f"{head} d{nid}[k] = 0.0;", *sync]
    em.rops += k
    adj = em.addr[node.source.id][1].format("k")
    if mode == "local":
        mine = "if (k % RT_LSTEP == RT_LANE) " if em.ws else ""
        return [f"  RT_ESUM(d{nid}, {k});", *sync, "#pragma unroll",
                f"  for (int k = 0; k < {k}; ++k) {mine}{adj} += "
                f"(float)d{nid}[k];", *sync]
    if mode == "slot":
        return [*sync, f"{head} {adj} += (float)rt_lane_tree<RT_LANES>("
                       f"d{nid} + (size_t)k * RT_LANES);", *sync]
    return [*sync, f"{head} {adj} += (float)d{nid}[k];", *sync]


def _flat_buffer(em, node):
    """An unrolled vector read whole, stored into its buffer in scr, its
    adjoint there set to 0 (in a slot by lane 0)."""
    val, adj = em.addr[node.id]
    lane0 = "if (RT_LANE == 0) " if em.ws else ""
    return [f"  {lane0}{{ {val.format(i)} = {em.el(node, i)}; "
            f"{adj.format(i)} = 0.0f; }}" for i in range(em.size(node))]


def _loop_body(em, loop):
    """The body's forward lines, its nodes (re)defined for element i."""
    for n in loop.body:
        em.vals.pop(n.id, None)
    em.fwd, em.mult = [], loop.k
    for n in loop.body:
        em.forward(n)
    return em.fwd


def _loop(em, k, pre, body, post):
    """A loop over the k elements.  In registers nvcc would unroll it to
    keep the arrays there; split over the lanes of a chain (over the
    workspace, or reading an index column whole) lane l takes l, l + 32,
    ... (RT_LANE, RT_LSTEP in csrc/rt_math.cuh), and unrolling by eight
    keeps loads of several elements in flight."""
    head = ("  for (int i = RT_LANE; i < {k}; i += RT_LSTEP) {{" if em.split
            else "  for (int i = 0; i < {k}; ++i) {{").format(k=k)
    return [*pre, f"#pragma unroll {8 if em.split else 1}", head,
            *_indent(body), "  }", *post]


def _part(split: bool, name: str) -> str:
    """The declaration of an f64 sum over a loop's elements: in a loop
    split over the lanes, a lane's partial sum, which _part_sum adds up
    over the lanes (RT_PART in csrc/rt_math.cuh)."""
    return f"  RT_PART(double, {name});" if split \
        else f"  double {name} = 0.0;"


def _part_add(split: bool, name: str, value: str) -> str:
    """Element i's value added to the sum `name`."""
    return f"  RT_ADD({name}, i, {value});" if split \
        else f"  {name} += {value};"


def _part_sum(split: bool, names) -> list[str]:
    """After the loop: the lanes' partial sums added up, the same bits in
    every lane."""
    return [f"  RT_SUM({n});" for n in names] if split else []


def _loop_forward(em, loop, total, store):
    """The forward loop: the body, then each reader's sum or element, and
    the roots' sum or store.  Empty where nothing reads the body in the
    forward pass."""
    if not any(kind != "root" or total or store is not None
               for kind, _, _ in loop.outs):
        return []
    em.split = loop.split
    body = _loop_body(em, loop)
    pre, post = [], []
    for kind, c, reader in loop.outs:
        v = em.el(c, 0)
        if kind == "sum" or (kind == "root" and total):
            r = f"r{reader.id if kind == 'sum' else c.id}"
            pre.append(_part(em.split, r))
            body.append(_part_add(em.split, r, v))
            post += _part_sum(em.split, [r])
            em.fops += loop.k
        elif kind == "capture":
            j = _static_slot(reader, loop.k)
            pre.append(f"  float k{reader.id} = 0.0f;")
            body.append(f"  if (i == {j}) k{reader.id} = {v};")
            if em.split:    # from the lane that holds element j
                post.append(f"  RT_BCAST(k{reader.id}, {j});")
        elif kind == "buffer":
            body += [f"  {em.addr[c.id][0].format('i')} = {v};",
                     f"  {em.addr[c.id][1].format('i')} = 0.0f;"]
        elif store is not None:
            body.append(store(c, "i", v))
    em.mult = 1
    out = _loop(em, loop.k, pre, body, post)
    em.split = em.ws
    return out


def _loop_reverse(em, loop, total, seed):
    """The reverse loop: the body recomputed, its adjoints declared and
    seeded from its readers (and roots), then run back; scalars' adjoints
    are summed over the elements in f64 and added after the loop."""
    em.split = loop.split
    body = _loop_body(em, loop)
    for n in loop.body:
        if em.grad[n.id] and not em.leaf(n):
            em.adj[n.id] = [f"a{n.id}"]
            body.append(f"  float a{n.id} = 0.0f;")
    for kind, c, reader in loop.outs:
        if not em.grad[c.id]:
            continue
        a = em.adj[c.id][0]
        if kind == "sum" and em.grad[reader.id]:
            body.append(f"  {a} += {em.adj[reader.id][0]};")
        elif kind == "capture" and em.grad[reader.id]:
            j = _static_slot(reader, loop.k)
            body.append(f"  {a} += (i == {j} ? {em.adj[reader.id][0]} "
                        ": 0.0f);")
        elif kind == "buffer" and em.grad[reader.id]:
            body.append(f"  {a} += {em.addr[c.id][1].format('i')};")
        elif kind == "root" and (total or seed is not None):
            body.append(f"  {a} += {'1.0f' if total else seed(c, 'i')};")
        else:
            continue
        em.rops += loop.k
    em.rev, em.loop_acc = body, {}
    for n in reversed(loop.body):
        em.backward(n)
    accs, em.loop_acc, em.mult = em.loop_acc, None, 1
    # a block of its own: another loop may sum into the same scalars
    out = ["  {", *_indent(_loop(
        em, loop.k, [_part(em.split, t) for t in accs.values()], body,
        [*_part_sum(em.split, accs.values()),
         *[_add_to(em, nid, em.adj[nid][j], f"(float){t}")
           for (nid, j), t in accs.items()]])),
        "  }"]
    em.split = em.ws
    return out


def _row_layout(columns, index=False):
    """Where each of a row space's columns sits in its tile row: ({column
    id: offset of its first float}, [floats loaded per column], row
    width).  A Column view of a MatColumn that the tile holds reads the
    matrix's entry and loads nothing of its own; an IntColumn takes one
    32-bit slot; with `index`, the row's own index takes one more after
    the columns (offs["rix"])."""
    held = {c.id for c in columns if isinstance(c, R.MatColumn)}
    offs, widths, w = {}, [], 0
    for c in columns:
        if isinstance(c, R.MatColumn):
            offs[c.id], width = w, c.n_cols
        elif (isinstance(c, R.Column) and c.matrix_ref is not None
              and c.matrix_ref[0].id in held):
            width = 0
        else:
            offs[c.id], width = w, 1
        widths.append(width)
        w += width
    for c in columns:
        if c.id not in offs:
            mat, j = c.matrix_ref
            offs[c.id] = offs[mat.id] + j
    if index:
        offs["rix"], w = w, w + 1
    return offs, widths, w


class SpaceTiles(NamedTuple):
    """One row space of an emitted density, as the kernel tiles it."""

    n_rows: int
    row_width: int      # floats of one row in a tile
    tile_rows: int      # rows per tile (0: even the least tile is too wide)
    row_ops: int        # f32 operations of one row's forward + adjoints


def _gathered_fields(cd, space, width):
    """The tile fields of the sources that a row of `space` rebuilds at
    another row: for each Gather by an IntColumn whose source varies by
    row, each column that its source reads, at the gathered row, in
    fields after the row's `width` floats: ({gather id: {column id:
    offset}}, [(index column, [(column, offset, floats)])], the row's
    width with them)."""
    own = {cd.columns[j].id for j in space.columns}
    gathered, loads = {}, []
    for node in R.topological(list(space.roots)):
        if not (isinstance(node, R.Gather)
                and isinstance(node.index, R.IntColumn)
                and space.dep[node.id] and space.dep[node.source.id]):
            continue
        fields, specs = {}, []
        for c in R.topological([node.source]):
            if isinstance(c, (R.Column, R.IntColumn, R.MatColumn)) \
                    and c.id in own:
                w = c.n_cols if isinstance(c, R.MatColumn) else 1
                fields[c.id] = width
                specs.append((c, width, w))
                width += w
        gathered[node.id] = fields
        loads.append((node.index, specs))
    return gathered, loads, width


def _fill(cd, space, offs, widths, row_w, loads=()):
    """The space's tile loader: rows [row0, row0 + rows) of each of its
    columns into the tile (`row_w` floats a row), thread tid of nt, as
    asynchronous copies (cp.async on the card, a plain copy in host code),
    and the row's index where the tile holds it (a plain store: it is not
    in device memory).  Every copy of a thread is in flight at once: the
    streamed tile loop commits them and waits a tile later, the
    synchronous one waits for them at once, which on an H100 loaded a tile
    as fast as a thread's loads of a batch of rows before any of its
    stores, and faster for a wide column (the 100k logistic's synchronous
    kernel 65.1 ms against 88.3 for 20 iterations, PERF.md §6), where a
    loop a column that stores each value before the next column's load
    waits out the latency of every load (the 32-feature MVNormal
    logistic's, 348.2 ms against 127.7).  Each thread takes a batch of b
    of its rows at a time (i0 + u·nt), and of each wide column (a
    MatColumn of w floats a row) the b·w floats of the batch's b·nt rows
    that fall to it in turn, neighbouring threads on neighbouring floats;
    b is FILL_BATCH rows, fewer where a row holds many values
    (FILL_VALUES).  A space whose rows rebuild sources at other rows
    (`loads`, _gathered_fields) loads each batch's indices and clamps
    them before any copy, and copies the rebuilt sources' columns at the
    clamped index into the tile, so that the block's threads make one
    random read a row for all its chains."""
    col = {c.id: j for j, c in enumerate(cd.columns)}
    n = space.n_rows
    copies, flats = [], []   # each row's copies; (column, offset, floats)
    at = f"tile[i * {row_w} + {{}}]"
    per_row = 0
    for j, w in zip(space.columns, widths):
        c = cd.columns[j]
        if w == 1:
            copies.append(f"rt_copy_async(&{at.format(offs[c.id])}, "
                          f"&cols.c{j}[row0 + i]);")
            per_row += 1
        elif w > 1:
            flats.append((j, offs[c.id], w))
            per_row += w
    if "rix" in offs:
        copies.append(f"{at.format(offs['rix'])} = rt_int_bits(row0 + i);")
    index = []
    for g, (ix, specs) in enumerate(loads):
        index.append(f"j{g}[u] = rt_clampi(cols.c{col[ix.id]}[r], 0, "
                     f"{n - 1});")
        for c, o, w in specs:
            k = col[c.id]
            src = (f"cols.c{k}[j{g}[u]]" if w == 1 else
                   f"cols.c{k}[(size_t)j{g}[u] * {w} + k]")
            dst = at.format(o if w == 1 else f"{o} + k")
            loop = f"for (int k = 0; k < {w}; ++k) " if w > 1 else ""
            copies.append(f"{loop}rt_copy_async(&{dst}, &{src});")
            per_row += w
    b = max(1, min(FILL_BATCH, FILL_VALUES // max(per_row, 1)))
    # every thread walks every batch of b·nt rows, rows w0 + tid + u·nt
    # its own, so that a thread whose rows end before the batch's still
    # copies its share of the batch's wide columns
    fill = [f"  for (int w0 = 0; w0 < rows; w0 += {b} * nt) {{",
            "    const int i0 = w0 + tid;"]
    if index:
        fill += [*[f"    int j{g}[{b}];" for g in range(len(loads))],
                 "#pragma unroll", f"    for (int u = 0; u < {b}; ++u) {{",
                 "      const int r = row0 + (i0 + u * nt < rows ? i0 + u * "
                 "nt : 0);", *[f"      {line}" for line in index], "    }"]
    fill += ["#pragma unroll", f"    for (int u = 0; u < {b}; ++u) {{",
             "      const int i = i0 + u * nt;", "      if (i < rows) {",
             *[f"        {line}" for line in copies], "      }", "    }"]
    # a wide column's floats of the batch's rows: element e of the rows'
    # row0 * w + [0, rows * w), e = w0 * w + tid + u * nt
    for j, o, w in flats:
        fill += ["#pragma unroll", f"    for (int u = 0; u < {b * w}; ++u) {{",
                 f"      const int e = w0 * {w} + tid + u * nt;",
                 f"      if (e < rows * {w}) rt_copy_async(&tile[e / {w} * "
                 f"{row_w} + {o} + e % {w}], &cols.c{j}[(size_t)row0 * {w} "
                 "+ e]);", "    }"]
    return fill + ["  }"]


class _RowCtx(NamedTuple):
    """What a row function reads, for the row emitter and the sources it
    rebuilds at another row."""

    n_rows: int
    dep: dict           # node id → whether it varies by row
    base: dict          # row-invariant value → its first slot in inv
    size: dict          # its elements
    grad: dict          # whether it depends on q
    aligned: frozenset  # the vectors of the rows' length read at the row
    n_dense: int        # the first of inv that some row reads densely
    own: tuple          # the space's columns
    offs: dict          # where each sits in the tile row (_row_layout)
    at_row: frozenset = frozenset()  # over the workspace, the aligned
                                     # vectors no rebuilt source reads: the
                                     # row adds its adjoint to their entry
    params: tuple = ()  # (parameter vector, its first slot in q) that an
                        # aligned vector is, or is an elementwise function
                        # of: read from the chain's state at the row
    inline: frozenset = frozenset()  # the nodes between such a parameter
                                     # and its aligned vector, computed in
                                     # the row
    gathered: dict = {}  # a row-varying Gather → {column id: offset of
                         # its value at the gathered row in the tile row}


def _bind_row(em, ctx, rix, fields=None):
    """A row emitter's inputs at row `rix`: the row-invariant values from
    inv, their adjoints into ainv (an aligned vector's element `rix`,
    its adjoint a local that _aligned_adds hands on), the parameter
    vectors read at the row's own index from the chain's state q, their
    adjoints handed on to g, and the space's columns, from the tile (rix
    "rix"); for a rebuilt source, at row rix, from the tile's gathered
    fields (`fields`: column id → offset), or, with none (a gather
    nested in a rebuilt source), from their device pointers."""
    em.rowctx, em.n_dense = ctx, ctx.n_dense
    em.row_cols = rix != "rix" and fields is None
    fields = fields or {}
    for fid, b in ctx.base.items():
        em.inv_base[fid] = b
        em.grad[fid] = ctx.grad[fid]
        if fid in ctx.aligned:
            em.vals[fid] = [f"inv[{b} + {rix}]"]
            if ctx.grad[fid]:
                em.adj[fid] = [f"al{em.tag}{fid}"]
                own = rix == "rix" and fid in ctx.at_row
                em.aligned.append((em.adj[fid][0],
                                   "cainv" if own else "ainv",
                                   f"{b} + {rix}", own))
            continue
        em.vals[fid] = [f"inv[{b + i}]" for i in range(ctx.size[fid])]
        if ctx.grad[fid]:
            em.adj[fid] = [f"ainv[{b + i}]" for i in range(ctx.size[fid])]
    for p, a in ctx.params if rix == "rix" else ():
        em.vals[p.id] = [f"q[{a} + {rix}]"]
        em.adj[p.id] = [f"al{em.tag}{p.id}"]
        em.grad[p.id] = True
        em.aligned.append((em.adj[p.id][0], "g", f"{a} + {rix}", True))
    for c in ctx.own:
        em.grad[c.id] = False
        o, j = fields.get(c.id, ctx.offs[c.id]), em.col_index[c.id]
        if rix == "rix" or c.id in fields:
            at = lambda k, o=o: f"x[{o + k}]"  # noqa: E731
            it, val = f"rt_bits_int(x[{o}])", f"x[{o}]"
        else:
            at = lambda k, j=j, p=getattr(c, "n_cols", 1): (  # noqa: E731
                f"cols.c{j}[(size_t){rix} * {p} + {k}]")
            it = val = f"cols.c{j}[{rix}]"
        if isinstance(c, R.MatColumn):
            em.mats[c.id] = at
        elif isinstance(c, R.IntColumn):
            em.ints[c.id] = it
        else:
            em.vals[c.id] = [val]


def _elementwise_of(node, layout, n):
    """(the parameter vector of n elements, its first slot in q) that
    `node` is, or is an elementwise function of with constants alone
    beside it; else None."""
    found = []
    for m in R.topological([node]):
        if isinstance(m, R.VectorParameter):
            found.append(m)
        elif not isinstance(m, (R.Constant, R.Unary, R.Binary, R.NArySum)):
            return None
    if len(found) != 1 or found[0] not in layout.parameters:
        return None
    a, b = layout.slices[layout.parameters.index(found[0])]
    return (found[0], a) if b - a == n else None


def _rebuilt(space) -> set:
    """The nodes of the sources that a row of `space` rebuilds at another
    row (a Gather by an IntColumn whose source varies by row)."""
    return {m.id for node in R.topological(list(space.roots))
            if isinstance(node, R.Gather)
            and isinstance(node.index, R.IntColumn)
            and space.dep[node.source.id]
            for m in R.topological([node.source])}


def _aligned_decls(em) -> list[str]:
    return [f"  float {name} = 0.0f;" for name, _, _, _ in em.aligned]


def _aligned_adds(em) -> list[str]:
    """Each aligned vector's adjoint at its row, added to its entry: of
    ainv, the lane's own copy, in a register model; over the workspace of
    the chain's own ainv (cainv), or of g for a parameter read from the
    chain's state.  At the row's own index no other row of the space has
    that entry, so over the workspace each entry has one writer and
    neighbouring lanes write neighbouring entries.  A vector that a source
    rebuilt at another row reads may share an entry with other lanes:
    over the workspace its adjoint is handed back in sidx/sval like a
    per-row gather's."""
    out = []
    for name, array, index, own in em.aligned:
        if em.ws and not own:
            out += [f"  sidx[{em.scatters}] = {index};",
                    f"  sval[{em.scatters}] = {name};"]
            em.scatters += 1
        else:
            out.append(f"  {array}[{index}] += {name};")
        em.rops += 2
    return out


def _space_rows(cd, space, ws, grad, base, size, row_w, n_dense, aligned,
                at_row=frozenset(), params=(), inline=frozenset(),
                steps=False):
    """One row space's row function and tile loader: (body lines,
    SpaceTiles, the loader's lines, per-row gathers, the row-step
    function's body (None: one row at a time) and its rows,
    whether the row reads columns from their device pointers: a gather
    nested in a rebuilt source).  The row-invariant values
    (`base`: slot in inv, `size`: their elements, `grad`: whether they
    depend on q) come from inv, their adjoints go to ainv, or, over the
    workspace, a per-row gather's to sidx/sval, one pair per gather; a
    vector of the rows' length that the rows read by element
    (`aligned`) is read at the row's index, which the tile then holds,
    and its adjoint handed on as a gather's; `row_w` names the tile's
    row width (None: the number); the first `n_dense` of inv are those
    some row reads other than by a per-row gather or at its index."""
    own = [cd.columns[j] for j in space.columns]
    offs, widths, width = _row_layout(own, bool(aligned))
    gathered, loads, width = _gathered_fields(cd, space, width)
    ctx = _RowCtx(space.n_rows, space.dep, base, size, grad,
                  frozenset(aligned), n_dense, tuple(own), offs,
                  at_row, tuple(params), inline, gathered)
    row = _Emitter(cd, ws)
    _bind_row(row, ctx, "rix")
    order = R.topological(list(space.roots))
    dep = {k: v or k in inline for k, v in space.dep.items()}
    for node in order:
        if dep[node.id] or isinstance(node, R.Constant):
            row.forward(node)
            if dep[node.id] and node.id in row.vals and row.size(node) > 1:
                raise UnsupportedNode(
                    f"a per-row value of vector width {row.size(node)} is "
                    "not supported by the CUDA emitter")
    seeds = _seeds(row, space.roots)
    for node in reversed(order):
        if dep[node.id]:
            row.backward(node)
    total = " + ".join(row.el(x, 0) for x in space.roots)
    head = [f"  const int rix = rt_bits_int(x[{offs['rix']}]);"] \
        if aligned else []
    rev = [*_decls(row, [n for n in order if dep[n.id]]),
           *_aligned_decls(row), *seeds, *row.rev, *_aligned_adds(row)]
    body = [*head, *row.fwd, *rev, f"  return {total};"]
    tile = SpaceTiles(space.n_rows, width, tile_rows(width, space.n_rows),
                      row.fops + row.rops + len(space.roots))
    # where the kernel keeps the row-invariant values in registers
    # (`steps`) and a row hands no gather back, its lanes may sum several
    # rows a step (_row_step)
    step = row_step(width, tile.row_ops) if steps and not row.scatters \
        else 1
    return (body, tile, _fill(cd, space, offs, widths, row_w or width,
                              loads),
            row.scatters,
            _row_step([*head, *row.fwd], rev, total, step) if step > 1
            else None, step, row.row_cols)


# a declaration of a local in an emitted function
_DECL = re.compile(r"^\s*(?:const\s+)?(?:float|double|int|bool)\s+(\w+)\s*=")


def _row_step(fwd, rev, total, step):
    """The body of a function that sums `step` of a lane's rows at once:
    rows x, x + stride, ... of the tile (a lane's consecutive rows), each
    row's locals renamed with a suffix of its own (_R<k>).  The forward
    passes of every row come first, then the reverse passes in row order,
    and each row's value goes to out[k]: every adjoint is added in the
    order and with the bits of the rows one after another, while the
    forward passes, the long dependent part of a row, are one block of
    straight-line code in which the rows' latencies overlap (a row's
    reverse pass may branch, for an IEEE division's slow path, so rows
    emitted one after another do not interleave)."""
    names = {m.group(1) for line in (*fwd, *rev)
             for m in [_DECL.match(line)] if m}
    word = re.compile(r"\b(" + "|".join(
        sorted(map(re.escape, names | {"x"}), key=len, reverse=True))
        + r")\b")

    def renamed(lines, k):
        return [word.sub(lambda m: f"{m.group(1)}_R{k}", line)
                for line in lines]

    out = [f"  const float* x_R{k} = x + {k} * stride;" for k in range(step)]
    for k in range(step):
        out += renamed(fwd, k)
    for k in range(step):
        out += renamed(rev, k)
    return out + [f"  out[{k}] = {renamed([total], k)[0]};"
                  for k in range(step)]


def _emit_rows(cd, spaces, ws, whole, scratch):
    """The per-row part of a data model: (C lines, invariant ops, the
    row-invariant values' count, the count of those some row reads other
    than by a per-row gather, SpaceTiles per row space).  One row space
    keeps the names rt_row and rt_fill_tile; several
    define RT_SPACES and a RtSpace<s> each, and the row functions take
    the columns where one of them reads them whole.  `whole`: the
    functions outside the rows take the columns, which they read whole;
    `scratch`: the floats of scr that rt_logp_grad uses.  Also returns
    the floats of scr that any of them use, and whether the rows take the
    columns."""
    # row-invariant inputs of the row functions, computed once per call,
    # and how each space's rows read each: by a per-row gather, whole (a
    # MatVec's vector), or by element
    frontier, reads = [], {}
    for s, space in enumerate(spaces):
        for node in R.topological(list(space.roots)):
            if not space.dep[node.id]:
                continue
            for k in R.children_of(node):
                if space.dep[k.id] or isinstance(k, R.Constant):
                    continue
                if k.id not in reads:
                    frontier.append(k)
                reads.setdefault(k.id, set()).add((s, (
                    "gather" if isinstance(node, R.Gather)
                    and k is node.source
                    and isinstance(node.index, R.IntColumn) else
                    "whole" if isinstance(node, R.MatVec) and k is node.vec
                    else "elem")))
    sizer = _Emitter(cd, ws)
    for node in R.topological(frontier):
        sizer.forward(node)
    size = {f.id: sizer.size(f) for f in frontier}
    # `aligned[s]`: the vectors of space s's row count that its rows read
    # by element, each row its own element (the lanes evaluator's (n, C)
    # against (n, C)); `dense`: the values some row reads other than by a
    # per-row gather or so
    aligned, dense = [set() for _ in spaces], set()
    for fid, how in reads.items():
        for s, kind in how:
            if kind == "elem" and size[fid] == spaces[s].n_rows > 1:
                aligned[s].add(fid)
                if {(s, "gather"), (s, "whole")} & how:
                    raise UnsupportedNode(
                        "a row-invariant vector of the rows' length read "
                        "both by element and whole is not supported by "
                        "the CUDA emitter")
            elif kind != "gather":
                dense.add(fid)
    # over the workspace, an aligned vector that a parameter vector of the
    # rows' length is, or is an elementwise function of: the row reads the
    # parameter from the chain's state at its index, computes the
    # function there and adds the adjoint to g, so the vector needs
    # neither inv nor ainv, nor the passes that fill and read them
    params, inline = [[] for _ in spaces], [set() for _ in spaces]
    held = set()
    byid = {f.id: f for f in frontier}
    at_row = [frozenset(aligned[s] - _rebuilt(space)) if ws else frozenset()
              for s, space in enumerate(spaces)]
    for s, space in enumerate(spaces):
        for fid in sorted(at_row[s]):
            pa = _elementwise_of(byid[fid], cd.layout, space.n_rows)
            if pa is None or reads[fid] != {(s, "elem")}:
                continue
            held.add(fid)
            if pa not in params[s]:
                params[s].append(pa)
            inline[s] |= {m.id for m in R.topological([byid[fid]])
                          if m is not pa[0] and not isinstance(m, R.Constant)}
    frontier = [f for f in frontier if f.id not in held]
    dense |= {f.id for f in frontier if size[f.id] == 1}
    # inv: the dense values first, then the gathered blocks
    frontier = ([f for f in frontier if f.id in dense]
                + [f for f in frontier if f.id not in dense])
    base, k = {}, 0
    for f in frontier:
        base[f.id], k = k, k + size[f.id]
    n_inv = k
    n_dense = sum(size[f] for f in dense)

    pre = _Emitter(cd, ws)
    pre_fwd, _, _ = _program(
        pre, frontier, reverse=False,
        store=lambda f, i, v: f"  inv[{base[f.id]} + {i}] = {v};")
    post = _Emitter(cd, ws)
    post_fwd, post_rev, _ = _program(
        post, frontier,
        seed=lambda f, i: f"ainv[{base[f.id]} + {i}]")
    store, post_seeds = [], []
    for f in frontier:
        b, looped = base[f.id], f.id in pre.loop_len
        if not looped:
            store += [f"  inv[{b + i}] = {pre.el(f, i)};"
                      for i in range(size[f.id])]
        if pre.grad[f.id] and not looped:
            a = post.adj[f.id]
            post_seeds += [_add_to(post, f.id, a[i if len(a) > 1 else 0],
                                   f"ainv[{b + i}]")
                           for i in range(size[f.id])]

    r = _RESTRICT if ws else ""
    scratch = max(scratch, pre.scratch, post.scratch)
    wc = (", const RtCols& cols" if whole else "") + (
        f", float*{r} scr" if scratch else "")
    one = len(spaces) == 1
    # a workspace model whose rows read every row-invariant value densely,
    # and few of them, keeps them in registers over a tile's rows
    inv_regs = ws and n_dense == n_inv <= INV_REGS_MAX
    made = [_space_rows(cd, space, ws, pre.grad, base, size,
                        "RT_ROW_W" if one else None, n_dense, aligned[s],
                        at_row[s], params[s], frozenset(inline[s]),
                        not ws or inv_regs)
            for s, space in enumerate(spaces)]
    # a row that rebuilds a source inside a rebuilt source reads columns
    # from their device pointers: then every row function takes them
    # (the tile holds the columns of the row's own rebuilt sources at
    # their gathered rows); over the workspace, one that
    # reads a vector at its own index takes the chain's state, gradient
    # and ainv, where it adds that element's adjoint
    row_cols = any(m[-1] for m in made)
    row_state = any(at_row)
    row_sig = (f"float*{r} x, const float*{r} inv, float*{r} ainv"
               + (f", int*{r} sidx, float*{r} sval" if ws else "")
               + (", const RtCols& cols" if row_cols else "")
               + (f", const float*{r} q, float*{r} g, float*{r} cainv"
                  if row_state else "")
               + ")")
    fill_sig = "(float* tile, const RtCols& cols, int row0, int rows, " \
               "int tid, int nt)"
    step_sig = (f"const float*{r} x, int stride, const float*{r} inv, "
                f"float*{r} ainv"
                + (", const RtCols& cols" if row_cols else "")
                + (f", const float*{r} q, float*{r} g, float*{r} cainv"
                   if row_state else "")
                + f", float*{r} out)")
    tiles, spaces_text = [], []
    for s, (body, tile, fill, n_gathers, step_body, step,
            _) in enumerate(made):
        tiles.append(tile)
        gathers = ([f"// the row's {n_gathers} per-row gathers hand their "
                    "adjoints back in sidx/sval",
                    f"#define RT_GATHERS {n_gathers}"] if ws else [])
        step_doc = [
            f"// {step} of a lane's rows, x + k·stride, their values in "
            "out[k]; adds",
            "// their adjoints into ainv in row order, as rt_row would"]
        if one:
            row_fn = [
                *gathers,
                "// one row's log-density; adds its adjoints of the "
                "row-invariant",
                "// values into ainv",
                f"RT_HD float rt_row(const {row_sig} {{", *body, "}",
                *(["", f"#define RT_ROW_STEP {step}", *step_doc,
                   f"RT_HD void rt_row_step({step_sig} {{", *step_body, "}"]
                  if step_body else [])]
            fills = [
                "// rows [row0, row0 + rows) of every column into the tile, "
                "thread",
                "// tid of nt: copies issued asynchronously (cp.async on the "
                "card, a",
                "// plain copy in host code); an index keeps its bits",
                f"RT_HD void rt_fill_tile{fill_sig} {{", *fill, "}"]
            continue
        spaces_text += [
            "",
            f"// row space {s}: {tile.n_rows} rows of {tile.row_width} "
            f"floats, tiles of {tile.tile_rows}",
            "template <>",
            f"struct RtSpace<{s}> {{",
            f"  enum {{ kW = {tile.row_width}, kTile = "
            f"{max(tile.tile_rows, 1)}"
            + (f", kGathers = {n_gathers}" if ws else "")
            + f", kStep = {step if step_body else 1} }};",
            "  // one row's log-density; adds its adjoints of the",
            "  // row-invariant values into ainv",
            f"  static RT_HD float row(const {row_sig} {{",
            *_indent(body), "  }",
            *([*["  " + line for line in step_doc],
               f"  static RT_HD void step({step_sig} {{",
               *_indent(step_body), "  }"] if step_body else []),
            "  // rows [row0, row0 + rows) of the space's columns into the "
            "tile,",
            "  // thread tid of nt, as asynchronous copies",
            f"  static RT_HD void fill{fill_sig} {{", *_indent(fill), "  }",
            "};"]
    post_fn = [
        "// the reverse pass of the row-invariant values, from the adjoints",
        "// summed over all rows; adds into g",
        f"RT_HD void rt_rows_post(const float*{r} q, const float*{r} ainv, "
        f"float*{r} g{wc}) {{",
        *post_fwd, *_decls(post, R.topological(frontier)), *post_seeds,
        *post_rev,
        "}"]
    lines = [
        f"#define RT_NINV {n_inv}",
        f"#define RT_NINV_ALLOC {max(n_inv, 1)}",
        *(["#define RT_INV_REGS 1"] if inv_regs else []),
        *([f"#define RT_NINV_DENSE {n_dense}",
           f"#define RT_NINV_DENSE_ALLOC {max(n_dense, 1)}"]
          if n_dense != n_inv else []),
        "",
        "// the row-invariant values the row function"
        + (" reads" if one else "s read"),
        f"RT_HD void rt_rows_pre(const float*{r} q, float*{r} inv{wc}) {{",
        *pre_fwd, *store,
        "}",
        ""]
    if one:
        lines += [*row_fn, "", *post_fn, "", *fills]
    else:
        lines += [*post_fn, "", f"#define RT_SPACES {len(spaces)}",
                  "template <int S> struct RtSpace;", *spaces_text]
    inv_ops = pre.fops + post.fops + post.rops + len(post_seeds)
    return (lines, inv_ops, n_inv, n_dense, tuple(tiles), scratch, row_cols,
            pre.lanes or post.lanes, row_state,
            {**pre.products, **post.products})


def _cols_struct(columns, staged=(), transposed=()):
    """RtCols, one pointer of its own type per column (int32 for an
    IntColumn), and rt_cols, which fills it from the launch's pointer
    array on the host; a pointer to the copy in shared memory of each
    `staged` column (s<c>, set by rt_stage_mats), and one to each
    `transposed` column's transposed copy, which the pointer array holds
    after the columns (t<c>)."""
    types = ["const int*" if isinstance(c, R.IntColumn) else "const float*"
             for c in columns]
    return [
        "// the model's data columns, each with its own type",
        "struct RtCols {",
        *[f"  {t} c{j};" for j, t in enumerate(types)],
        *(["  const float* unused;"] if not columns else []),
        *[f"  const float* s{c};" for c in staged],
        *[f"  const float* t{c};" for c in transposed],
        "};",
        "",
        "static inline RtCols rt_cols(const void* const* cols) {",
        "  RtCols out = {};",
        *[f"  out.c{j} = ({t})cols[{j}];" for j, t in enumerate(types)],
        *[f"  out.t{c} = (const float*)cols[{len(columns) + k}];"
          for k, c in enumerate(transposed)],
        "  (void)cols;",
        "  return out;",
        "}",
    ]


# CompiledDensity -> its EmittedDensity: a density is emitted once per
# process, however many checks and launches read it
_EMITTED = weakref.WeakKeyDictionary()


def emit(cd, stage_budget=None) -> EmittedDensity:
    """C source of the density for the CompiledDensity `cd`:
    ``rt_logp_grad`` over the column-free terms and, for a model with
    data, the row functions and tile loader of its RowSum likelihoods;
    with the chain state in a slot of the kernel's workspace where the
    model has over LANE_STATE_MAX parameters or row-invariant values.
    With `stage_budget`, the density is emitted anew with its product
    passes' matrices staged in shared memory only where the block's
    slots or tiles and they fit that many bytes (0: never, the
    transposed copy's layout at any size), and kept as cd's emission."""
    if cd not in _EMITTED or stage_budget is not None:
        budget = SMEM_BYTES_MAX if stage_budget is None else stage_budget
        em = _emit(cd, cd.n_vars > LANE_STATE_MAX, budget)
        if not em.workspace and em.n_inv > LANE_STATE_MAX:
            em = _emit(cd, True, budget)
        _EMITTED[cd] = em
    return _EMITTED[cd]


def workspace_floats(n_vars: int, n_inv: int, rows: bool,
                     n_dense: int = 0, scratch: int = 0) -> int:
    """Floats of one chain's slot of the workspace: the seven state
    arrays (sc, q, g, qn, gn, p, x), with rows inv, ainv and the LANES
    lanes' own copies of the `n_dense` adjoints that every row reads,
    and the density's scratch (scr, at an even offset, since it holds f64
    sums), rounded up to an even count (csrc/fused_hmc.cu,
    RT_WS_FLOATS)."""
    n = 7 * n_vars + (2 * max(n_inv, 1) + LANES * max(n_dense, 1)
                      if rows else 0)
    n += (n % 2 + scratch) if scratch else 0   # scr at an even offset
    return n + n % 2


def _emit(cd, ws: bool, stage_budget: int) -> EmittedDensity:
    try:
        split = cd.row_split()
    except NoRowSplit as e:
        raise UnsupportedNode(
            f"{e} is not supported by the CUDA emitter") from None
    # a slot of a chain without rows: every vector a loop split over its
    # lanes, unless a MatVec reads a matrix whole (see the docstring), and
    # the slot in shared memory up to LOCAL_STATE_MAX
    lane_slot = ws and not split.spaces
    unroll = 1 if lane_slot and not any(
        isinstance(c, R.MatColumn) for c in cd.columns) else UNROLL_MAX
    shared = lane_slot and cd.n_vars <= LOCAL_STATE_MAX
    # the base terms read their columns whole, and so do the row-invariant
    # values of the rows
    whole = bool(find_columns(split.base)) or any(
        find_columns(list(sp.frontier)) for sp in split.spaces)
    roots = list(split.base)
    em = _Emitter(cd, ws, unroll)
    fwd, rev, total = _program(em, roots, total=True)
    lp_ops = max(len(total) - 1, 0)
    n = cd.n_vars
    (rows, inv_ops, n_inv, n_dense, spaces, scratch, row_cols, lanes,
     row_state, products) = (
        _emit_rows(cd, split.spaces, ws, whole, em.scratch) if split.spaces
        else ([], 0, 0, 0, (), em.scratch, False, False, False, {}))
    products = {**em.products, **products}
    slot = workspace_floats(n, n_inv, bool(spaces), n_dense, scratch) \
        if ws else 0
    r = _RESTRICT if ws else ""
    # the shared memory of a tile slot: the widest space's tile
    top = max(spaces, key=lambda t: t.tile_rows * t.row_width,
              default=SpaceTiles(0, 0, 0, 0))
    # the matrices of the product passes staged beside the block's slots
    # (at most a block's BLOCK_THREADS_MAX / LANES chains) or its two
    # tile slots, where they fit
    block = 4 * (2 * top.tile_rows * top.row_width + (
        BLOCK_THREADS_MAX // LANES * -(-slot // LANES) * LANES if shared
        else 0))
    mats, staged, transposed = _mat_layout(products, block, stage_budget)
    src = "\n".join([
        "// Generated by rainier_tpu_torch.compute.emit_cuda: the model's",
        "// log-density and its reverse-mode gradient for one chain.",
        "#pragma once",
        '#include "rt_math.cuh"',
        "",
        f"#define RT_DIM {n}",
        f"#define RT_ROW_W {top.row_width}",
        f"#define RT_TILE {max(top.tile_rows, 1)}",
        # one row space whose rows fit one tile: the kernel loads it once
        # a launch, and the density calls read it there
        *(["#define RT_RESIDENT 1"] if len(spaces) == 1
          and spaces[0].n_rows <= spaces[0].tile_rows else []),
        *([f"#define RT_WS_FLOATS {slot}"] if ws else []),
        # a warp a chain, unless the build defines fewer lanes (a
        # register model's loops split over them where they read an
        # index column whole)
        *(["#ifndef RT_LANES", f"#define RT_LANES {LANES}", "#endif"]
          if ws or lanes or em.lanes else []),
        *(["#define RT_WS_SHARED 1"] if shared else []),
        *(["#define RT_WHOLE_COLS 1"] if whole else []),
        *([f"#define RT_SCRATCH {scratch}"] if scratch else []),
        *(["#define RT_ROW_COLS 1"] if row_cols else []),
        *(["#define RT_ROW_STATE 1"] if row_state else []),
        "",
        *_cols_struct(cd.columns, tuple(sorted(products)) if staged
                      else (), transposed),
        "",
        *([*mats, ""] if mats else []),
        f"RT_HD float rt_logp_grad(const float*{r} q, float*{r} g"
        + (", const RtCols& cols" if whole else "")
        + (f", float*{r} scr" if scratch else "") + ") {",
        *([f"  for (int j = RT_LANE; j < {n}; j += RT_LSTEP) g[j] = 0.0f;",
           "  RT_WARP_SYNC();"] if ws
          else [f"  for (int j = 0; j < {n}; ++j) g[j] = 0.0f;"]),
        *fwd,
        "  const float lp = " + (" + ".join(total) or "0.0f") + ";",
        *_decls(em, R.topological(roots)),
        *_seeds(em, roots),
        *rev,
        "  return lp;",
        "}",
        "",
        *rows,
        "",
    ])
    return EmittedDensity(source=src, n_vars=n,
                          ops=em.fops + lp_ops + em.rops + inv_ops,
                          spaces=spaces, n_inv=n_inv, workspace=slot,
                          shared=shared, scratch=scratch, staged=staged,
                          transposed=transposed)
