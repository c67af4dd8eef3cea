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
A header of one space names them ``rt_row``, ``rt_fill_tile`` and
``rt_fill_tile_async``; one of several defines ``RT_SPACES`` and an
``RtSpace<s>`` each.  The nodes under a row function that do not vary by
row are *row-invariant*: ``rt_rows_pre`` computes the ones the rows read
once per density call, the row functions accumulate their adjoints over
the rows, and ``rt_rows_post`` runs their reverse pass once after the
last row — reverse mode through a broadcast, as the lanes evaluator's
(1, C)-against-(n, C) broadcasting is.  ``MatVec`` is p multiply-adds per
row, and a ``Column`` view of a ``MatColumn`` that the tile holds reads
the matrix's entry.  The tile loader comes twice: ``rt_fill_tile`` stores
every element, and ``rt_fill_tile_async`` issues the same copies
asynchronously, for a launch that streams its columns through two tile
slots.

Outside the rows a column is read whole, from its device pointer, the
way the JAX kernel's untiled branch reads its columns
(rainier_tpu/ops/hmc_pallas.py:282-301): a column that a base term reads,
or that a row reads through what sums or indexes it (a ``RowSum`` or
``VecSum`` of it, a ``Gather`` from it, the ``MatVec`` of a matrix by a
vector) is a vector of its k rows, ``cols.c<j>[i]``, a loop past
``UNROLL_MAX`` rows; the ``MatVec`` of a matrix read whole is a vector of
its rows, and its reverse pass adds the matrix's transpose times the
adjoint into the vector's.  The values are read at every call, never
baked into the source, so ``Model.with_data`` swaps them under one build.
Such a header defines ``RT_WHOLE_COLS``, and its functions outside the
rows take the columns.

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
across tiles.

A model over ``LOCAL_STATE_MAX`` parameters or row-invariant values, or
with rows over ``LANE_STATE_MAX``, keeps its chain state in a
device-memory workspace (``RT_WS_FLOATS`` floats a chain,
csrc/fused_hmc.cu): its functions then take ``__restrict__`` pointers,
its loops split their elements over the ``RT_LANES`` lanes of the chain
(lane l takes l, l + 32, ...) and are unrolled by eight, so that loads of
several elements are in flight, their sums are lane partials added up by
``RT_SUM``, an element read as a scalar comes from its lane
(``RT_BCAST``), and a parameter's scalar adjoint is added to ``g`` by lane
0 alone.  Smaller models emit exactly the text they did before the
workspace existed.

Outside the envelope, :class:`UnsupportedNode` names what is wrong: a
``Gather`` whose source varies by row or whose index is neither a
constant nor an ``IntColumn``, an ``IntColumn`` used as a value or read
outside the rows, a ``MatColumn`` other than as ``MatVec``'s matrix, a
per-row value of vector width over 1, a ``MatVec`` of a matrix read
whole by a vector of more than ``UNROLL_MAX`` elements, and one
``RowSum`` over columns of two lengths.
"""

from __future__ import annotations

import math
import weakref
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from . import real as R
from .compiler import NoRowSplit, find_columns

HEADER_NAME = "rt_model.h"


class UnsupportedNode(NotImplementedError):
    """The graph holds a node the CUDA emitter does not cover yet."""


# Row tiles: at most TILE_ROWS_MAX rows, halved until two tiles fit the
# shared memory one block can use on an H100 (a launch that streams its
# columns fills one slot while the block reads the other); below
# TILE_ROWS_MIN rows the kernel does not take the model
TILE_ROWS_MAX = 256
TILE_ROWS_MIN = 32
SMEM_BYTES_MAX = 232448

# Vectors longer than this are emitted as loops over their elements; the
# funnel's 9, the README's 3 and the logistic's 10 stay unrolled
UNROLL_MAX = 16

# Over this many parameters or row-invariant values a chain's state
# lives in the kernel's device-memory workspace, not in per-thread arrays
LOCAL_STATE_MAX = 256
# ... and over this many for a model with rows, whose chain is a warp: in
# per-thread arrays every lane holds the whole state, and past a few
# dozen floats an array each spills to local memory that all 32 lanes
# read and write, where the workspace splits each pass over the lanes
# (GLMMPoisson2, 146 parameters: 756 ms against 1,239 ms for 1024 chains
# x 500 iterations on an H100, tools/kernel_ab.py layouts, PERF.md §6)
LANE_STATE_MAX = 32

# Lanes of a chain with rows: the 32 threads of a warp split its rows
# and, over the workspace, its passes (csrc/fused_hmc.cu, RT_LANES)
LANES = 32

# The workspace's arrays do not overlap: said to nvcc, it may issue the
# loads of later elements before the stores of earlier ones
_RESTRICT = " __restrict__"


def tile_rows(row_width: int) -> int:
    """Rows per tile for rows of `row_width` floats (0 when even two
    TILE_ROWS_MIN-row tiles do not fit shared memory)."""
    r = TILE_ROWS_MAX
    while 2 * r * row_width * 4 > SMEM_BYTES_MAX and r >= TILE_ROWS_MIN:
        r //= 2
    return r if r >= TILE_ROWS_MIN else 0


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
                          # device-memory workspace (0: state in registers)

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
    def __init__(self, cd, ws: bool = False):
        self.cd = cd
        self.ws = ws                      # state in the workspace
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
        self.lse: dict[int, tuple] = {}   # LogSumExp node → (maxes, sums)
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
            name = f"v{node.id}" + (f"_{i}" if len(exprs) > 1 else "")
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
            self.rev.append(_part_add(self.ws, target, expr))
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
        if isinstance(node, R.Constant):
            self.vals[nid] = [_lit(node.value)]
            self.grad[nid] = False
            return
        if isinstance(node, (R.Parameter, R.VectorParameter)):
            if node not in layout.parameters:
                raise UnsupportedNode(f"parameter {node!r} outside layout")
            a, b = layout.slices[layout.parameters.index(node)]
            if b - a > UNROLL_MAX:
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
            if k.id in self.ints and not (
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
            # pairwise max, shifted exp sum: the lanes evaluator's formula
            n, w = self.width(node.children)
            ms, ss, outs = [], [], []
            for i in range(w):
                xs = [self.el(c, i) for c in node.children]
                m = xs[0]
                for x in xs[1:]:
                    m = f"fmaxf({m}, {x})"
                mname, sname = f"m{nid}_{i}", f"s{nid}_{i}"
                self.fwd.append(f"  const float {mname} = {m};")
                self.fwd.append("  const float {} = {};".format(
                    sname, " + ".join(f"expf({x} - {mname})" for x in xs)))
                ms.append(mname)
                ss.append(sname)
                outs.append(f"{mname} + logf({sname})")
            self.fops += n * 4 * len(node.children)
            self.define(node, outs, 2, n)
            self.lse[nid] = (ms, ss)
        elif isinstance(node, R.Select):
            n, w = self.width([node.left, node.right, node.if_true,
                               node.if_false])
            op = _PRED[node.pred]
            conds = []
            for i in range(w):
                c = f"c{nid}_{i}"
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
                ix = f"i{nid}_{i}"
                src = int_ix or f"rt_f2i({self.el(node.index, i)})"
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
                raise UnsupportedNode(
                    f"a MatVec of a data matrix read whole by a vector of "
                    f"{p} > {UNROLL_MAX} elements is not supported by the "
                    "CUDA emitter")
            else:
                n = node.mat.n_rows
                rows = ["i"] if n > UNROLL_MAX else list(range(n))
            self.define(node, ["(" + " + ".join(
                f"{self.mat_entry(node.mat, r, j)} * {self.el(node.vec, j)}"
                for j in range(p)) + ")" for r in rows], 2 * p - 1, n)
        elif isinstance(node, R.Gather):
            k = self.size(node.source)
            j = _static_slot(node, k)
            if j is not None and node.source.id in self.loop_len:
                # the source's loop keeps element j in k<id>
                self.define(node, [f"k{nid}"], 0)
            elif j is not None:
                self.define(node, [self.el(node.source, j)], 0)
            else:
                # per-row index into the source's block of inv: clamp and
                # address, then the load
                base = self.inv_base[node.source.id]
                self.fwd.append(f"  const int j{nid} = rt_clampi("
                                f"{self.ints[node.index.id]}, 0, {k - 1});")
                self.define(node, [f"inv[{base} + j{nid}]"], 3)
        else:
            raise UnsupportedNode(f"{type(node).__name__} is not yet "
                                  "supported by the CUDA emitter")
        if self.grad[nid]:
            names = [f"a{nid}" + (f"_{i}" if len(self.vals[nid]) > 1
                                  else "")
                     for i in range(len(self.vals[nid]))]
            self.adj[nid] = names

    def _whole_column(self, node) -> None:
        """A column read whole, outside the rows of a top-level RowSum: a
        vector of its rows, each a load from its device pointer (a loop
        past UNROLL_MAX rows); a MatColumn only as MatVec's matrix."""
        if isinstance(node, R.IntColumn):
            raise UnsupportedNode(
                "an IntColumn read outside the rows of a top-level RowSum "
                "likelihood is not supported by the CUDA emitter")
        j, nid = self.col_index[node.id], node.id
        self.grad[nid] = False
        if isinstance(node, R.MatColumn):
            self.wmats[nid] = j
        elif node.n_rows > UNROLL_MAX:
            self.loop_len[nid] = node.n_rows
            self.vals[nid] = [f"cols.c{j}[i]"]
        else:
            self.vals[nid] = [f"cols.c{j}[{i}]" for i in range(node.n_rows)]

    def mat_entry(self, mat, r, j) -> str:
        """Entry (r, j) of a MatColumn: column j of the tile's row (r is
        None), or of row r read whole (r an int, or "i" in a loop)."""
        if mat.id in self.mats:
            return f"x[{self.mats[mat.id] + j}]"
        p, c = mat.n_cols, self.wmats[mat.id]
        return (f"cols.c{c}[i * {p} + {j}]" if r == "i"
                else f"cols.c{c}[{r * p + j}]")

    # -- reverse ----------------------------------------------------------
    def backward(self, node) -> None:
        nid = node.id
        if not self.grad.get(nid) or isinstance(
                node, (R.Parameter, R.VectorParameter)):
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
                ms, ss = self.lse[nid]
                for c in node.children:
                    self.acc(c, i, f"{a} * (expf({self.el(c, i)} - {ms[i]})"
                                   f" / {ss[i]})", 4)
            elif isinstance(node, R.Select):
                c = f"c{nid}_{i}"
                self.acc(node.if_true, i, f"({c} ? {a} : 0.0f)", 1)
                self.acc(node.if_false, i, f"({c} ? 0.0f : {a})", 1)
            elif isinstance(node, R.Lookup):
                ix = f"i{nid}_{i}"
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
                if j is not None and node.source.id in self.loop_len:
                    pass        # seeded in the source's loop
                elif j is not None:
                    self.acc(node.source, j, a, 0)
                elif self.grad[node.source.id] and self.ws and \
                        self.inv_base[node.source.id] >= self.n_dense:
                    # the scatter into the chain's ainv, left to the warp:
                    # its lanes hit one entry together (csrc/fused_hmc.cu,
                    # rt_scatter)
                    base, g = self.inv_base[node.source.id], self.scatters
                    self.rev.append(f"  sidx[{g}] = {base} + j{nid};")
                    self.rev.append(f"  sval[{g}] = {a};")
                    self.scatters += 1
                    self.rops += 2
                elif self.grad[node.source.id]:
                    # the scatter into the lane's own copy of ainv
                    base = self.inv_base[node.source.id]
                    self.rev.append(f"  ainv[{base} + j{nid}] += {a};")
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
            and not isinstance(node, (R.Parameter, R.VectorParameter))
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
    or one element) is one stage after it, every other node the latest
    of its children.
    The forward pass emits, stage by stage, the stage's scalars and then
    one loop per length over the vectors its readers need, recomputing
    vectors of earlier stages that the body reads; the reverse pass runs
    the stages backwards, each loop recomputing its body, seeding the
    adjoints of what its readers read and running the body's adjoints
    back.  A looped root adds to the total through an f64 sum (`total`),
    or `store(node, "i", value)` writes it out; `seed(node, "i")` is added
    to its adjoint (with `total`, 1).  `reverse=False` emits the forward
    pass only."""
    order = R.topological(roots)
    for node in order:                 # lengths and gradient flags
        em.forward(node)
    looped = dict(em.loop_len)
    stage = {}
    for node in order:
        stage[node.id] = max([stage[c.id] + (c.id in looped
                                             and node.id not in looped)
                              for c in R.children_of(node)], default=0)
    loops = {}

    def out(kind, c, reader=None):
        key = (stage[c.id], looped[c.id])
        loops.setdefault(key, _Loop(key[1])).outs.append((kind, c, reader))

    for node in order:
        if node.id not in looped:
            for c in set(R.children_of(node)):
                if c.id not in looped:
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
                            if c.id in looped)
        loop.body = [n for n in order if n.id in need]

    em.vals, em.adj, em.lse, em.fops = {}, {}, {}, 0
    fwd, rev = [], []
    n_stages = max(stage.values()) + 1
    for s in range(n_stages):
        em.fwd = fwd
        for node in order:
            if stage[node.id] == s and node.id not in looped:
                em.forward(node)
        for (ls, _), loop in sorted(loops.items()):
            if ls == s:
                fwd += _loop_forward(em, loop, total, store)
    terms = [t for r in roots for t in (
        [f"(float)r{r.id}"] if r.id in looped
        else [em.el(r, i) for i in range(em.size(r))])]
    for s in reversed(range(n_stages if reverse else 0)):
        for (ls, _), loop in sorted(loops.items(), reverse=True):
            if ls == s:
                rev += _loop_reverse(em, loop, total, seed)
        em.rev = rev
        for node in reversed(order):
            if stage[node.id] == s and node.id not in looped:
                em.backward(node)
    em.fwd, em.rev = fwd, rev
    return fwd, rev, terms


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
    keep the arrays there; over the workspace the lanes of a chain split
    the elements (lane l takes l, l + 32, ...: RT_LANE, RT_LSTEP in
    csrc/rt_math.cuh), and unrolling by eight keeps loads of several
    elements in flight."""
    head = ("  for (int i = RT_LANE; i < {k}; i += RT_LSTEP) {{" if em.ws
            else "  for (int i = 0; i < {k}; ++i) {{").format(k=k)
    return [*pre, f"#pragma unroll {8 if em.ws else 1}", head,
            *_indent(body), "  }", *post]


def _part(ws: bool, name: str) -> str:
    """The declaration of an f64 sum over a loop's elements: over the
    workspace, a lane's partial sum, which _part_sum adds up over the
    lanes (RT_PART in csrc/rt_math.cuh)."""
    return f"  RT_PART(double, {name});" if ws else f"  double {name} = 0.0;"


def _part_add(ws: bool, name: str, value: str) -> str:
    """Element i's value added to the sum `name`."""
    return f"  RT_ADD({name}, i, {value});" if ws else f"  {name} += {value};"


def _part_sum(ws: bool, names) -> list[str]:
    """After the loop: the lanes' partial sums added up, the same bits in
    every lane."""
    return [f"  RT_SUM({n});" for n in names] if ws else []


def _loop_forward(em, loop, total, store):
    """The forward loop: the body, then each reader's sum or element, and
    the roots' sum or store.  Empty where nothing reads the body in the
    forward pass."""
    if not any(kind != "root" or total or store is not None
               for kind, _, _ in loop.outs):
        return []
    body = _loop_body(em, loop)
    pre, post = [], []
    for kind, c, reader in loop.outs:
        v = em.el(c, 0)
        if kind == "sum" or (kind == "root" and total):
            r = f"r{reader.id if kind == 'sum' else c.id}"
            pre.append(_part(em.ws, r))
            body.append(_part_add(em.ws, r, v))
            post += _part_sum(em.ws, [r])
            em.fops += loop.k
        elif kind == "capture":
            j = _static_slot(reader, loop.k)
            pre.append(f"  float k{reader.id} = 0.0f;")
            body.append(f"  if (i == {j}) k{reader.id} = {v};")
            if em.ws:       # from the lane that holds element j
                post.append(f"  RT_BCAST(k{reader.id}, {j});")
        elif store is not None:
            body.append(store(c, "i", v))
    em.mult = 1
    return _loop(em, loop.k, pre, body, post)


def _loop_reverse(em, loop, total, seed):
    """The reverse loop: the body recomputed, its adjoints declared and
    seeded from its readers (and roots), then run back; scalars' adjoints
    are summed over the elements in f64 and added after the loop."""
    body = _loop_body(em, loop)
    for n in loop.body:
        if em.grad[n.id] and not isinstance(n, R.VectorParameter):
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
    return ["  {", *_indent(_loop(
        em, loop.k, [_part(em.ws, t) for t in accs.values()], body,
        [*_part_sum(em.ws, accs.values()),
         *[_add_to(em, nid, em.adj[nid][j], f"(float){t}")
           for (nid, j), t in accs.items()]])),
        "  }"]


def _row_layout(columns):
    """Where each of a row space's columns sits in its tile row: ({column
    id: offset of its first float}, [floats loaded per column], row
    width).  A Column view of a MatColumn that the tile holds reads the
    matrix's entry and loads nothing of its own; an IntColumn takes one
    32-bit slot."""
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
    return offs, widths, w


class SpaceTiles(NamedTuple):
    """One row space of an emitted density, as the kernel tiles it."""

    n_rows: int
    row_width: int      # floats of one row in a tile
    tile_rows: int      # rows per tile (0: even the least tile is too wide)
    row_ops: int        # f32 operations of one row's forward + adjoints


def _fill(cd, space, offs, widths, row_w):
    """The space's tile loader, synchronous and asynchronous: rows [row0,
    row0 + rows) of each of its columns into the tile (`row_w` floats a
    row), thread tid of nt."""
    fill, fill_async = [], []
    for j, w in zip(space.columns, widths):
        c = cd.columns[j]
        o = offs[c.id]
        if w == 1:
            v = f"cols.c{j}[row0 + i]"
            loop = "  for (int i = tid; i < rows; i += nt) "
            dst = f"tile[i * {row_w} + {o}]"
            fill.append(f"{loop}{dst} = " + (
                f"rt_int_bits({v})" if isinstance(c, R.IntColumn) else v)
                + ";")
            fill_async.append(f"{loop}rt_copy_async(&{dst}, &{v});")
        elif w > 1:
            dst = f"tile[r * {row_w} + {o} + i - r * {w}]"
            v = f"cols.c{j}[(size_t)row0 * {w} + i]"
            head = [f"  for (int i = tid; i < rows * {w}; i += nt) {{",
                    f"    const int r = i / {w};"]
            fill += [*head, f"    {dst} = {v};", "  }"]
            fill_async += [*head, f"    rt_copy_async(&{dst}, &{v});", "  }"]
    return fill, fill_async


def _space_rows(cd, space, ws, grad, base, size, row_w, n_dense):
    """One row space's row function and tile loaders: (body lines,
    SpaceTiles, fill lines, asynchronous fill lines, per-row gathers).
    The row-invariant values (`base`: slot in inv, `size`: their
    elements, `grad`: whether they depend on q) come from inv, their
    adjoints go to ainv, or, over the workspace, a per-row gather's to
    sidx/sval, one pair per gather; `row_w` names the tile's row width
    (None: the number); the first `n_dense` of inv are those some row
    reads other than by a per-row gather."""
    row = _Emitter(cd, ws)
    row.n_dense = n_dense
    for fid, b in base.items():
        row.vals[fid] = [f"inv[{b + i}]" for i in range(size[fid])]
        row.inv_base[fid] = b
        row.grad[fid] = grad[fid]
        if grad[fid]:
            row.adj[fid] = [f"ainv[{b + i}]" for i in range(size[fid])]
    own = [cd.columns[j] for j in space.columns]
    offs, widths, width = _row_layout(own)
    for c in own:
        row.grad[c.id] = False
        if isinstance(c, R.MatColumn):
            row.mats[c.id] = offs[c.id]
        elif isinstance(c, R.IntColumn):
            row.ints[c.id] = f"rt_bits_int(x[{offs[c.id]}])"
        else:
            row.vals[c.id] = [f"x[{offs[c.id]}]"]
    order = R.topological(list(space.roots))
    dep = space.dep
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
    body = [*row.fwd, *_decls(row, [n for n in order if dep[n.id]]),
            *seeds, *row.rev, f"  return {total};"]
    tile = SpaceTiles(space.n_rows, width, tile_rows(width),
                      row.fops + row.rops + len(space.roots))
    return (body, tile, *_fill(cd, space, offs, widths, row_w or width),
            row.scatters)


def _emit_rows(cd, spaces, ws, whole):
    """The per-row part of a data model: (C lines, invariant ops, the
    row-invariant values' count, the count of those some row reads other
    than by a per-row gather, SpaceTiles per row space).  One row space
    keeps the names rt_row, rt_fill_tile and rt_fill_tile_async; several
    define RT_SPACES and a RtSpace<s> each.  `whole`: the functions take
    the columns, which they read whole."""
    # row-invariant inputs of the row functions, computed once per call;
    # `dense`: the ones some row reads other than by a per-row gather
    frontier, seen, dense = [], set(), set()
    for space in spaces:
        for node in R.topological(list(space.roots)):
            if not space.dep[node.id]:
                continue
            for k in R.children_of(node):
                if space.dep[k.id] or isinstance(k, R.Constant):
                    continue
                if k.id not in seen:
                    seen.add(k.id)
                    frontier.append(k)
                if not (isinstance(node, R.Gather) and k is node.source
                        and isinstance(node.index, R.IntColumn)):
                    dense.add(k.id)
    sizer = _Emitter(cd, ws)
    for node in R.topological(frontier):
        sizer.forward(node)
    size = {f.id: sizer.size(f) for f in frontier}
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
    wc = ", const RtCols& cols" if whole else ""
    one = len(spaces) == 1
    row_sig = (f"float*{r} x, const float*{r} inv, float*{r} ainv"
               + (f", int*{r} sidx, float*{r} sval)" if ws else ")"))
    fill_sig = "(float* tile, const RtCols& cols, int row0, int rows, " \
               "int tid, int nt)"
    tiles, spaces_text = [], []
    for s, space in enumerate(spaces):
        body, tile, fill, fill_async, n_gathers = _space_rows(
            cd, space, ws, pre.grad, base, size, "RT_ROW_W" if one else None,
            n_dense)
        tiles.append(tile)
        gathers = ([f"// the row's {n_gathers} per-row gathers hand their "
                    "adjoints back in sidx/sval",
                    f"#define RT_GATHERS {n_gathers}"] if ws else [])
        if one:
            row_fn = [
                *gathers,
                "// one row's log-density; adds its adjoints of the "
                "row-invariant",
                "// values into ainv",
                f"RT_HD float rt_row(const {row_sig} {{", *body, "}"]
            fills = [
                "// rows [row0, row0 + rows) of every column into the tile, "
                "thread",
                "// tid of nt",
                f"RT_HD void rt_fill_tile{fill_sig} {{", *fill, "}",
                "",
                "// the same copies as rt_fill_tile, issued asynchronously "
                "(cp.async",
                "// on the card, a plain copy in host code); an index keeps "
                "its bits",
                f"RT_HD void rt_fill_tile_async{fill_sig} {{", *fill_async,
                "}"]
            continue
        spaces_text += [
            "",
            f"// row space {s}: {tile.n_rows} rows of {tile.row_width} "
            f"floats, tiles of {tile.tile_rows}",
            "template <>",
            f"struct RtSpace<{s}> {{",
            f"  enum {{ kW = {tile.row_width}, kTile = "
            f"{max(tile.tile_rows, 1)}"
            + (f", kGathers = {n_gathers}" if ws else "") + " };",
            "  // one row's log-density; adds its adjoints of the",
            "  // row-invariant values into ainv",
            f"  static RT_HD float row(const {row_sig} {{",
            *_indent(body), "  }",
            "  // rows [row0, row0 + rows) of the space's columns into the "
            "tile,",
            "  // thread tid of nt; then the same copies issued",
            "  // asynchronously",
            f"  static RT_HD void fill{fill_sig} {{", *_indent(fill), "  }",
            f"  static RT_HD void fill_async{fill_sig} {{",
            *_indent(fill_async), "  }",
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
    return lines, inv_ops, n_inv, n_dense, tuple(tiles)


def _cols_struct(columns):
    """RtCols, one pointer of its own type per column (int32 for an
    IntColumn), and rt_cols, which fills it from the launch's pointer
    array on the host."""
    types = ["const int*" if isinstance(c, R.IntColumn) else "const float*"
             for c in columns]
    return [
        "// the model's data columns, each with its own type",
        "struct RtCols {",
        *[f"  {t} c{j};" for j, t in enumerate(types)],
        *(["  const float* unused;"] if not columns else []),
        "};",
        "",
        "static inline RtCols rt_cols(const void* const* cols) {",
        "  RtCols out = {};",
        *[f"  out.c{j} = ({t})cols[{j}];" for j, t in enumerate(types)],
        "  (void)cols;",
        "  return out;",
        "}",
    ]


# CompiledDensity -> its EmittedDensity: a density is emitted once per
# process, however many checks and launches read it
_EMITTED = weakref.WeakKeyDictionary()


def emit(cd) -> EmittedDensity:
    """C source of the density for the CompiledDensity `cd`:
    ``rt_logp_grad`` over the column-free terms and, for a model with
    data, the row functions and tile loader of its RowSum likelihoods;
    with the chain state in the kernel's workspace where the model has
    over LOCAL_STATE_MAX parameters or row-invariant values, or, with
    rows, over LANE_STATE_MAX."""
    if cd not in _EMITTED:
        em = _emit(cd, cd.n_vars > LOCAL_STATE_MAX)
        cap = LANE_STATE_MAX if em.spaces else LOCAL_STATE_MAX
        if not em.workspace and max(em.n_vars, em.n_inv) > cap:
            em = _emit(cd, True)
        _EMITTED[cd] = em
    return _EMITTED[cd]


def workspace_floats(n_vars: int, n_inv: int, rows: bool,
                     n_dense: int = 0) -> int:
    """Floats of one chain's slot of the workspace: the seven state
    arrays (sc, q, g, qn, gn, p, x) and, with rows, inv, ainv and the
    LANES lanes' own copies of the `n_dense` adjoints that every row
    reads, rounded up to an even count (csrc/fused_hmc.cu,
    RT_WS_FLOATS)."""
    n = 7 * n_vars + (2 * max(n_inv, 1) + LANES * max(n_dense, 1)
                      if rows else 0)
    return n + n % 2


def _emit(cd, ws: bool) -> EmittedDensity:
    try:
        split = cd.row_split()
    except NoRowSplit as e:
        raise UnsupportedNode(
            f"{e} is not supported by the CUDA emitter") from None
    # the base terms read their columns whole, and so do the row-invariant
    # values of the rows
    whole = bool(find_columns(split.base)) or any(
        find_columns(list(sp.frontier)) for sp in split.spaces)
    roots = list(split.base)
    em = _Emitter(cd, ws)
    fwd, rev, total = _program(em, roots, total=True)
    lp_ops = max(len(total) - 1, 0)
    n = cd.n_vars
    rows, inv_ops, n_inv, n_dense, spaces = (
        _emit_rows(cd, split.spaces, ws, whole) if split.spaces
        else ([], 0, 0, 0, ()))
    slot = workspace_floats(n, n_inv, bool(spaces), n_dense) if ws else 0
    r = _RESTRICT if ws else ""
    # the shared memory of a tile slot: the widest space's tile
    top = max(spaces, key=lambda t: t.tile_rows * t.row_width,
              default=SpaceTiles(0, 0, 0, 0))
    src = "\n".join([
        "// Generated by rainier_tpu_torch.compute.emit_cuda: the model's",
        "// log-density and its reverse-mode gradient for one chain.",
        "#pragma once",
        '#include "rt_math.cuh"',
        "",
        f"#define RT_DIM {n}",
        f"#define RT_ROW_W {top.row_width}",
        f"#define RT_TILE {max(top.tile_rows, 1)}",
        *([f"#define RT_WS_FLOATS {slot}",
           f"#define RT_LANES {LANES if spaces else 1}"] if ws else []),
        *(["#define RT_WHOLE_COLS 1"] if whole else []),
        "",
        *_cols_struct(cd.columns),
        "",
        f"RT_HD float rt_logp_grad(const float*{r} q, float*{r} g"
        + (", const RtCols& cols" if whole else "") + ") {",
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
                          spaces=spaces, n_inv=n_inv, workspace=slot)
