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
``CompiledDensity.logp_lanes_split_fn``: the column-free terms (prior and
every likelihood that is not a ``RowSum``) as ``rt_logp_grad``, and each
top-level ``RowSum``'s child as a per-row function ``rt_row`` that reads
one row of every column from a tile and accumulates its adjoints.  The
nodes under that child that depend on no column are *row-invariant*:
``rt_rows_pre`` computes the ones the row function reads once per density
call, the row function accumulates their adjoints over the rows, and
``rt_rows_post`` runs their reverse pass once after the last row — reverse
mode through a broadcast, as the lanes evaluator's (1, C)-against-(n, C)
broadcasting is.  ``MatVec`` is p multiply-adds per row, and a ``Column``
view of a ``MatColumn`` that the tile holds reads the matrix's entry.
The tile loader comes twice: ``rt_fill_tile`` stores every element, and
``rt_fill_tile_async`` issues the same copies asynchronously, for a
launch that streams its columns through two tile slots.

An ``IntColumn`` is an int32 field of the tile row, carried bit for bit in
its float slot, so every int32 index is exact.  A ``Gather`` of a
row-invariant vector by it reads ``inv[k + clamp(i, 0, K - 1)]`` from the
vector's contiguous block of the row-invariant values (the clamp is
``mode="clip"`` of the lanes evaluator's take) and scatters its adjoint
to ``ainv[k + clamp(i, 0, K - 1)]``; one thread owns one chain, so the
scatter needs no atomics.  A ``Lookup`` by an ``IntColumn`` compares the
int index with each table entry, as for a float index.

The row-invariant values that only a per-row gather reads have their
adjoints accumulated in place over all rows; the ones every row reads
come first in ``inv`` (``RT_NINV_DENSE``), and the kernel sums their
adjoints in f32 per tile and f64 across tiles.

A model over ``LOCAL_STATE_MAX`` parameters or row-invariant values keeps
its chain state in a device-memory workspace (``RT_WS_FLOATS`` floats a
chain, csrc/fused_hmc.cu): its functions then take ``__restrict__``
pointers and its loops are unrolled by eight, so that loads of several
elements are in flight.  Smaller models emit exactly the text they did
before the workspace existed.

Outside the envelope, :class:`UnsupportedNode` names what is wrong: a
``Gather`` whose source varies by row or whose index is neither a
constant nor an ``IntColumn``, an ``IntColumn`` used as a value, a
``RowSum`` below the top level, and a model whose column-free terms
reference columns.
"""

from __future__ import annotations

import math
import weakref
from dataclasses import dataclass

import numpy as np

from . import real as R
from .compiler import find_columns

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
                          # from the row terms: the column-free terms plus
                          # the row-invariant forward and reverse passes
    row_ops: int = 0      # f32 operations of one row's forward + adjoints
    row_width: int = 0    # floats of one row in a tile (0: no row terms)
    tile_rows: int = 0    # rows per tile (0 with row_width: too wide)
    n_rows: int = 0       # rows of the columns
    n_inv: int = 0        # row-invariant values the row function reads
    workspace: int = 0    # floats of one chain's slot in the kernel's
                          # device-memory workspace (0: state in registers)

    def density_ops(self) -> int:
        """f32 operations of one density + gradient over all rows."""
        return self.ops + self.n_rows * self.row_ops


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
    if isinstance(node, (R.Column, R.IntColumn, R.MatColumn)):
        raise UnsupportedNode(
            f"{type(node).__name__} outside the per-row child of a "
            "top-level RowSum likelihood is not supported by the CUDA "
            "emitter")
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
        self.fops = 0
        self.rops = 0
        self.lse: dict[int, tuple] = {}   # LogSumExp node → (maxes, sums)
        self.mats: dict[int, int] = {}    # MatColumn → offset in the row
        self.ints: dict[int, str] = {}    # IntColumn → its int32 in the row
        self.inv_base: dict[int, int] = {}  # row-invariant node → its
                                            # first slot in inv / ainv
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
            target = self.loop_acc.setdefault(node.id, f"t{node.id}")
        else:
            a = self.adj[node.id]
            target = a[i if len(a) > 1 else 0]
        self.rev.append(f"  {target} += {expr};")
        self.rops += (ops + 1) * self.mult

    # -- forward ----------------------------------------------------------
    def forward(self, node) -> None:
        nid = node.id
        layout = self.cd.layout
        if nid in self.vals or nid in self.mats or nid in self.ints:
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
            return
        kids = _children_checked(node)
        for k in kids:
            if k.id in self.mats and not (isinstance(node, R.MatVec)
                                          and k is node.mat):
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
            # a RowSum reaches here only with a column-free child, which
            # every row adds once (compiler.py's tile_fn: child · Σmask)
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
            # one row of the matrix times a row-invariant vector
            off, p = self.mats[node.mat.id], node.mat.n_cols
            if self.size(node.vec) != p:
                raise UnsupportedNode(
                    f"MatVec of a {p}-column matrix by a vector of "
                    f"{self.size(node.vec)}")
            self.define(node, ["(" + " + ".join(
                f"x[{off + j}] * {self.el(node.vec, j)}"
                for j in range(p)) + ")"], 2 * p - 1)
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
                off = self.mats[node.mat.id]
                for j in range(node.mat.n_cols):
                    self.acc(node.vec, j, f"{a} * x[{off + j}]", 1)
            elif isinstance(node, R.Gather):
                j = _static_slot(node, self.size(node.source))
                if j is not None and node.source.id in self.loop_len:
                    pass        # seeded in the source's loop
                elif j is not None:
                    self.acc(node.source, j, a, 0)
                elif self.grad[node.source.id]:
                    # the scatter: the thread owns its chain's ainv
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


def _seeds(em, roots) -> list[str]:
    """adjoint(root) += 1 for every root that depends on q (a loop's root
    is seeded in its loop)."""
    out = []
    for r in roots:
        if em.grad[r.id] and r.id not in em.loop_len:
            a = em.adj[r.id]
            out += [f"  {a[i if len(a) > 1 else 0]} += 1.0f;"
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
    keep the arrays there; over the workspace, unrolling by eight keeps
    loads of several elements in flight."""
    return [*pre, f"#pragma unroll {8 if em.ws else 1}",
            f"  for (int i = 0; i < {k}; ++i) {{", *_indent(body), "  }",
            *post]


def _loop_forward(em, loop, total, store):
    """The forward loop: the body, then each reader's sum or element, and
    the roots' sum or store.  Empty where nothing reads the body in the
    forward pass."""
    if not any(kind != "root" or total or store is not None
               for kind, _, _ in loop.outs):
        return []
    body = _loop_body(em, loop)
    pre = []
    for kind, c, reader in loop.outs:
        v = em.el(c, 0)
        if kind == "sum":
            pre.append(f"  double r{reader.id} = 0.0;")
            body.append(f"  r{reader.id} += {v};")
            em.fops += loop.k
        elif kind == "capture":
            j = _static_slot(reader, loop.k)
            pre.append(f"  float k{reader.id} = 0.0f;")
            body.append(f"  if (i == {j}) k{reader.id} = {v};")
        elif total:
            pre.append(f"  double r{c.id} = 0.0;")
            body.append(f"  r{c.id} += {v};")
            em.fops += loop.k
        elif store is not None:
            body.append(store(c, "i", v))
    em.mult = 1
    return _loop(em, loop.k, pre, body, [])


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
        em, loop.k, [f"  double {t} = 0.0;" for t in accs.values()], body,
        [f"  {em.adj[nid][0]} += (float){t};" for nid, t in accs.items()])),
        "  }"]


def _row_layout(cd):
    """Where each column sits in a tile row: ({column id: offset of its
    first float}, [floats loaded per column], row width).  A Column view
    of a MatColumn that the tile holds reads the matrix's entry and loads
    nothing of its own; an IntColumn takes one 32-bit slot."""
    held = {c.id for c in cd.columns if isinstance(c, R.MatColumn)}
    offs, widths, w = {}, [], 0
    for c in cd.columns:
        if isinstance(c, R.MatColumn):
            offs[c.id], width = w, c.n_cols
        elif (isinstance(c, R.Column) and c.matrix_ref is not None
              and c.matrix_ref[0].id in held):
            width = 0
        else:
            offs[c.id], width = w, 1
        widths.append(width)
        w += width
    for c in cd.columns:
        if c.id not in offs:
            mat, j = c.matrix_ref
            offs[c.id] = offs[mat.id] + j
    return offs, widths, w


def _row_dependence(order) -> dict:
    """node id → whether its value differs from row to row."""
    dep = {}
    for node in order:
        if isinstance(node, (R.Column, R.IntColumn, R.MatColumn)):
            dep[node.id] = True
            continue
        kids = _children_checked(node)
        dep[node.id] = any(dep[k.id] for k in kids)
        if not dep[node.id]:
            continue
        if isinstance(node, R.RowSum):
            raise UnsupportedNode(
                "a RowSum over data that is not a top-level likelihood is "
                "not supported by the CUDA emitter")
        if isinstance(node, R.VecSum):
            raise UnsupportedNode(
                "VecSum across the rows of a column is not supported by "
                "the CUDA emitter")
        if isinstance(node, R.Gather) and dep[node.source.id]:
            raise UnsupportedNode(
                "a Gather whose source varies by row is not supported by "
                "the CUDA emitter")
    return dep


def _emit_rows(cd, row_roots, ws):
    """The per-row part of a data model: (C lines, row ops, invariant
    ops, row width, n_rows, row-invariant values)."""
    order = R.topological(row_roots)
    dep = _row_dependence(order)
    n_rows = {c.n_rows for c in cd.columns}
    if len(n_rows) != 1:
        raise UnsupportedNode(f"columns of different lengths {sorted(n_rows)}"
                              " are not supported by the CUDA emitter")
    # row-invariant inputs of the row function, computed once per call;
    # `dense`: the ones some row reads other than by a per-row gather
    frontier, seen, dense = [], set(), set()
    for node in order:
        if dep[node.id]:
            for k in R.children_of(node):
                if dep[k.id] or isinstance(k, R.Constant):
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

    row = _Emitter(cd, ws)
    store, post_seeds = [], []
    for f in frontier:
        b, looped = base[f.id], f.id in pre.loop_len
        row.vals[f.id] = [f"inv[{b + i}]" for i in range(size[f.id])]
        row.inv_base[f.id] = b
        row.grad[f.id] = pre.grad[f.id]
        if not looped:
            store += [f"  inv[{b + i}] = {pre.el(f, i)};"
                      for i in range(size[f.id])]
        if pre.grad[f.id]:
            row.adj[f.id] = [f"ainv[{b + i}]" for i in range(size[f.id])]
            a = post.adj[f.id]
            if not looped:
                post_seeds += [f"  {a[i if len(a) > 1 else 0]} += "
                               f"ainv[{b + i}];" for i in range(size[f.id])]
    offs, widths, width = _row_layout(cd)
    for c in cd.columns:
        row.grad[c.id] = False
        if isinstance(c, R.MatColumn):
            row.mats[c.id] = offs[c.id]
        elif isinstance(c, R.IntColumn):
            row.ints[c.id] = f"rt_bits_int(x[{offs[c.id]}])"
        else:
            row.vals[c.id] = [f"x[{offs[c.id]}]"]
    for node in order:
        if dep[node.id] or isinstance(node, R.Constant):
            row.forward(node)
            if (dep[node.id] and node.id in row.vals
                    and row.size(node) > 1):
                raise UnsupportedNode(
                    f"a per-row value of vector width {row.size(node)} is "
                    "not supported by the CUDA emitter")
    seeds = _seeds(row, row_roots)
    for node in reversed(order):
        if dep[node.id]:
            row.backward(node)
    total = " + ".join(row.el(r, 0) for r in row_roots)
    n_ninv = max(n_inv, 1)
    fill, fill_async = [], []
    for j, (c, w) in enumerate(zip(cd.columns, widths)):
        o = offs[c.id]
        if w == 1:
            v = f"cols.c{j}[row0 + i]"
            loop = "  for (int i = tid; i < rows; i += nt) "
            dst = f"tile[i * RT_ROW_W + {o}]"
            fill.append(f"{loop}{dst} = " + (
                f"rt_int_bits({v})" if isinstance(c, R.IntColumn) else v)
                + ";")
            fill_async.append(f"{loop}rt_copy_async(&{dst}, &{v});")
        elif w > 1:
            dst = f"tile[r * RT_ROW_W + {o} + i - r * {w}]"
            v = f"cols.c{j}[(size_t)row0 * {w} + i]"
            head = [f"  for (int i = tid; i < rows * {w}; i += nt) {{",
                    f"    const int r = i / {w};"]
            fill += [*head, f"    {dst} = {v};", "  }"]
            fill_async += [*head, f"    rt_copy_async(&{dst}, &{v});", "  }"]
    r = _RESTRICT if ws else ""
    lines = [
        f"#define RT_NINV {n_inv}",
        f"#define RT_NINV_ALLOC {n_ninv}",
        *([f"#define RT_NINV_DENSE {n_dense}",
           f"#define RT_NINV_DENSE_ALLOC {max(n_dense, 1)}"]
          if n_dense != n_inv else []),
        "",
        "// the row-invariant values the row function reads",
        f"RT_HD void rt_rows_pre(const float*{r} q, float*{r} inv) {{",
        *pre_fwd, *store,
        "}",
        "",
        "// one row's log-density; adds its adjoints of the row-invariant",
        "// values into ainv",
        f"RT_HD float rt_row(const float*{r} x, const float*{r} inv, "
        f"float*{r} ainv) {{",
        *row.fwd,
        *_decls(row, [n for n in order if dep[n.id]]),
        *seeds, *row.rev,
        f"  return {total};",
        "}",
        "",
        "// the reverse pass of the row-invariant values, from the adjoints",
        "// summed over all rows; adds into g",
        f"RT_HD void rt_rows_post(const float*{r} q, const float*{r} ainv, "
        f"float*{r} g) {{",
        *post_fwd, *_decls(post, R.topological(frontier)), *post_seeds,
        *post_rev,
        "}",
        "",
        "// rows [row0, row0 + rows) of every column into the tile, thread",
        "// tid of nt",
        "RT_HD void rt_fill_tile(float* tile, const RtCols& cols, int row0, "
        "int rows, int tid, int nt) {",
        *fill,
        "}",
        "",
        "// the same copies as rt_fill_tile, issued asynchronously (cp.async",
        "// on the card, a plain copy in host code); an index keeps its bits",
        "RT_HD void rt_fill_tile_async(float* tile, const RtCols& cols, "
        "int row0, int rows, int tid, int nt) {",
        *fill_async,
        "}",
    ]
    row_ops = row.fops + row.rops + len(row_roots)
    inv_ops = pre.fops + post.fops + post.rops + len(post_seeds)
    return lines, row_ops, inv_ops, width, n_rows.pop(), n_inv


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
    over LOCAL_STATE_MAX parameters or row-invariant values."""
    if cd not in _EMITTED:
        em = _emit(cd, cd.n_vars > LOCAL_STATE_MAX)
        if not em.workspace and em.n_inv > LOCAL_STATE_MAX:
            em = _emit(cd, True)
        _EMITTED[cd] = em
    return _EMITTED[cd]


def workspace_floats(n_vars: int, n_inv: int, rows: bool) -> int:
    """Floats of one chain's slot of the workspace: the seven state
    arrays (sc, q, g, qn, gn, p, x) and, with rows, inv and ainv, rounded
    up to an even count (csrc/fused_hmc.cu, RT_WS_FLOATS)."""
    n = 7 * n_vars + (2 * max(n_inv, 1) if rows else 0)
    return n + n % 2


def _emit(cd, ws: bool) -> EmittedDensity:
    row_lh = [l for l in cd.likelihoods if isinstance(l, R.RowSum)
              and cd.columns and find_columns([l.child])]
    if cd.columns and cd.logp_lanes_split_fn() is None:
        raise UnsupportedNode(
            "the model's column-free terms reference data columns, so its "
            "density has no base/row split for the CUDA emitter")
    row_ids = {l.id for l in row_lh}
    roots = [l for l in cd.likelihoods if l.id not in row_ids] + [cd._prior]
    em = _Emitter(cd, ws)
    fwd, rev, total = _program(em, roots, total=True)
    lp_ops = max(len(total) - 1, 0)
    n = cd.n_vars
    rows, row_ops, inv_ops, width, n_rows, n_inv = (
        _emit_rows(cd, [l.child for l in row_lh], ws) if row_lh
        else ([], 0, 0, 0, 0, 0))
    slot = workspace_floats(n, n_inv, bool(row_lh)) if ws else 0
    r = _RESTRICT if ws else ""
    tile = tile_rows(width) if width else 0
    src = "\n".join([
        "// Generated by rainier_tpu_torch.compute.emit_cuda: the model's",
        "// log-density and its reverse-mode gradient for one chain.",
        "#pragma once",
        '#include "rt_math.cuh"',
        "",
        f"#define RT_DIM {n}",
        f"#define RT_ROW_W {width}",
        f"#define RT_TILE {max(tile, 1)}",
        *([f"#define RT_WS_FLOATS {slot}"] if ws else []),
        "",
        *_cols_struct(cd.columns),
        "",
        f"RT_HD float rt_logp_grad(const float*{r} q, float*{r} g) {{",
        f"  for (int j = 0; j < {n}; ++j) g[j] = 0.0f;",
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
                          row_ops=row_ops, row_width=width, tile_rows=tile,
                          n_rows=n_rows, n_inv=n_inv, workspace=slot)
