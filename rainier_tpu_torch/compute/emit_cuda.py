"""Code generator: Real DAG → C source of ``logp`` and its gradient.

The JAX package's fused kernel evaluates a model by tracing
``logp_lanes_fn`` inside the kernel body and calling ``jax.grad`` there
(rainier_tpu/ops/hmc_pallas.py:282-301).  A CUDA kernel can do neither, so
this module plays the part of the reference's Gradient + bytecode codegen
(rainier-compute Gradient.scala, ir/*): it writes

    RT_HD float rt_logp_grad(const float* q, float* g)

for ONE chain in natural coordinates — the forward pass in topological
order, then reverse-mode adjoints in reverse order — as straight-line
code over scalars.  A ``VectorParameter(k)`` and everything that
broadcasts from it is unrolled into k scalars, so every value lives in a
register of the thread that owns the chain.

Each derivative follows the convention of ``jax.grad`` (the reference):
``min``/``max`` split the adjoint at ties, ``abs`` has derivative 1 at 0,
``pow``'s exponent adjoint uses ``log(x == 0 ? 1 : x)``, ``lgamma``'s is
a hand-written digamma, and ``softplus``/``logistic`` use stable forms.

Data columns (``Column``, ``IntColumn``, ``MatColumn``) and the nodes
over them (``MatVec``, ``RowSum``, a ``Gather`` by a column) come in a
later slice; :class:`UnsupportedNode` says so.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from . import real as R

HEADER_NAME = "rt_model.h"


class UnsupportedNode(NotImplementedError):
    """The graph holds a node the CUDA emitter does not cover yet."""


@dataclass(frozen=True)
class EmittedDensity:
    source: str           # the rt_model.h text
    n_vars: int
    ops: int              # f32 operations of one logp + gradient


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
    if isinstance(node, (R.Column, R.IntColumn, R.MatColumn, R.MatVec,
                         R.RowSum)):
        raise UnsupportedNode(
            f"{type(node).__name__} is not yet supported by the CUDA "
            "emitter (data columns come in a later slice)")
    if isinstance(node, R.Gather) and not isinstance(node.index,
                                                     R.Constant):
        raise UnsupportedNode(
            "Gather by a non-constant index is not yet supported by the "
            "CUDA emitter (data columns come in a later slice)")
    return R.children_of(node)


class _Emitter:
    def __init__(self, cd):
        self.cd = cd
        self.fwd: list[str] = []
        self.rev: list[str] = []
        self.vals: dict[int, list[str]] = {}
        self.adj: dict[int, list[str]] = {}
        self.grad: dict[int, bool] = {}
        self.fops = 0
        self.rops = 0
        self.lse: dict[int, tuple] = {}   # LogSumExp node → (maxes, sums)

    # -- helpers ----------------------------------------------------------
    def size(self, node) -> int:
        return len(self.vals[node.id])

    def el(self, node, i: int) -> str:
        v = self.vals[node.id]
        return v[i] if len(v) > 1 else v[0]

    def bsize(self, nodes) -> int:
        sizes = {self.size(n) for n in nodes} - {1}
        if len(sizes) > 1:
            raise UnsupportedNode(
                f"cannot broadcast vector lengths {sorted(sizes)}")
        return sizes.pop() if sizes else 1

    def define(self, node, exprs: list[str], ops_each: int) -> None:
        names = []
        for i, e in enumerate(exprs):
            name = f"v{node.id}" + (f"_{i}" if len(exprs) > 1 else "")
            self.fwd.append(f"  const float {name} = {e};")
            names.append(name)
        self.vals[node.id] = names
        self.fops += ops_each * len(exprs)

    def acc(self, node, i: int, expr: str, ops: int) -> None:
        """adjoint(node)[i] += expr (broadcast children accumulate)."""
        if not self.grad[node.id]:
            return
        a = self.adj[node.id]
        self.rev.append(f"  {a[i if len(a) > 1 else 0]} += {expr};")
        self.rops += ops + 1

    # -- forward ----------------------------------------------------------
    def forward(self, node) -> None:
        nid = node.id
        layout = self.cd.layout
        if isinstance(node, R.Constant):
            self.vals[nid] = [_lit(node.value)]
            self.grad[nid] = False
            return
        if isinstance(node, (R.Parameter, R.VectorParameter)):
            if node not in layout.parameters:
                raise UnsupportedNode(f"parameter {node!r} outside layout")
            a, b = layout.slices[layout.parameters.index(node)]
            self.vals[nid] = [f"q[{j}]" for j in range(a, b)]
            self.adj[nid] = [f"g[{j}]" for j in range(a, b)]
            self.grad[nid] = True
            return
        kids = _children_checked(node)
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
            self.define(node, [fmt.format(x=self.el(node.child, i))
                               for i in range(self.size(node.child))], ops)
        elif isinstance(node, R.Binary):
            n = self.bsize([node.left, node.right])
            self.define(node, [_BINARY[node.op].format(
                x=self.el(node.left, i), y=self.el(node.right, i))
                for i in range(n)], 1)
        elif isinstance(node, R.NArySum):
            n = self.bsize(node.children)
            self.define(node, ["(" + " + ".join(
                self.el(c, i) for c in node.children) + ")"
                for i in range(n)], len(node.children) - 1)
        elif isinstance(node, R.LogSumExp):
            # pairwise max, shifted exp sum: the lanes evaluator's formula
            n = self.bsize(node.children)
            ms, ss, outs = [], [], []
            for i in range(n):
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
            self.define(node, outs, 2)
            self.lse[nid] = (ms, ss)
        elif isinstance(node, R.Select):
            n = self.bsize([node.left, node.right, node.if_true,
                            node.if_false])
            op = _PRED[node.pred]
            conds = []
            for i in range(n):
                c = f"c{nid}_{i}"
                self.fwd.append(f"  const bool {c} = {self.el(node.left, i)}"
                                f" {op} {self.el(node.right, i)};")
                conds.append(c)
            self.define(node, [f"({c} ? {self.el(node.if_true, i)} : "
                               f"{self.el(node.if_false, i)})"
                               for i, c in enumerate(conds)], 2)
        elif isinstance(node, R.Compare):
            n = self.bsize([node.left, node.right])
            self.define(node, [f"rt_sign({self.el(node.left, i)} - "
                               f"{self.el(node.right, i)})"
                               for i in range(n)], 2)
        elif isinstance(node, R.Lookup):
            n = self.bsize([node.index] + list(node.table))
            outs = []
            for i in range(n):
                ix = f"i{nid}_{i}"
                self.fwd.append(f"  const int {ix} = rt_f2i("
                                f"{self.el(node.index, i)}) - {node.low};")
                outs.append("(" + " + ".join(
                    f"({ix} == {k} ? {self.el(t, i)} : 0.0f)"
                    for k, t in enumerate(node.table)) + ")")
            self.define(node, outs, 2 * len(node.table))
        elif isinstance(node, R.VecSum):
            c = node.child
            if self.size(c) == 1:
                self.define(node, [f"({self.el(c, 0)} * {_lit(node.k)})"], 1)
            else:
                self.define(node, ["(" + " + ".join(self.vals[c.id]) + ")"],
                            self.size(c) - 1)
        elif isinstance(node, R.Gather):
            k = self.size(node.source)
            j = min(max(int(node.index.value), 0), k - 1)
            self.define(node, [self.el(node.source, j)], 0)
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
            elif isinstance(node, R.VecSum):
                c = node.child
                if self.size(c) == 1:
                    self.acc(c, 0, f"{a} * {_lit(node.k)}", 1)
                else:
                    for j in range(self.size(c)):
                        self.acc(c, j, a, 0)
            elif isinstance(node, R.Gather):
                k = self.size(node.source)
                j = min(max(int(node.index.value), 0), k - 1)
                self.acc(node.source, j, a, 0)

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


def emit(cd) -> EmittedDensity:
    """C source of ``rt_logp_grad`` for the CompiledDensity `cd`."""
    roots = cd.roots
    em = _Emitter(cd)
    order = R.topological(roots)
    for node in order:
        em.forward(node)
    total = [em.el(r, i) for r in roots for i in range(em.size(r))]
    lp_ops = max(len(total) - 1, 0)
    seeds = []
    for r in roots:
        if em.grad[r.id]:
            for i in range(em.size(r)):
                a = em.adj[r.id]
                seeds.append(f"  {a[i if len(a) > 1 else 0]} += 1.0f;")
    for node in reversed(order):
        em.backward(node)
    decls = [f"  float {a} = 0.0f;"
             for node in order if em.grad.get(node.id)
             and not isinstance(node, (R.Parameter, R.VectorParameter))
             for a in em.adj[node.id]]
    n = cd.n_vars
    src = "\n".join([
        "// Generated by rainier_tpu_torch.compute.emit_cuda: the model's",
        "// log-density and its reverse-mode gradient for one chain.",
        "#pragma once",
        '#include "rt_math.cuh"',
        "",
        f"#define RT_DIM {n}",
        "",
        "RT_HD float rt_logp_grad(const float* q, float* g) {",
        f"  for (int j = 0; j < {n}; ++j) g[j] = 0.0f;",
        *em.fwd,
        "  const float lp = " + (" + ".join(total) or "0.0f") + ";",
        *decls,
        *seeds,
        *em.rev,
        "  return lp;",
        "}",
        "",
    ])
    return EmittedDensity(source=src, n_vars=n,
                          ops=em.fops + lp_ops + em.rops)
