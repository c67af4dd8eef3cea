"""Static interval analysis over the Real DAG.

A copy of ``rainier_tpu/compute/bounds.py`` (counterpart of
compute/Bounds.scala:5-141).  Two uses, same as the reference:

1. ``check(x, msg, pred)`` — eager validation of distribution parameters
   (e.g. ``Normal(0, -1)`` raises at model-construction time).
2. ``guard_positive`` / ``guard_zero_to_one`` — range guards on density
   arguments inserted *only when the bounds cannot prove them redundant*
   (compute/Bounds.scala:106-127), with a warning logged when a guard
   materializes.
"""

from __future__ import annotations

import logging
import math

import numpy as np

from . import real as R

log = logging.getLogger("rainier_tpu_torch")

NEG_INF = -math.inf
INF = math.inf
FULL = (NEG_INF, INF)


def _mul_pt(a: float, b: float) -> float:
    # interval endpoints: 0 * inf counts as 0 (limit semantics, cf.
    # compute/Bounds.scala interval pow/mul handling)
    if (a == 0.0 and math.isinf(b)) or (b == 0.0 and math.isinf(a)):
        return 0.0
    return a * b


def _unary_bounds(op: str, b):
    lo, hi = b
    if op == "neg":
        return (-hi, -lo)
    if op == "exp":
        return (math.exp(lo) if lo > -700 else 0.0,
                math.exp(hi) if hi < 700 else INF)
    if op == "expm1":
        e = _unary_bounds("exp", b)
        return (e[0] - 1.0, e[1] - 1.0)
    if op == "log":
        if hi <= 0:
            return FULL
        return (math.log(lo) if lo > 0 else NEG_INF,
                math.log(hi) if hi < INF else INF)
    if op == "log1p":
        return _unary_bounds("log", (lo + 1.0, hi + 1.0))
    if op == "sqrt":
        if hi < 0:
            return FULL
        return (math.sqrt(max(lo, 0.0)), math.sqrt(hi) if hi < INF else INF)
    if op == "abs":
        if lo >= 0:
            return (lo, hi)
        if hi <= 0:
            return (-hi, -lo)
        return (0.0, max(-lo, hi))
    if op in ("sin", "cos"):
        return (-1.0, 1.0)
    if op == "tan":
        return FULL
    if op in ("asin", "acos"):
        return (-math.pi, math.pi)
    if op == "atan":
        return (math.atan(lo), math.atan(hi))
    if op == "sinh":
        return (math.sinh(lo) if abs(lo) < 700 else math.copysign(INF, lo),
                math.sinh(hi) if abs(hi) < 700 else math.copysign(INF, hi))
    if op == "cosh":
        m = 1.0 if (lo <= 0.0 <= hi) else min(math.cosh(min(abs(lo), 700)),
                                              math.cosh(min(abs(hi), 700)))
        top = max(math.cosh(min(abs(lo), 700)), math.cosh(min(abs(hi), 700)))
        return (m, top if max(abs(lo), abs(hi)) < 700 else INF)
    if op == "tanh":
        return (math.tanh(lo), math.tanh(hi))
    if op == "logistic":
        def sig(x):
            if x > 36:
                return 1.0
            if x < -36:
                return 0.0
            return 1.0 / (1.0 + math.exp(-x))
        return (sig(lo), sig(hi))
    if op == "logit":
        return FULL
    if op == "lgamma":
        if lo > 0:
            return (-0.1215, INF)  # min of lgamma on (0,inf) ≈ -0.12149
        return FULL
    if op == "softplus":
        def sp(x):
            if x > 36:
                return x
            if x < -700:
                return 0.0
            return math.log1p(math.exp(x))
        return (sp(lo), sp(hi))
    return FULL


def _binary_bounds(op: str, a, b):
    alo, ahi = a
    blo, bhi = b
    if op == "add":
        return (alo + blo if not (math.isinf(alo) and math.isinf(blo)
                                  and alo != blo) else NEG_INF,
                ahi + bhi if not (math.isinf(ahi) and math.isinf(bhi)
                                  and ahi != bhi) else INF)
    if op == "sub":
        return _binary_bounds("add", a, (-bhi, -blo))
    if op == "mul":
        pts = [_mul_pt(alo, blo), _mul_pt(alo, bhi), _mul_pt(ahi, blo),
               _mul_pt(ahi, bhi)]
        return (min(pts), max(pts))
    if op == "div":
        if blo <= 0.0 <= bhi:
            return FULL
        pts = []
        for x in (alo, ahi):
            for y in (blo, bhi):
                if math.isinf(x) and math.isinf(y):
                    pts += [0.0]
                elif y == 0.0:
                    pts += [math.copysign(INF, x) if x != 0 else 0.0]
                else:
                    pts += [x / y]
        return (min(pts), max(pts))
    if op == "pow":
        if alo >= 0:
            with np.errstate(all="ignore"):
                pts = [float(np.power(x, y)) for x in (alo, ahi)
                       for y in (blo, bhi)]
            pts = [0.0 if math.isnan(p) else p for p in pts]
            extra = [1.0] if (blo <= 0.0 <= bhi or alo <= 1.0 <= ahi) else []
            return (min(pts + extra), max(pts + extra))
        return FULL
    if op == "min":
        return (min(alo, blo), min(ahi, bhi))
    if op == "max":
        return (max(alo, blo), max(ahi, bhi))
    return FULL


def bounds_of(node: R.Real, memo: dict | None = None):
    """Interval for every value the expression can take (over all parameter
    values and all data rows)."""
    if node._bounds is not None:
        return node._bounds
    order = R.topological([node])
    for n in order:
        if n._bounds is not None:
            continue
        if isinstance(n, R.Constant):
            b = (n.value, n.value)
        elif isinstance(n, (R.Parameter, R.VectorParameter)):
            b = FULL
        elif isinstance(n, R.Column):
            # data is known ahead of time — the reference exploits this via
            # Target.inlinable; we exploit it for guard elision.
            b = (float(n.values.min()), float(n.values.max())) \
                if n.values.size else FULL
        elif isinstance(n, (R.IntColumn, R.MatColumn)):
            b = (float(n.values.min()), float(n.values.max())) \
                if n.values.size else FULL
        elif isinstance(n, R.MatVec):
            b = FULL
        elif isinstance(n, R.Unary):
            b = _unary_bounds(n.op, n.child._bounds)
        elif isinstance(n, R.Binary):
            b = _binary_bounds(n.op, n.left._bounds, n.right._bounds)
        elif isinstance(n, R.NArySum):
            lo = sum(c._bounds[0] for c in n.children)
            hi = sum(c._bounds[1] for c in n.children)
            b = (lo, hi)
        elif isinstance(n, R.LogSumExp):
            his = [c._bounds[1] for c in n.children]
            los = [c._bounds[0] for c in n.children]
            b = (max(los), max(his) + math.log(len(n.children)))
        elif isinstance(n, R.Select):
            t, f = n.if_true._bounds, n.if_false._bounds
            b = (min(t[0], f[0]), max(t[1], f[1]))
        elif isinstance(n, R.Compare):
            b = (-1.0, 1.0)
        elif isinstance(n, R.Lookup):
            b = (min(t._bounds[0] for t in n.table),
                 max(t._bounds[1] for t in n.table))
        elif isinstance(n, R.Gather):
            b = n.source._bounds
        elif isinstance(n, R.RowSum):
            lo, hi = n.child._bounds
            k = n.n_rows
            b = (_mul_pt(float(k), lo) if lo < 0 else lo,
                 _mul_pt(float(k), hi) if hi > 0 else hi)
        elif isinstance(n, R.VecSum):
            lo, hi = n.child._bounds
            k = n.k
            b = (_mul_pt(float(k), lo) if lo < 0 else lo,
                 _mul_pt(float(k), hi) if hi > 0 else hi)
        else:
            b = FULL
        n._bounds = b
    return node._bounds


def check(x: R.Real, message: str, pred) -> None:
    """Validate a distribution parameter eagerly when it is a constant
    (cf. Bounds.check usage across core/Continuous.scala)."""
    if isinstance(x, R.Constant):
        if not pred(x.value):
            raise ValueError(f"bounds check failed: {message} (got {x.value})")


def guard_positive(x: R.Real, body: R.Real) -> R.Real:
    """`body` if x > 0 else -inf, eliding the guard when provable
    (compute/Bounds.scala:106-113)."""
    lo, _ = bounds_of(x)
    if lo >= 0:
        # [0, hi]: no NaN possible (log(0) = -inf is the correct boundary
        # value), so the guard is redundant
        return body
    log.warning("unprovable bound x > 0; inserting guard (cf. "
                "compute/Bounds.scala WARNING semantics)")
    return R.gt(x, R.zero, body, R.neg_infinity)


def guard_zero_to_one(x: R.Real, body: R.Real) -> R.Real:
    """`body` if 0 < x < 1 (compute/Bounds.scala zeroToOne)."""
    lo, hi = bounds_of(x)
    if lo >= 0 and hi <= 1:
        return body
    log.warning("unprovable bound 0 < x < 1; inserting guard")
    return R.gt(x, R.zero, R.lt(x, R.one, body, R.neg_infinity),
                R.neg_infinity)
