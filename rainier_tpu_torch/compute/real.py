"""Symbolic scalar expression DAG — the modeling-layer IR.

A copy of ``rainier_tpu/compute/real.py`` (the port keeps its own copy so
it never imports the JAX package).  Counterpart of rainier-compute's
``Real`` graph (reference: rainier-compute/.../compute/Real.scala:9-43 and
RealOps.scala): a declarative model-building surface, construction-time
constant folding, and the leaves the compiler binds.  Lowering is done by
``compute/compiler.py`` (PyTorch, for the scan path) and
``compute/emit_cuda.py`` (C source for the fused CUDA kernel).  Comments
below that speak of XLA or the TPU describe the JAX package this file
was copied from.
"""

from __future__ import annotations

import itertools
import math
from fractions import Fraction
from typing import Callable, Optional, Sequence, Union

import numpy as np

_ids = itertools.count()

RealLike = Union["Real", float, int]

# Unary op names understood by every backend (compute/Real.scala ops list;
# reference has no sqrt/log1p/expm1/softplus — added because XLA has fast
# native lowerings and the densities benefit).
UNARY_OPS = frozenset(
    {
        "exp", "log", "abs", "sqrt", "sin", "cos", "tan", "asin", "acos",
        "atan", "sinh", "cosh", "tanh", "logistic", "logit", "log1p",
        "expm1", "softplus", "neg", "lgamma",
    }
)
BINARY_OPS = frozenset({"add", "sub", "mul", "div", "pow", "min", "max"})
COMPARE_OPS = frozenset({"eq", "lt", "gt", "lte", "gte"})


class Real:
    """A node in the scalar expression DAG.

    All arithmetic routes through module-level smart constructors that
    constant-fold eagerly (cf. compute/RealOps.scala:8-61) but perform no
    other rewriting — XLA owns simplification.
    """

    __slots__ = ("id", "_bounds")

    def __init__(self) -> None:
        self.id = next(_ids)
        self._bounds = None

    # -- arithmetic -------------------------------------------------------
    def __add__(self, other: RealLike) -> "Real":
        return add(self, to_real(other))

    def __radd__(self, other: RealLike) -> "Real":
        return add(to_real(other), self)

    def __sub__(self, other: RealLike) -> "Real":
        return binary(self, to_real(other), "sub")

    def __rsub__(self, other: RealLike) -> "Real":
        return binary(to_real(other), self, "sub")

    def __mul__(self, other: RealLike) -> "Real":
        return multiply(self, to_real(other))

    def __rmul__(self, other: RealLike) -> "Real":
        return multiply(to_real(other), self)

    def __truediv__(self, other: RealLike) -> "Real":
        return binary(self, to_real(other), "div")

    def __rtruediv__(self, other: RealLike) -> "Real":
        return binary(to_real(other), self, "div")

    def __pow__(self, other: RealLike) -> "Real":
        return binary(self, to_real(other), "pow")

    def __rpow__(self, other: RealLike) -> "Real":
        return binary(to_real(other), self, "pow")

    def __neg__(self) -> "Real":
        return unary(self, "neg")

    def pow(self, other: RealLike) -> "Real":
        return self.__pow__(other)

    # -- unary helpers (compute/Real.scala:24-43) -------------------------
    def exp(self) -> "Real":
        return unary(self, "exp")

    def log(self) -> "Real":
        return unary(self, "log")

    def log1p(self) -> "Real":
        return unary(self, "log1p")

    def expm1(self) -> "Real":
        return unary(self, "expm1")

    def softplus(self) -> "Real":
        return unary(self, "softplus")

    def sqrt(self) -> "Real":
        return unary(self, "sqrt")

    def abs(self) -> "Real":
        return unary(self, "abs")

    def sin(self) -> "Real":
        return unary(self, "sin")

    def cos(self) -> "Real":
        return unary(self, "cos")

    def tan(self) -> "Real":
        return unary(self, "tan")

    def asin(self) -> "Real":
        return unary(self, "asin")

    def acos(self) -> "Real":
        return unary(self, "acos")

    def atan(self) -> "Real":
        return unary(self, "atan")

    def sinh(self) -> "Real":
        return unary(self, "sinh")

    def cosh(self) -> "Real":
        return unary(self, "cosh")

    def tanh(self) -> "Real":
        return unary(self, "tanh")

    def logistic(self) -> "Real":
        return unary(self, "logistic")

    def logit(self) -> "Real":
        return unary(self, "logit")

    def lgamma(self) -> "Real":
        return unary(self, "lgamma")

    def min(self, other: RealLike) -> "Real":
        return binary(self, to_real(other), "min")

    def max(self, other: RealLike) -> "Real":
        return binary(self, to_real(other), "max")

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} #{self.id}>"

    def __hash__(self) -> int:
        return id(self)

    def __eq__(self, other) -> bool:
        return self is other


class Constant(Real):
    """A literal constant, optionally carrying an exact rational value.

    ``exact`` plays the role of the reference's ``FractionDecimal``
    (compute/Decimal.scala:3-76): integer-valued constants and the results
    of ring operations on exact constants keep an exact
    :class:`fractions.Fraction`, so e.g. ``(Real(1)/10 + Real(2)/10) * 10``
    folds to exactly 3 instead of 3.0000000000000004.  Transcendental folds
    and non-integral float literals behave like ``DoubleDecimal``
    (``exact is None``).
    """

    __slots__ = ("value", "exact")

    def __init__(self, value: float, exact: Optional[Fraction] = None):
        super().__init__()
        v = float(value)
        if math.isnan(v):
            # cf. compute/Decimal.scala:64-65 — NaN constants are
            # construction-time errors, never silent.
            raise ArithmeticError("cannot construct a NaN constant")
        self.value = v
        self.exact = exact


class Parameter(Real):
    """A scalar latent variable (compute/Real.scala:182-187).

    ``prior`` is a Real expression (in terms of this node) giving the prior
    log-density on the *unconstrained* value; set by ``parameter()``.
    """

    __slots__ = ("prior", "name")

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.prior: Optional[Real] = None
        self.name = name

    @property
    def size(self) -> int:
        return 1


class VectorParameter(Real):
    """A length-k latent vector as ONE graph leaf (TPU-native addition).

    The reference's ``latentVec(k)`` creates k separate Parameter nodes
    (core/Continuous.scala latentVec); at k=10^4 that strategy produces a
    10^4-node graph and scalar code.  Here the leaf evaluates to a (k,)
    array sliced out of the flat parameter vector, and its prior is a
    single vectorized density expression (summed by the compiler), keeping
    all math rank-1 on the VPU.
    """

    __slots__ = ("k", "prior", "name")

    def __init__(self, k: int, name: Optional[str] = None):
        super().__init__()
        self.k = int(k)
        self.prior: Optional[Real] = None
        self.name = name

    @property
    def size(self) -> int:
        return self.k


class Column(Real):
    """Per-observation data leaf (compute/Real.scala:157-178).

    Evaluates to a rank-1 array of length ``n``; densities built over
    Columns broadcast to (n,) and are reduced by ``RowSum``.
    ``matrix_ref`` optionally records that this column is a view of a
    MatColumn (set by MatColumn.column), enabling the MXU dot-product
    fast path in Vec.dot.
    """

    __slots__ = ("values", "matrix_ref")

    def __init__(self, values):
        super().__init__()
        self.values = np.asarray(values, dtype=np.float64)
        self.matrix_ref = None
        if self.values.ndim != 1:
            raise ValueError("Column data must be rank-1")

    @property
    def n_rows(self) -> int:
        return int(self.values.shape[0])

    def swap_values(self, values) -> None:
        """Re-condition on same-shape new data (Model.with_data): compiled
        programs take column values as runtime arguments, so swapping data
        reuses every cached program; only the interval-analysis cache is
        reset.  Shape must match — a different number of rows is a
        different program."""
        v = np.asarray(values, dtype=np.float64)
        if v.shape != self.values.shape:
            raise ValueError(
                f"swap_values shape {v.shape} != {self.values.shape}; "
                "same-shape data only (new shapes need a new model)")
        self.values = v
        self._bounds = None


class IntColumn(Real):
    """Integer per-observation data leaf, used as gather/lookup indices."""

    __slots__ = ("values",)

    def __init__(self, values):
        super().__init__()
        self.values = np.asarray(values, dtype=np.int32)
        if self.values.ndim != 1:
            raise ValueError("IntColumn data must be rank-1")

    @property
    def n_rows(self) -> int:
        return int(self.values.shape[0])

    def swap_values(self, values) -> None:
        """Same-shape data swap (see Column.swap_values)."""
        v = np.asarray(values, dtype=np.int32)
        if v.shape != self.values.shape:
            raise ValueError(
                f"swap_values shape {v.shape} != {self.values.shape}")
        self.values = v
        self._bounds = None


class MatColumn(Real):
    """A rank-2 (n_rows, p) data leaf — a whole design matrix as ONE node.

    TPU-native addition with no reference counterpart (the reference's Vec
    of tuples becomes p scalar Columns): keeping the matrix intact lets
    `MatVec` lower X·β to a real matmul that XLA tiles onto the MXU —
    with a vmapped chain batch it becomes (n,p)@(p,chains), the systolic
    array's native shape.  Scalar Column views are available for
    elementwise use via `column(j)`.
    """

    __slots__ = ("values", "_views")

    def __init__(self, values):
        super().__init__()
        self.values = np.asarray(values, dtype=np.float64)
        if self.values.ndim != 2:
            raise ValueError("MatColumn data must be rank-2")
        self._views: dict[int, "Column"] = {}

    @property
    def n_rows(self) -> int:
        return int(self.values.shape[0])

    @property
    def n_cols(self) -> int:
        return int(self.values.shape[1])

    def column(self, j: int) -> "Column":
        if j not in self._views:
            c = Column(self.values[:, j])
            c.matrix_ref = (self, j)
            self._views[j] = c
        return self._views[j]

    def swap_values(self, values) -> None:
        """Same-shape data swap (see Column.swap_values); scalar Column
        views stay in sync."""
        v = np.asarray(values, dtype=np.float64)
        if v.shape != self.values.shape:
            raise ValueError(
                f"swap_values shape {v.shape} != {self.values.shape}")
        self.values = v
        self._bounds = None
        for j, c in self._views.items():
            c.values = v[:, j]
            c._bounds = None


class MatVec(Real):
    """mat (n,p) @ vec (p,) → (n,): the design-matrix/latent-vector
    product, lowered to the MXU."""

    __slots__ = ("mat", "vec")

    def __init__(self, mat: MatColumn, vec: Real):
        super().__init__()
        self.mat = mat
        self.vec = vec


class Unary(Real):
    __slots__ = ("child", "op")

    def __init__(self, child: Real, op: str):
        super().__init__()
        assert op in UNARY_OPS, op
        self.child = child
        self.op = op


class Binary(Real):
    __slots__ = ("left", "right", "op")

    def __init__(self, left: Real, right: Real, op: str):
        super().__init__()
        assert op in BINARY_OPS, op
        self.left = left
        self.right = right
        self.op = op


class NArySum(Real):
    """n-ary sum — keeps wide sums flat for XLA (cf. Real.sum balanced
    reduction at compute/Real.scala:51-55)."""

    __slots__ = ("children",)

    def __init__(self, children: Sequence[Real]):
        super().__init__()
        self.children = tuple(children)


class LogSumExp(Real):
    """Numerically-stable log-sum-exp over children (Real.logSumExp at
    compute/Real.scala:57-61; used by mixtures)."""

    __slots__ = ("children",)

    def __init__(self, children: Sequence[Real]):
        super().__init__()
        self.children = tuple(children)


class Select(Real):
    """4-way comparison select: ``pred(a, b) ? if_true : if_false``.

    Lowers to jnp.where — the TPU-native form of the reference's
    Lookup-over-Compare encoding (compute/Real.scala:83-99).
    """

    __slots__ = ("pred", "left", "right", "if_true", "if_false")

    def __init__(self, pred: str, left: Real, right: Real, if_true: Real,
                 if_false: Real):
        super().__init__()
        assert pred in COMPARE_OPS, pred
        self.pred = pred
        self.left = left
        self.right = right
        self.if_true = if_true
        self.if_false = if_false


class Compare(Real):
    """5-way compare collapsed to sign(left-right) ∈ {-1,0,1}
    (compute/Real.scala:263)."""

    __slots__ = ("left", "right")

    def __init__(self, left: Real, right: Real):
        super().__init__()
        self.left = left
        self.right = right


class Lookup(Real):
    """Table lookup by a Real index (compute/Real.scala:276-315).

    Lowers to a gather over the stacked table; the reference emits a JVM
    tableswitch (ir/MethodGenerator.scala tableSwitch).
    """

    __slots__ = ("index", "table", "low")

    def __init__(self, index: Real, table: Sequence[Real], low: int = 0):
        super().__init__()
        self.index = index
        self.table = tuple(table)
        self.low = int(low)


class Gather(Real):
    """Index a vector-valued Real (VectorParameter or column-shaped value)
    by an integer column — the TPU-native path for `vec(i)` with large k
    (e.g. GLMM group effects).  No reference equivalent; the reference
    would build a k-way Lookup tableswitch."""

    __slots__ = ("source", "index")

    def __init__(self, source: Real, index: Real):
        super().__init__()
        self.source = source
        self.index = index


class RowSum(Real):
    """Reduce a per-observation density over the data axis.

    This is where `Vec(...).map(logDensity).columnize` + the implicit
    summation in Model.observe lands (core/Model.scala:74-81).  If the child
    turns out to be row-independent the sum degenerates to ``n * child``
    (the same O(1) collapse Target.inlinable achieves by partial evaluation,
    compute/Target.scala:131-207 — XLA does it for free on the broadcast
    form, but we keep the scalar shape exact).
    """

    __slots__ = ("child", "n_rows")

    def __init__(self, child: Real, n_rows: int):
        super().__init__()
        self.child = child
        self.n_rows = int(n_rows)


class VecSum(Real):
    """Total reduction of a latent-vector-shaped expression to a scalar
    (e.g. sum over a VectorParameter's k elements).  ``k`` makes the
    degenerate (value independent of the vector) case exact: sum == k*value.
    """

    __slots__ = ("child", "k")

    def __init__(self, child: Real, k: int):
        super().__init__()
        self.child = child
        self.k = int(k)


# ---------------------------------------------------------------------------
# smart constructors (compute/RealOps.scala) — constant folding only
# ---------------------------------------------------------------------------


_CONST_CACHE: dict = {}

# Exact rationals are abandoned once numerator/denominator exceed this many
# bits — unbounded Fraction growth would make graph construction O(n^2).
_EXACT_MAX_BITS = 256


def _exact_binary(op: str, a: Constant, b: Constant) -> Optional[Fraction]:
    """Exact ring arithmetic on constants (compute/DecimalOps.scala).

    Returns the exact Fraction result, or None when exactness cannot be
    maintained (missing exact operand, division by zero — which has
    limit-at-infinity float semantics, cf. ConstantOps.scala:80-113 —
    non-integer exponents, or blow-up past _EXACT_MAX_BITS).
    """
    fa, fb = a.exact, b.exact
    if fa is None or fb is None:
        return None
    if op == "add":
        r = fa + fb
    elif op == "sub":
        r = fa - fb
    elif op == "mul":
        r = fa * fb
    elif op == "div":
        if fb == 0:
            return None
        r = fa / fb
    elif op == "pow":
        if fb.denominator != 1 or abs(fb.numerator) > 64:
            return None
        if fa == 0 and fb < 0:
            return None
        r = fa ** fb.numerator
    else:  # min/max are exact picks of an operand
        if op == "min":
            return fa if fa <= fb else fb
        if op == "max":
            return fa if fa >= fb else fb
        return None
    if (abs(r.numerator).bit_length() > _EXACT_MAX_BITS
            or r.denominator.bit_length() > _EXACT_MAX_BITS):
        return None
    return r


def const(value: float, exact: Optional[Fraction] = None) -> Constant:
    v = float(value)
    if exact is None and math.isfinite(v) and v.is_integer() \
            and abs(v) < 2.0 ** 53:
        # integer-valued literals are exact by construction
        # (cf. Decimal.scala's whole-number fast path)
        exact = Fraction(int(v))
    key = (v, exact)
    cached = _CONST_CACHE.get(key)
    if cached is None:
        cached = Constant(v, exact)
        if len(_CONST_CACHE) < 4096:
            _CONST_CACHE[key] = cached
    return cached


def to_real(x: RealLike) -> Real:
    if isinstance(x, Real):
        return x
    if isinstance(x, (int, float, np.floating, np.integer)):
        return const(float(x))
    raise TypeError(f"cannot convert {type(x)} to Real")


def _lgamma_fold(v):
    from scipy.special import gammaln

    return gammaln(v)


def _fold_unary(op: str, v: float) -> float:
    with np.errstate(all="ignore"):
        fns = {
            "exp": np.exp, "log": np.log, "abs": np.abs, "sqrt": np.sqrt,
            "sin": np.sin, "cos": np.cos, "tan": np.tan, "asin": np.arcsin,
            "acos": np.arccos, "atan": np.arctan, "sinh": np.sinh,
            "cosh": np.cosh, "tanh": np.tanh, "neg": np.negative,
            "log1p": np.log1p, "expm1": np.expm1,
            "logistic": lambda x: 1.0 / (1.0 + np.exp(-x)),
            "logit": lambda x: np.log(x) - np.log1p(-x),
            "softplus": lambda x: np.logaddexp(0.0, x),
            "lgamma": _lgamma_fold,
        }
        return float(fns[op](v))


def _fold_binary(op: str, a: float, b: float) -> float:
    with np.errstate(all="ignore"):
        fns = {
            "add": np.add, "sub": np.subtract, "mul": np.multiply,
            "div": np.divide, "pow": np.power, "min": np.minimum,
            "max": np.maximum,
        }
        return float(fns[op](a, b))


def unary(x: Real, op: str) -> Real:
    if isinstance(x, Constant):
        return const(_fold_unary(op, x.value))
    # tiny peepholes mirroring RealOps.unary (log∘exp → id etc.); anything
    # deeper is left to XLA.
    if isinstance(x, Unary):
        if op == "log" and x.op == "exp":
            return x.child
        if op == "exp" and x.op == "log":
            return x.child
        if op == "neg" and x.op == "neg":
            return x.child
        # log∘logistic → −softplus(−x): same value, but finite (and with
        # finite gradient) where logistic saturates to 0/1 in f32 — the
        # GLM hot path's numerical safety valve (the reference leans on
        # f64 + Bounds guard elision instead, compute/Bounds.scala)
        if op == "log" and x.op == "logistic":
            return Unary(Unary(unary(x.child, "neg"), "softplus"), "neg")
        if op == "logit" and x.op == "logistic":
            return x.child
    return Unary(x, op)


def binary(a: Real, b: Real, op: str) -> Real:
    if isinstance(a, Constant) and isinstance(b, Constant):
        exact = _exact_binary(op, a, b)
        if exact is not None:
            return const(float(exact), exact)
        return const(_fold_binary(op, a.value, b.value))
    if op == "add":
        if isinstance(a, Constant) and a.value == 0.0:
            return b
        if isinstance(b, Constant) and b.value == 0.0:
            return a
    elif op == "sub":
        if isinstance(b, Constant) and b.value == 0.0:
            return a
        # 1 − logistic(x) → logistic(−x): the same value without the f32
        # cancellation where logistic(x) nears 1, so that its log is
        # −softplus(x) (the discrete families' log(1 − p) on a Uniform or
        # Beta latent, whose p is logistic(q))
        if isinstance(a, Constant) and a.value == 1.0 and \
                isinstance(b, Unary) and b.op == "logistic":
            return Unary(unary(b.child, "neg"), "logistic")
    elif op == "mul":
        if isinstance(a, Constant):
            if a.value == 1.0:
                return b
            if a.value == 0.0:
                return a
        if isinstance(b, Constant):
            if b.value == 1.0:
                return a
            if b.value == 0.0:
                return b
    elif op == "div":
        if isinstance(b, Constant) and b.value == 1.0:
            return a
    elif op == "pow":
        if isinstance(b, Constant):
            if b.value == 1.0:
                return a
            if b.value == 0.0:
                return const(1.0)
    return Binary(a, b, op)


def add(a: Real, b: Real) -> Real:
    return binary(a, b, "add")


def multiply(a: Real, b: Real) -> Real:
    return binary(a, b, "mul")


def sum_(xs: Sequence[RealLike]) -> Real:
    xs = [to_real(x) for x in xs]
    if not xs:
        return const(0.0)
    if len(xs) == 1:
        return xs[0]
    cval = 0.0
    cexact: Optional[Fraction] = Fraction(0)
    rest = []
    for x in xs:
        if isinstance(x, Constant):
            cval += x.value
            if cexact is not None and x.exact is not None:
                cexact = cexact + x.exact
            else:
                cexact = None
        else:
            rest.append(x)
    if cexact is not None and (
            abs(cexact.numerator).bit_length() > _EXACT_MAX_BITS
            or cexact.denominator.bit_length() > _EXACT_MAX_BITS):
        cexact = None
    if cexact is not None:
        cval = float(cexact)
    if not rest:
        return const(cval, cexact)
    if cval != 0.0:
        rest.append(const(cval, cexact))
    if len(rest) == 1:
        return rest[0]
    return NArySum(rest)


def log_sum_exp(xs: Sequence[RealLike]) -> Real:
    xs = [to_real(x) for x in xs]
    if len(xs) == 1:
        return xs[0]
    if all(isinstance(x, Constant) for x in xs):
        vals = np.asarray([x.value for x in xs])
        with np.errstate(all="ignore"):
            return const(float(np.logaddexp.reduce(vals)))
    return LogSumExp(xs)


def select(pred: str, a: RealLike, b: RealLike, if_true: RealLike,
           if_false: RealLike) -> Real:
    a, b = to_real(a), to_real(b)
    t, f = to_real(if_true), to_real(if_false)
    if isinstance(a, Constant) and isinstance(b, Constant):
        av, bv = a.value, b.value
        taken = {
            "eq": av == bv, "lt": av < bv, "gt": av > bv,
            "lte": av <= bv, "gte": av >= bv,
        }[pred]
        return t if taken else f
    if t is f:
        return t
    return Select(pred, a, b, t, f)


def eq(a, b, if_true, if_false) -> Real:
    return select("eq", a, b, if_true, if_false)


def lt(a, b, if_true, if_false) -> Real:
    return select("lt", a, b, if_true, if_false)


def gt(a, b, if_true, if_false) -> Real:
    return select("gt", a, b, if_true, if_false)


def lte(a, b, if_true, if_false) -> Real:
    return select("lte", a, b, if_true, if_false)


def gte(a, b, if_true, if_false) -> Real:
    return select("gte", a, b, if_true, if_false)


def compare(a: RealLike, b: RealLike) -> Real:
    a, b = to_real(a), to_real(b)
    if isinstance(a, Constant) and isinstance(b, Constant):
        return const(float(np.sign(a.value - b.value)))
    return Compare(a, b)


def lookup(index: RealLike, table: Sequence[RealLike], low: int = 0) -> Real:
    index = to_real(index)
    table = [to_real(t) for t in table]
    if isinstance(index, Constant):
        i = int(index.value) - low
        if 0 <= i < len(table):
            return table[i]
        raise IndexError("Lookup index out of range")
    return Lookup(index, table, low)


def parameter(density_fn: Optional[Callable[[Real], Real]] = None,
              name: Optional[str] = None) -> Parameter:
    """Create a scalar latent; cf. Real.parameter (compute/Real.scala:63-78)."""
    p = Parameter(name=name)
    if density_fn is not None:
        p.prior = to_real(density_fn(p))
    return p


def vector_parameter(k: int,
                     density_fn: Optional[Callable[[Real], Real]] = None,
                     name: Optional[str] = None) -> VectorParameter:
    """Create a length-k latent vector leaf whose prior is a single
    vectorized expression (summed over k by the compiler)."""
    p = VectorParameter(k, name=name)
    if density_fn is not None:
        p.prior = to_real(density_fn(p))
    return p


def children_of(node: Real) -> tuple[Real, ...]:
    """Structural children, used by all graph walks (iterative, no recursion
    — graphs from deep folds like ARK can exceed Python's stack)."""
    if isinstance(node, (Constant, Parameter, VectorParameter, Column,
                         IntColumn, MatColumn)):
        return ()
    if isinstance(node, MatVec):
        return (node.mat, node.vec)
    if isinstance(node, Unary):
        return (node.child,)
    if isinstance(node, Binary):
        return (node.left, node.right)
    if isinstance(node, (NArySum, LogSumExp)):
        return node.children
    if isinstance(node, Select):
        return (node.left, node.right, node.if_true, node.if_false)
    if isinstance(node, Compare):
        return (node.left, node.right)
    if isinstance(node, Lookup):
        return (node.index,) + node.table
    if isinstance(node, Gather):
        return (node.source, node.index)
    if isinstance(node, (RowSum, VecSum)):
        return (node.child,)
    raise TypeError(f"unknown node type {type(node)}")


def topological(roots: Sequence[Real], stop=()) -> list[Real]:
    """Post-order over the DAG reachable from roots (iterative); a node
    whose id is in `stop` is listed without its children."""
    seen: set[int] = set()
    order: list[Real] = []
    stack: list[tuple[Real, bool]] = [(r, False) for r in reversed(roots)]
    while stack:
        node, expanded = stack.pop()
        if expanded:
            order.append(node)
            continue
        if id(node) in seen:
            continue
        seen.add(id(node))
        stack.append((node, True))
        if node.id in stop:
            continue
        for c in reversed(children_of(node)):
            if id(c) not in seen:
                stack.append((c, False))
    return order


# -- canonical constants (compute/Real.scala object) ------------------------
zero = const(0.0)
one = const(1.0)
two = const(2.0)
neg_one = const(-1.0)
pi = const(math.pi)
infinity = const(math.inf)
neg_infinity = const(-math.inf)
