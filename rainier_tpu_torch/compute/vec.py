"""Vectorized views over the graph — counterpart of compute/Vec.scala.

A copy of ``rainier_tpu/compute/vec.py``.  A column-mode Vec holds one
element graph over Column leaves which evaluates directly to a rank-1
tensor; list mode keeps a small tuple of heterogeneous element graphs;
latent mode is backed by a single :class:`VectorParameter` leaf.
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

import numpy as np

from . import real as R


def _is_number_seq(xs) -> bool:
    return all(isinstance(x, (int, float, np.floating, np.integer))
               for x in xs)


def _common_matrix(elems):
    """The MatColumn whose ordered column views `elems` are, or None."""
    if not elems or not all(
            isinstance(e, R.Column) and e.matrix_ref is not None
            for e in elems):
        return None
    mat = elems[0].matrix_ref[0]
    if any(e.matrix_ref[0] is not mat for e in elems):
        return None
    if [e.matrix_ref[1] for e in elems] != list(range(mat.n_cols)):
        return None
    return mat


def _latent_axis_expr(vec: "Vec"):
    """The single (k,)-shaped latent-axis expression backing `vec`, or
    None.  Latent-axis = contains a VectorParameter and no data leaves
    (so its axis is the parameter axis, not the observation axis)."""
    if vec._vparam is not None:
        return vec._vparam
    e = vec._element
    if e is None or isinstance(e, (tuple, dict)) or not isinstance(e, R.Real):
        return None
    has_vp = False
    for node in R.topological([e]):
        if isinstance(node, (R.Column, R.IntColumn, R.MatColumn)):
            return None
        if isinstance(node, R.VectorParameter):
            has_vp = True
    return e if has_vp else None


def _try_matvec(a: "Vec", b: "Vec"):
    """a = tuple-of-matrix-view-columns (or list of them), b = latent-axis
    vector of matching width → MatVec(mat, b)."""
    elems = None
    if a._element is not None and isinstance(a._element, tuple):
        elems = list(a._element)
    elif a._elements is not None:
        elems = list(a._elements)
    if elems is None:
        return None
    mat = _common_matrix(elems)
    if mat is None or b.size != len(elems):
        return None
    vexpr = _latent_axis_expr(b)
    if vexpr is None:
        return None
    return R.MatVec(mat, vexpr)


class Vec:
    """Immutable vector-of-T view (T: Real, tuple of Reals, dict of Reals,
    or Distribution)."""

    def __init__(self, *, elements=None, element=None, n=None, vparam=None):
        self._elements = list(elements) if elements is not None else None
        self._element = element
        self._n = n
        self._vparam = vparam
        if vparam is not None:
            self._n = vparam.k

    # -- constructors -----------------------------------------------------
    @staticmethod
    def from_(data: Sequence) -> "Vec":
        """Build a Vec from data (ToVec typeclass analogue,
        compute/Vec.scala:97-175) or from a list of Reals."""
        data = list(data)
        if not data:
            raise ValueError("empty Vec")
        first = data[0]
        if isinstance(first, R.Real):
            return Vec(elements=data, n=len(data))
        if isinstance(first, (int, float, np.floating, np.integer)):
            if all(isinstance(x, (int, np.integer)) for x in data):
                col = R.Column(np.asarray(data, dtype=np.float64))
                return Vec(element=col, n=len(data))
            return Vec(element=R.Column(data), n=len(data))
        if isinstance(first, (tuple, list)):
            # rows become one MatColumn; per-field Columns are views with a
            # backpointer so dot() can rebuild the MXU matmul form
            mat = R.MatColumn(np.asarray(data, dtype=np.float64))
            cols = tuple(mat.column(j) for j in range(len(first)))
            return Vec(element=cols, n=len(data))
        if isinstance(first, dict):
            keys = list(first.keys())
            elem = {
                k: R.Column(np.asarray([row[k] for row in data],
                                       dtype=np.float64))
                for k in keys
            }
            return Vec(element=elem, n=len(data))
        raise TypeError(f"cannot vectorize {type(first)}")

    @staticmethod
    def from_ints(data: Sequence[int]) -> "Vec":
        """Integer data intended for use as indices (gathers)."""
        return Vec(element=R.IntColumn(np.asarray(data, dtype=np.int32)),
                   n=len(data))

    @staticmethod
    def of(*xs) -> "Vec":
        return Vec(elements=[R.to_real(x) for x in xs], n=len(xs))

    @staticmethod
    def latent(vparam: R.VectorParameter) -> "Vec":
        return Vec(vparam=vparam)

    # -- properties -------------------------------------------------------
    @property
    def size(self) -> int:
        return self._n

    def __len__(self) -> int:
        return self._n

    @property
    def is_column(self) -> bool:
        return self._element is not None

    @property
    def is_latent(self) -> bool:
        return self._vparam is not None

    @property
    def vparam(self):
        return self._vparam

    @property
    def element(self):
        """Column-mode element graph (the columnized computation)."""
        if self._element is not None:
            return self._element
        if self._vparam is not None:
            return self._vparam
        raise ValueError("list-mode Vec has per-index elements; use to_list()")

    # -- transforms -------------------------------------------------------
    def map(self, fn: Callable) -> "Vec":
        if self._element is not None:
            e = self._element
            arg = e if not isinstance(e, tuple) else e
            return Vec(element=fn(arg), n=self._n)
        if self._vparam is not None:
            return Vec(element=fn(self._vparam), n=self._n)
        return Vec(elements=[fn(e) for e in self._elements], n=self._n)

    def zip(self, other: "Vec") -> "Vec":
        if self._n != other._n:
            raise ValueError("zip of unequal Vec lengths")
        if (self._element is not None or self._vparam is not None) and \
           (other._element is not None or other._vparam is not None):
            a = self._element if self._element is not None else self._vparam
            b = other._element if other._element is not None else other._vparam
            at = a if isinstance(a, tuple) else (a,)
            bt = b if isinstance(b, tuple) else (b,)
            elem = at + bt if len(at) + len(bt) > 2 else (at[0], bt[0])
            return Vec(element=elem, n=self._n)
        return Vec(elements=list(zip(self.to_list(), other.to_list())),
                   n=self._n)

    def dot(self, other: "Vec") -> R.Real:
        """Inner product over the vector axis (compute/Vec.scala dot)."""
        if self._n != other._n:
            raise ValueError("dot of unequal Vec lengths")
        # design-matrix · latent-vector → one MatVec node (MXU matmul)
        mv = _try_matvec(self, other) or _try_matvec(other, self)
        if mv is not None:
            return mv
        a, b = self, other
        if b.is_column and not a.is_column:
            a, b = b, a
        if a.is_column and isinstance(a._element, tuple):
            terms = [a._element[j] * b[j] for j in range(len(a._element))]
            return R.sum_(terms)
        if a.is_column and not isinstance(a._element, tuple):
            if b.is_column:
                return R.RowSum(a._element * b._element, self._n)
            if b.is_latent:
                return R.VecSum(a._element * b._vparam, self._n)
        if a.is_latent and b.is_latent:
            return R.VecSum(a._vparam * b._vparam, self._n)
        if a.is_latent:
            return R.sum_([a[i] * x for i, x in enumerate(b.to_list())])
        return R.sum_([x * y for x, y in zip(self.to_list(), other.to_list())])

    def sum(self) -> R.Real:
        if self.is_latent:
            return R.VecSum(self._vparam, self._n)
        if self.is_column:
            if isinstance(self._element, tuple):
                raise TypeError("sum of tuple-element Vec")
            return R.RowSum(self._element, self._n)
        return R.sum_(self.to_list())

    def __getitem__(self, i: Union[int, R.Real]):
        if isinstance(i, R.Real):
            if self.is_latent:
                return R.Gather(self._vparam, i)
            if self.is_column:
                return R.Gather(self._element, i)
            return R.lookup(i, self._elements)
        i = int(i)
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        if self.is_latent:
            return R.Gather(self._vparam, R.const(i))
        if self.is_column:
            e = self._element
            if isinstance(e, tuple):
                return tuple(R.Gather(c, R.const(i)) for c in e)
            return R.Gather(e, R.const(i))
        return self._elements[i]

    def to_list(self) -> list:
        if self._elements is not None:
            return list(self._elements)
        return [self[i] for i in range(self._n)]

    def columnize(self):
        """Column-mode element (no-op here: column Vecs are born columnized;
        cf. Vec.columnize compute/Vec.scala:37-38)."""
        return self.element

    # list-like helpers (compute/Vec.scala take/drop/slice/reverse)
    def take(self, k: int) -> "Vec":
        return Vec(elements=self.to_list()[:k], n=min(k, self._n))

    def drop(self, k: int) -> "Vec":
        rest = self.to_list()[k:]
        return Vec(elements=rest, n=len(rest))

    def slice(self, a: int, b: int) -> "Vec":
        part = self.to_list()[a:b]
        return Vec(elements=part, n=len(part))

    def reverse(self) -> "Vec":
        rev = list(reversed(self.to_list()))
        return Vec(elements=rev, n=len(rev))
