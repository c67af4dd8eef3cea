"""Interpreted evaluation oracle (port of rainier_tpu/compute/evaluator.py;
counterpart of compute/Evaluator.scala).

Slow, numpy float64: the independent implementation the consistency
tests hold the compiled densities against.  It runs the port's own
``interp.NUMPY_BACKEND``, so given the same cache it gives the JAX
package's numbers exactly.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from . import interp
from . import real as R


class Evaluator:
    """Evaluates Reals given a cache of leaf values.

    `cache` maps Real -> value; usually Parameter/VectorParameter bindings.
    """

    def __init__(self, cache: Mapping[R.Real, object] | None = None):
        self._env = {}
        if cache:
            for k, v in cache.items():
                self._env[k.id] = np.asarray(v, dtype=np.float64)
        self._memo: dict[int, object] = {}

    def value(self, x):
        x = R.to_real(x)
        if x.id in self._env:
            return self._env[x.id]
        if x.id not in self._memo:
            vals = interp.evaluate([x], self._env, interp.NUMPY_BACKEND,
                                   np.float64)
            self._memo[x.id] = vals[0]
        return self._memo[x.id]

    def to_double(self, x) -> float:
        return float(self.value(x))

    def to_long(self, x) -> int:
        return int(round(self.to_double(x)))

    def to_int(self, x) -> int:
        return int(round(self.to_double(x)))
