"""Distribution base types (counterpart of core/Distribution.scala:5-8).

`log_density_at(x: Real) -> Real` is the per-element density graph;
`log_density(ys) -> Real` vectorizes it over an observation sequence by
routing the data through a Column leaf and reducing with RowSum — the
reference's `Vec.from(seq).map(logDensity).columnize` pipeline
(core/Continuous.scala:13), without the intermediate machinery.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..compute import real as R
from ..compute.vec import Vec


class Distribution:
    def log_density_at(self, x: R.Real) -> R.Real:
        raise NotImplementedError

    def log_density(self, ys) -> R.Real:
        """Summed log-density of observed data (a Real graph)."""
        if isinstance(ys, R.Real):
            return self.log_density_at(ys)
        if isinstance(ys, Vec):
            if ys.is_column:
                return R.RowSum(self.log_density_at(ys.element), ys.size)
            return R.sum_([self.log_density_at(e) for e in ys.to_list()])
        if isinstance(ys, (int, float, np.floating, np.integer)):
            return self.log_density_at(R.to_real(ys))
        ys = np.asarray(ys, dtype=np.float64)
        if ys.ndim == 0:
            return self.log_density_at(R.const(float(ys)))
        col = R.Column(ys)
        return R.RowSum(self.log_density_at(col), int(ys.shape[0]))
