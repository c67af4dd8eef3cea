"""Model: observe → condition → sample (port of rainier_tpu/core/model.py,
counterpart of core/Model.scala:7-133).

All chains run simultaneously as a batch dimension of the sampler's
tensors.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

from ..compute import real as R
from ..compute.compiler import CompiledDensity
from ..compute.vec import Vec
from .distribution import Distribution


class Model:
    def __init__(self, likelihoods: Sequence[R.Real], track: Iterable[R.Real]
                 = ()):
        self.likelihoods = [R.to_real(l) for l in likelihoods]
        self.track = set(track)
        self._density: Optional[CompiledDensity] = None

    # -- construction -----------------------------------------------------
    @staticmethod
    def empty() -> "Model":
        return Model.likelihood(R.zero)

    @staticmethod
    def likelihood(real: R.Real) -> "Model":
        return Model([real], set())

    @staticmethod
    def likelihoods(reals: Sequence[R.Real]) -> "Model":
        return Model(list(reals), set())

    @staticmethod
    def track_(reals: Iterable[R.Real]) -> "Model":
        return Model([R.zero], set(reals))

    @staticmethod
    def observe(ys, lh) -> "Model":
        """Condition on data.

        * ``observe(ys, dist)`` — one distribution for all observations.
        * ``observe(ys, vec)`` — a Vec of distributions (row-varying
          parameters), the `Model.observe(ys, Vec[D])` overload
          (core/Model.scala:88-100).
        """
        if isinstance(lh, Distribution):
            return Model.likelihood(lh.log_density(ys))
        if isinstance(lh, Vec):
            if lh.is_column:
                dist = lh.element
                if not isinstance(dist, Distribution):
                    raise TypeError("Vec passed to observe must contain "
                                    "distributions")
                ys_arr = np.asarray(ys, dtype=np.float64)
                if ys_arr.shape[0] != lh.size:
                    raise ValueError("observations and Vec length differ")
                col = R.Column(ys_arr)
                return Model.likelihood(
                    R.RowSum(dist.log_density_at(col), lh.size))
            dists = lh.to_list()
            ys_list = list(ys)
            if len(dists) != len(ys_list):
                raise ValueError("observations and Vec length differ")
            return Model.likelihood(
                R.sum_([d.log_density_at(R.to_real(y))
                        for d, y in zip(dists, ys_list)]))
        raise TypeError(f"cannot observe under {type(lh)}")

    def with_data(self, mapping) -> "Model":
        """Re-condition this model on same-shape new data.

        `mapping`: {Column|IntColumn|MatColumn: new values}.  The compiled
        density and every cached sampler program are reused — column
        values are runtime arguments of those programs, never baked in —
        so repeated fits over fresh datasets (SBC repetitions,
        cross-validation folds) cost zero recompilation.  Shapes must
        match; a different number of rows is a different program (build a
        new model for that).  Returns self for chaining."""
        for col, values in mapping.items():
            if not isinstance(col, (R.Column, R.IntColumn, R.MatColumn)):
                raise TypeError(f"with_data keys must be data columns, "
                                f"got {type(col)}")
            col.swap_values(values)
        return self

    def merge(self, other: "Model") -> "Model":
        return Model(self.likelihoods + other.likelihoods,
                     self.track | other.track)

    def prior(self) -> "Model":
        """The model's prior (drops conditioning; core/Model.scala:9)."""
        return Model.track_(self.track | set(self.likelihoods))

    # -- compilation ------------------------------------------------------
    def density(self) -> CompiledDensity:
        if self._density is None:
            self._density = CompiledDensity(self.likelihoods,
                                            extra_roots=list(self.track))
        return self._density

    @property
    def parameters(self) -> list[R.Real]:
        return self.density().parameters

    @property
    def n_vars(self) -> int:
        return self.density().n_vars

    # -- inference --------------------------------------------------------
    def sample(self, config=None, n_chains: int = 4, seed: int = 0,
               **kwargs):
        """Run HMC-family inference; returns a Trace (see
        sampler/driver.py for ``kernel=`` and ``device=``)."""
        from ..sampler import SamplerConfig, sample as run_sample

        config = config or SamplerConfig()
        return run_sample(self, config, n_chains=n_chains, seed=seed,
                          **kwargs)

    @staticmethod
    def sample_prior(t, n: int = 1000, seed: int = 0, config=None,
                     **kwargs):
        """Exploratory prior sampling: draw from the prior of every latent
        reachable from `t` and evaluate `t` at each draw (the reference's
        `Model.sample(t)` convenience, core/Model.scala:52-60 — there, as
        here, it runs the default sampler on the prior-only model;
        rainier_tpu/core/model.py:138-155).  `kwargs` go to
        :meth:`sample` (``device=``, ``kernel=``).

        `t` is a Real or a list/tuple of Reals; returns an (n, ...) array
        (or a list of them, matching `t`'s structure)."""
        from ..sampler import SamplerConfig

        single = isinstance(t, R.Real)
        exprs = [t] if single else list(t)
        model = Model.track_(exprs)
        cfg = config or SamplerConfig(500, max(n // 4, 1))
        trace = model.sample(cfg, n_chains=4, seed=seed, **kwargs)
        vals = trace.evaluate(exprs)
        return vals[0] if single else vals

    def smc(self, config=None, seed: int = 0, **kwargs):
        """Tempered SMC with systematic resampling — returns
        (Trace, SMCResult); SMCResult.log_evidence estimates the model
        evidence (sampler/smc.py; `kwargs`: ``device=``, ``dtype=``)."""
        from ..sampler.smc import smc as run

        return run(self, config, seed=seed, **kwargs)

    def optimize(self, t=None, seed: int = 0, **kwargs):
        """MAP via L-BFGS (core/Model.scala:26-30); returns the optimum of
        `t` (a Real / structure of Reals / Generator) at the MAP point, or
        the flat parameter vector when t is None (optimizer/lbfgs.py;
        `kwargs`: ``n_starts=``, ``max_iters=``, ``device=``)."""
        from ..optimizer import lbfgs_map

        return lbfgs_map(self, t, seed=seed, **kwargs)
