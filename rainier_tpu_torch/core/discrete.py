"""Discrete distribution families (port of rainier_tpu/core/discrete.py,
counterpart of core/Discrete.scala).

This slice ports ``Bernoulli``, the likelihood of the logistic
regression, and ``Poisson``, the likelihood of the GLMMs; the other
families and every ``generator()`` come in a later slice.
"""

from __future__ import annotations

from ..compute import bounds
from ..compute import real as R
from . import combinatorics
from .distribution import Distribution


class Discrete(Distribution):
    pass


class Bernoulli(Discrete):
    def __init__(self, p):
        self.p = R.to_real(p)
        bounds.check(self.p, "0 <= p <= 1", lambda v: 0.0 <= v <= 1.0)

    def log_density_at(self, v):
        # Bernoulli(logistic(x)) lowers to the logit parameterization:
        # logP(1) = -softplus(-x), logP(0) = -softplus(x), finite where
        # log(p) and log(1-p) overflow in f32
        if isinstance(self.p, R.Unary) and self.p.op == "logistic":
            x = self.p.child
            return R.eq(R.to_real(v), R.zero,
                        R.to_real(x).softplus() * -1,
                        R.to_real(x * -1).softplus() * -1)
        return R.eq(R.to_real(v), R.zero, (1 - self.p).log(), self.p.log())


class Poisson(Discrete):
    def __init__(self, lam):
        self.lam = R.to_real(lam)
        bounds.check(self.lam, "λ >= 0", lambda v: v >= 0.0)

    def log_density_at(self, v):
        v = R.to_real(v)
        return self.lam.log() * v - self.lam - combinatorics.factorial(v)
