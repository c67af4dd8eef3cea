"""Continuous distribution families (counterpart of core/Continuous.scala).

Port of ``rainier_tpu/core/continuous.py`` without ``generator()``
(generators come in a later slice).  Latent creation follows
core/Continuous.scala:27-34 exactly: a latent is an unconstrained
Parameter leaf whose prior density is
``support.log_jacobian(x) + log_density(support.transform(x))``, and the
returned value is the transformed parameter.  ``latent_vec(k)`` allocates
one VectorParameter leaf whose prior is a single vectorized expression.
"""

from __future__ import annotations

import math

from ..compute import bounds
from ..compute import real as R
from ..compute.vec import Vec
from . import combinatorics
from .distribution import Distribution
from .injection import Exp, Scale, Translate
from .support import (BoundedBelowSupport, BoundedSupport, Support,
                      UnboundedSupport)

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


class Continuous(Distribution):
    support: Support

    def latent(self) -> R.Real:
        x = R.parameter(lambda p: self.support.log_jacobian(p) +
                        self.log_density_at(self.support.transform(p)))
        return self.support.transform(x)

    def latent_vec(self, k: int) -> Vec:
        vp = R.vector_parameter(
            k, lambda p: self.support.log_jacobian(p) +
            self.log_density_at(self.support.transform(p)))
        return Vec(element=self.support.transform(vp), n=k)

    def scale(self, a) -> "Continuous":
        return Scale(a).transform(self)

    def translate(self, b) -> "Continuous":
        return Translate(b).transform(self)

    def exp(self) -> "Continuous":
        return Exp.transform(self)


class _LocationScaleFamily:
    """LocationScaleFamily (core/Continuous.scala:39-57): a standard member
    plus scale∘translate construction."""

    def _std_log_density(self, x: R.Real) -> R.Real:
        raise NotImplementedError

    @property
    def standard(self) -> Continuous:
        fam = self

        class Std(Continuous):
            support = UnboundedSupport()

            def log_density_at(self, x):
                return fam._std_log_density(R.to_real(x))

        return Std()

    def __call__(self, location, scale) -> Continuous:
        scale = R.to_real(scale)
        bounds.check(scale, "σ >= 0", lambda v: v >= 0.0)
        return self.standard.scale(scale).translate(location)


class _Normal(_LocationScaleFamily):
    def _std_log_density(self, x):
        return (x * x) / -2.0 - _HALF_LOG_2PI


class _Cauchy(_LocationScaleFamily):
    def _std_log_density(self, x):
        return -((x * x + 1) * math.pi).log()


class _Laplace(_LocationScaleFamily):
    def _std_log_density(self, x):
        return math.log(0.5) - x.abs()


Normal = _Normal()
Cauchy = _Cauchy()
Laplace = _Laplace()


class _GammaStandard(Continuous):
    """Gamma(shape, scale=1) (core/Continuous.scala:94-147)."""

    def __init__(self, shape):
        self.shape = R.to_real(shape)
        bounds.check(self.shape, "k > 0", lambda v: v >= 0.0)
        self.support = BoundedBelowSupport(R.zero)

    def log_density_at(self, x):
        x = R.to_real(x)
        return bounds.guard_positive(
            x, (self.shape - 1) * x.log() - combinatorics.gamma(self.shape)
            - x)


class _Gamma:
    def __call__(self, shape, scale) -> Continuous:
        scale = R.to_real(scale)
        bounds.check(scale, "θ > 0", lambda v: v >= 0.0)
        return self.standard(shape).scale(scale)

    def standard(self, shape) -> Continuous:
        return _GammaStandard(shape)

    def mean_and_scale(self, mean, scale) -> Continuous:
        mean, scale = R.to_real(mean), R.to_real(scale)
        return self(mean / scale, scale)


Gamma = _Gamma()


class _Exponential:
    @property
    def standard(self) -> Continuous:
        return Gamma.standard(1.0)

    def __call__(self, rate) -> Continuous:
        rate = R.to_real(rate)
        bounds.check(rate, "λ >= 0", lambda v: v >= 0.0)
        return self.standard.scale(R.one / rate)


Exponential = _Exponential()


class Beta(Continuous):
    """Beta(a, b) (core/Continuous.scala:163-189)."""

    def __init__(self, a, b):
        self.a = R.to_real(a)
        self.b = R.to_real(b)
        bounds.check(self.a, "α >= 0", lambda v: v >= 0.0)
        bounds.check(self.b, "β >= 0", lambda v: v >= 0.0)
        self.support = BoundedSupport(R.zero, R.one)

    def log_density_at(self, x):
        x = R.to_real(x)
        return bounds.guard_zero_to_one(
            x, (self.a - 1) * x.log() + (self.b - 1) * (1 - x).log()
            - combinatorics.beta(self.a, self.b))

    @staticmethod
    def mean_and_precision(mean, precision) -> "Beta":
        mean, precision = R.to_real(mean), R.to_real(precision)
        return Beta(mean * precision, (R.one - mean) * precision)

    @staticmethod
    def mean_and_variance(mean, variance) -> "Beta":
        mean, variance = R.to_real(mean), R.to_real(variance)
        return Beta.mean_and_precision(
            mean, mean * (R.one - mean) / variance - 1)


class _LogNormal:
    def __call__(self, location, scale) -> Continuous:
        return Normal(location, scale).exp()


LogNormal = _LogNormal()


class _UniformStandard(Continuous):
    support = BoundedSupport(R.zero, R.one)

    def log_density_at(self, x):
        return Beta(1, 1).log_density_at(x)


class _Uniform:
    @property
    def standard(self) -> Continuous:
        return _UniformStandard()

    def __call__(self, from_, to) -> Continuous:
        from_, to = R.to_real(from_), R.to_real(to)
        return self.standard.scale(to - from_).translate(from_)


Uniform = _Uniform()


class Mixture(Continuous):
    """Continuous mixture via logSumExp (core/Continuous.scala:218-248)."""

    def __init__(self, components: dict):
        self.components = {d: R.to_real(w) for d, w in components.items()}
        for w in self.components.values():
            bounds.check(w, "0 <= p <= 1", lambda v: 0.0 <= v <= 1.0)
        self.support = Support.union_all(
            [d.support for d in self.components])

    def log_density_at(self, x):
        x = R.to_real(x)
        return R.log_sum_exp([
            d.log_density_at(x) + w.log()
            for d, w in self.components.items()
        ])
