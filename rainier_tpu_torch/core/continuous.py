"""Continuous distribution families (counterpart of core/Continuous.scala).

Port of ``rainier_tpu/core/continuous.py``.  Latent creation follows
core/Continuous.scala:27-34 exactly: a latent is an unconstrained
Parameter leaf whose prior density is
``support.log_jacobian(x) + log_density(support.transform(x))``, and the
returned value is the transformed parameter.  ``latent_vec(k)`` allocates
one VectorParameter leaf whose prior is a single vectorized expression.

Generators draw a batch at once with torch's samplers (see
:mod:`.generator`): a standard member draws, and the location-scale
transforms move it (``Injection.fast_forwards``).
"""

from __future__ import annotations

import math

import torch

from ..compute import bounds
from ..compute import real as R
from ..compute.vec import Vec
from . import combinatorics
from .distribution import Distribution
from .generator import Generator
from .injection import Exp, Scale, Translate
from .support import (BoundedBelowSupport, BoundedSupport, Support,
                      UnboundedSupport)

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def _uniform(gen, env, shape=None):
    """Uniform draws in (0, 1) of `shape` (default: the env's batch)."""
    u = torch.rand(shape or env.batch, generator=gen, dtype=env.dtype,
                   device=env.device)
    return u.clamp_(min=torch.finfo(env.dtype).tiny)


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

    def _std_generate(self, gen, env):
        """Standard draws of the env's batch shape."""
        raise NotImplementedError

    @property
    def standard(self) -> Continuous:
        fam = self

        class Std(Continuous):
            support = UnboundedSupport()

            def log_density_at(self, x):
                return fam._std_log_density(R.to_real(x))

            def generator(self):
                return Generator(fam._std_generate)

        return Std()

    def __call__(self, location, scale) -> Continuous:
        scale = R.to_real(scale)
        bounds.check(scale, "σ >= 0", lambda v: v >= 0.0)
        return self.standard.scale(scale).translate(location)


class _Normal(_LocationScaleFamily):
    def _std_log_density(self, x):
        return (x * x) / -2.0 - _HALF_LOG_2PI

    def _std_generate(self, gen, env):
        return torch.randn(env.batch, generator=gen, dtype=env.dtype,
                           device=env.device)


class _Cauchy(_LocationScaleFamily):
    def _std_log_density(self, x):
        return -((x * x + 1) * math.pi).log()

    def _std_generate(self, gen, env):
        return torch.tan(math.pi * (_uniform(gen, env) - 0.5))


class _Laplace(_LocationScaleFamily):
    def _std_log_density(self, x):
        return math.log(0.5) - x.abs()

    def _std_generate(self, gen, env):
        # inverse CDF: a random sign times an Exponential(1)
        u = _uniform(gen, env) - 0.5
        return -torch.sign(u) * torch.log1p(-2.0 * u.abs())


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

    def generator(self):
        shape = self.shape
        return Generator(
            lambda gen, env: torch._standard_gamma(
                env.full(shape, env.shape(shape)), generator=gen),
            frozenset([shape]))


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

    def generator(self):
        a, b = self.a, self.b

        def fn(gen, env):
            shape = env.shape(a, b)
            x = torch._standard_gamma(env.full(a, shape), generator=gen)
            y = torch._standard_gamma(env.full(b, shape), generator=gen)
            return x / (x + y)

        return Generator(fn, frozenset([a, b]))

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

    def generator(self):
        return Generator(_uniform)


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

    def generator(self):
        # categorical over distribution-valued keys draws every component
        # and selects per draw
        return Generator.categorical(self.components)
