"""Discrete distribution families (port of rainier_tpu/core/discrete.py,
counterpart of core/Discrete.scala).

Densities mirror the JAX package's formulas, with the same eq-guards for
the 0·log(0) corners.  Generators draw all of a batch's values at once
with torch's samplers on the env's device (see :mod:`.generator`): the
gamma–Poisson mixture for the negative binomial, ``torch.binomial`` and
``torch.poisson``, where the JAX package uses ``jax.random``'s.  Draws
are int32, as the JAX package's are.
"""

from __future__ import annotations

import torch

from ..compute import bounds
from ..compute import real as R
from . import combinatorics
from .distribution import Distribution
from .generator import Generator


def _gamma(gen, shape_param):
    """Standard gamma draws with the given (contiguous) shape
    parameters."""
    return torch._standard_gamma(shape_param, generator=gen)


class Discrete(Distribution):
    def zero_inflated(self, psi) -> "DiscreteMixture":
        return self.constant_inflated(0.0, psi)

    def constant_inflated(self, constant, psi) -> "DiscreteMixture":
        psi = R.to_real(psi)
        return DiscreteMixture({
            DiscreteConstant(constant): psi,
            self: R.one - psi
        })


class DiscreteConstant(Discrete):
    """Point mass (core/Discrete.scala:22-33)."""

    def __init__(self, constant):
        self.constant = R.to_real(constant)

    def log_density_at(self, v):
        return R.eq(R.to_real(v), self.constant, R.zero, R.neg_infinity)

    def generator(self):
        c = self.constant
        return Generator(
            lambda gen, env: torch.round(env.full(c, env.shape(c))).to(
                torch.int32),
            frozenset([c]))


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

    def generator(self):
        p = self.p

        def fn(gen, env):
            shape = env.shape(p)
            u = torch.rand(shape, generator=gen, dtype=env.dtype,
                           device=env.device)
            return (u < env(p)).to(torch.int32)

        return Generator(fn, frozenset([p]))


class Geometric(Discrete):
    """Failures before first success, support {0,1,...}
    (core/Discrete.scala:56-74)."""

    def __init__(self, p):
        self.p = R.to_real(p)
        bounds.check(self.p, "0 <= p <= 1", lambda v: 0.0 <= v <= 1.0)

    def log_density_at(self, v):
        v = R.to_real(v)
        return self.p.log() + v * (1 - self.p).log()

    def generator(self):
        p = self.p

        def fn(gen, env):
            shape = env.shape(p)
            # u in (0, 1]: log u finite
            u = 1.0 - torch.rand(shape, generator=gen, dtype=env.dtype,
                                 device=env.device)
            return torch.floor(torch.log(u) / torch.log1p(-env(p))).to(
                torch.int32)

        return Generator(fn, frozenset([p]))


class NegativeBinomial(Discrete):
    """NB(p, n): number of successes before the n-th failure
    (core/Discrete.scala:82-118)."""

    def __init__(self, p, n):
        self.p = R.to_real(p)
        self.n = R.to_real(n)
        bounds.check(self.p, "0 <= p <= 1", lambda v: 0.0 <= v <= 1.0)
        bounds.check(self.n, "n >= 0", lambda v: v >= 0.0)

    def log_density_at(self, v):
        v = R.to_real(v)
        return (combinatorics.factorial(self.n + v - 1)
                - combinatorics.factorial(v)
                - combinatorics.factorial(self.n - 1)
                + self.n * (1 - self.p).log() + v * self.p.log())

    def generator(self):
        p, n = self.p, self.n

        def fn(gen, env):
            # gamma–Poisson mixture: λ ~ Gamma(n, p/(1−p)); v ~ Poisson(λ)
            shape = env.shape(p, n)
            pv = env(p)
            lam = _gamma(gen, env.full(n, shape)) * pv / (1.0 - pv)
            return torch.poisson(lam, generator=gen).to(torch.int32)

        return Generator(fn, frozenset([p, n]))


class Poisson(Discrete):
    def __init__(self, lam):
        self.lam = R.to_real(lam)
        bounds.check(self.lam, "λ >= 0", lambda v: v >= 0.0)

    def log_density_at(self, v):
        v = R.to_real(v)
        return self.lam.log() * v - self.lam - combinatorics.factorial(v)

    def generator(self):
        lam = self.lam
        return Generator(
            lambda gen, env: torch.poisson(
                env.full(lam, env.shape(lam)), generator=gen).to(
                    torch.int32),
            frozenset([lam]))


def _binomial(gen, k, p, shape):
    """Binomial(k, p) draws of `shape` (k, p tensors that broadcast)."""
    return torch.binomial(k.expand(shape).contiguous(),
                          p.expand(shape).contiguous(), generator=gen).to(
                              torch.int32)


class Binomial(Discrete):
    """Binomial(p, k) (core/Discrete.scala:190-234; the closed form with
    eq-guards for the 0·log(0) corners, as the JAX package has it)."""

    def __init__(self, p, k):
        self.p = R.to_real(p)
        self.k = R.to_real(k)
        bounds.check(self.p, "0 <= p <= 1", lambda v: 0.0 <= v <= 1.0)
        bounds.check(self.k, "k >= 0", lambda v: v >= 0.0)

    def log_density_at(self, v):
        v = R.to_real(v)
        p, k = self.p, self.k
        succ = R.eq(v, R.zero, R.zero, v * p.log())
        fail = R.eq(k - v, R.zero, R.zero, (k - v) * (1 - p).log())
        return combinatorics.choose(k, v) + succ + fail

    def generator(self):
        p, k = self.p, self.k
        return Generator(
            lambda gen, env: _binomial(gen, env(k), env(p), env.shape(p, k)),
            frozenset([p, k]))


class BetaBinomial(Discrete):
    def __init__(self, a, b, k):
        self.a = R.to_real(a)
        self.b = R.to_real(b)
        self.k = R.to_real(k)

    def log_density_at(self, v):
        v = R.to_real(v)
        return (combinatorics.choose(self.k, v)
                + combinatorics.beta(self.a + v, self.k - v + self.b)
                - combinatorics.beta(self.a, self.b))

    def generator(self):
        a, b, k = self.a, self.b, self.k

        def fn(gen, env):
            shape = env.shape(a, b, k)
            x = _gamma(gen, env.full(a, shape))
            p = x / (x + _gamma(gen, env.full(b, shape)))
            return _binomial(gen, env(k), p, shape)

        return Generator(fn, frozenset([a, b, k]))

    @staticmethod
    def mean_and_precision(mean, precision, k) -> "BetaBinomial":
        mean, precision = R.to_real(mean), R.to_real(precision)
        return BetaBinomial(mean * precision,
                            (R.one - mean) * precision, k)


class DiscreteMixture(Discrete):
    def __init__(self, components: dict):
        self.components = {d: R.to_real(w) for d, w in components.items()}
        for w in self.components.values():
            bounds.check(w, "0 <= p <= 1", lambda v: 0.0 <= v <= 1.0)

    def log_density_at(self, v):
        v = R.to_real(v)
        return R.log_sum_exp([
            d.log_density_at(v) + w.log()
            for d, w in self.components.items()
        ])

    def generator(self):
        return Generator.categorical(self.components)
