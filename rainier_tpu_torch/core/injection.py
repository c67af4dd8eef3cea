"""Injective push-forward transforms (counterpart of core/Injection.scala).

Port of ``rainier_tpu/core/injection.py``.

`Scale`, `Translate`, `Exp` transform a Continuous coherently across its
density (with log-Jacobian correction), support, generator and latent —
the mechanism by which the location-scale families and LogNormal are built
(e.g. Normal(μ,σ) = standard.scale(σ).translate(μ),
core/Continuous.scala:52-57).
"""

from __future__ import annotations

import torch

from ..compute import bounds
from ..compute import real as R
from ..compute.vec import Vec
from .generator import Generator
from .support import (BoundedAboveSupport, BoundedBelowSupport,
                      BoundedSupport, Support, UnboundedSupport)


class Injection:
    #: the Reals the transform reads (its draws broadcast over them)
    parameters: tuple = ()

    def forwards(self, x: R.Real) -> R.Real:
        raise NotImplementedError

    def backwards(self, y: R.Real) -> R.Real:
        raise NotImplementedError

    def log_jacobian(self, y: R.Real) -> R.Real:
        """log d/dy backwards(y) (see change-of-variables note in
        core/Injection.scala:20-24)."""
        raise NotImplementedError

    def when_defined_at(self, y: R.Real, if_defined: R.Real,
                        not_defined: R.Real) -> R.Real:
        return if_defined

    def fast_forwards(self, x, env):
        """Numeric forwards for the generator path: x, a batch of draws,
        moved by the transform's values in `env`."""
        raise NotImplementedError

    def transform_support(self, supp: Support) -> Support:
        raise NotImplementedError

    def transform(self, dist):
        from .continuous import Continuous

        inj = self

        class Transformed(Continuous):
            def __init__(self):
                self.support = inj.transform_support(dist.support)

            def log_density_at(self, y):
                y = R.to_real(y)
                return inj.when_defined_at(
                    y,
                    dist.log_density_at(inj.backwards(y)) +
                    inj.log_jacobian(y),
                    R.neg_infinity)

            def generator(self):
                g = dist.generator()

                def fn(gen, env):
                    # the inner draws take the shape the transform's
                    # values give them (one a row, where they vary by row)
                    inner = env.at(env.shape(*inj.parameters))
                    return inj.fast_forwards(g.fn(gen, inner), env)

                return Generator(fn, g.requirements)

            def latent(self):
                return inj.forwards(dist.latent())

            def latent_vec(self, k):
                inner = dist.latent_vec(k)
                return Vec(element=inj.forwards(inner.element), n=k)

        return Transformed()


def _monotone_map(supp: Support, fwd) -> tuple:
    if isinstance(supp, UnboundedSupport):
        return None, None
    if isinstance(supp, BoundedBelowSupport):
        return fwd(supp.min), None
    if isinstance(supp, BoundedAboveSupport):
        return None, fwd(supp.max)
    return fwd(supp.min), fwd(supp.max)


class Scale(Injection):
    """Multiply by a (assumed a > 0; core/Injection.scala:60-82)."""

    def __init__(self, a: R.RealLike):
        self.a = R.to_real(a)
        self._lj = -self.a.log()
        self.parameters = (self.a,)

    def forwards(self, x):
        return x * self.a

    def backwards(self, y):
        return y / self.a

    def log_jacobian(self, y):
        return self._lj

    def fast_forwards(self, x, env):
        return x * env(self.a)

    def transform_support(self, supp):
        lo, hi = _monotone_map(supp, self.forwards)
        if lo is None and hi is None:
            return UnboundedSupport()
        if hi is None:
            return BoundedBelowSupport(lo)
        if lo is None:
            return BoundedAboveSupport(hi)
        return BoundedSupport(lo, hi)


class Translate(Injection):
    def __init__(self, b: R.RealLike):
        self.b = R.to_real(b)
        self.parameters = (self.b,)

    def forwards(self, x):
        return x + self.b

    def backwards(self, y):
        return y - self.b

    def log_jacobian(self, y):
        return R.zero

    def fast_forwards(self, x, env):
        return x + env(self.b)

    def transform_support(self, supp):
        lo, hi = _monotone_map(supp, self.forwards)
        if lo is None and hi is None:
            return UnboundedSupport()
        if hi is None:
            return BoundedBelowSupport(lo)
        if lo is None:
            return BoundedAboveSupport(hi)
        return BoundedSupport(lo, hi)


class ExpInjection(Injection):
    """y = exp(x) (core/Injection.scala Exp object)."""

    def forwards(self, x):
        return x.exp()

    def backwards(self, y):
        return y.log()

    def log_jacobian(self, y):
        return -y.log()

    def fast_forwards(self, x, env):
        return torch.exp(x)

    def when_defined_at(self, y, if_defined, not_defined):
        lo, _ = bounds.bounds_of(y)
        if lo > 0:
            return if_defined
        return R.gt(y, R.zero, if_defined, not_defined)

    def transform_support(self, supp):
        if isinstance(supp, UnboundedSupport):
            return BoundedBelowSupport(R.zero)
        if isinstance(supp, BoundedBelowSupport):
            return BoundedBelowSupport(self.forwards(supp.min))
        if isinstance(supp, BoundedAboveSupport):
            return BoundedSupport(R.zero, self.forwards(supp.max))
        return BoundedSupport(self.forwards(supp.min),
                              self.forwards(supp.max))


Exp = ExpInjection()
