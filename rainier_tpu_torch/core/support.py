"""Unconstraining transforms (counterpart of core/Support.scala:10-96).

Every `latent` draws an unconstrained parameter x ∈ ℝ and maps it into the
distribution's support with the corresponding log-Jacobian correction, so
HMC always runs on ℝⁿ.  Transform shapes match the reference exactly:

* UnboundedSupport      — identity
* BoundedSupport(a,b)   — scaled logistic: σ(x)·(b−a)+a
* BoundedBelowSupport(m)— exp(x)+m
* BoundedAboveSupport(M)— M−exp(−x)
"""

from __future__ import annotations

from ..compute import real as R


class Support:
    def transform(self, v: R.Real) -> R.Real:
        raise NotImplementedError

    def log_jacobian(self, v: R.Real) -> R.Real:
        raise NotImplementedError

    def union(self, that: "Support") -> "Support":
        """Union of supports, assumed contiguous (core/Support.scala:22-47)."""
        a, b = self, that
        if isinstance(a, UnboundedSupport) or isinstance(b, UnboundedSupport):
            return UnboundedSupport()

        def lo(s):
            if isinstance(s, (BoundedBelowSupport, BoundedSupport)):
                return s.min
            return None

        def hi(s):
            if isinstance(s, (BoundedAboveSupport, BoundedSupport)):
                return s.max
            return None

        alo, ahi, blo, bhi = lo(a), hi(a), lo(b), hi(b)
        if alo is not None and blo is not None:
            new_min = alo.min(blo)
            if ahi is not None and bhi is not None:
                return BoundedSupport(new_min, ahi.max(bhi))
            return BoundedBelowSupport(new_min)
        if ahi is not None and bhi is not None:
            return BoundedAboveSupport(ahi.max(bhi))
        return UnboundedSupport()

    @staticmethod
    def union_all(supports) -> "Support":
        supports = list(supports)
        s = supports[0]
        for t in supports[1:]:
            s = s.union(t)
        return s


class UnboundedSupport(Support):
    def transform(self, v):
        return v

    def log_jacobian(self, v):
        return R.zero


class BoundedSupport(Support):
    def __init__(self, min_: R.RealLike, max_: R.RealLike):
        self.min = R.to_real(min_)
        self.max = R.to_real(max_)

    def transform(self, v):
        return v.logistic() * (self.max - self.min) + self.min

    def log_jacobian(self, v):
        # log σ(v) + log(1−σ(v)) + log(b−a); expressed via softplus for
        # f32 stability at |v| ≳ 20 (σ saturates; the reference's f64 form
        # underflows to -inf there)
        return -v.softplus() - (-v).softplus() + (self.max - self.min).log()


class BoundedBelowSupport(Support):
    def __init__(self, min_: R.RealLike = R.zero):
        self.min = R.to_real(min_)

    def transform(self, v):
        return v.exp() + self.min

    def log_jacobian(self, v):
        return v


class BoundedAboveSupport(Support):
    def __init__(self, max_: R.RealLike = R.zero):
        self.max = R.to_real(max_)

    def transform(self, v):
        return self.max - (-v).exp()

    def log_jacobian(self, v):
        return -v
