"""Multinomial distribution (port of rainier_tpu/core/multinomial.py,
counterpart of core/Multinomial.scala:11-38)."""

from __future__ import annotations

import torch

from ..compute import real as R
from . import combinatorics
from .distribution import Distribution
from .generator import Generator


class Multinomial(Distribution):
    """pmf-map parameterized multinomial over outcomes T with k trials.

    Observations are dicts T -> count.
    """

    def __init__(self, pmf: dict, k):
        self.pmf = {t: R.to_real(p) for t, p in pmf.items()}
        self.k = R.to_real(k)

    def log_density_at(self, v: dict) -> R.Real:
        terms = [combinatorics.factorial(self.k)]
        for t, i in v.items():
            i = R.to_real(i)
            p = self.pmf.get(t, R.zero)
            p_term = R.eq(i, R.zero, R.zero, i * p.log())
            terms.append(p_term - combinatorics.factorial(i))
        return R.sum_(terms)

    def log_density(self, ys) -> R.Real:
        if isinstance(ys, dict):
            return self.log_density_at(ys)
        return R.sum_([self.log_density_at(y) for y in ys])

    def generator(self) -> Generator:
        """{outcome: int32 counts} by the chain of conditional binomials:
        outcome i takes Binomial(k left, p_i / (the mass not yet
        drawn)), so each draw may have its own k."""
        keys_ = list(self.pmf.keys())
        probs = [self.pmf[t] for t in keys_]
        k = self.k

        def fn(gen, env):
            shape = env.shape(k, *probs)
            p = torch.stack([env.full(pr, shape) for pr in probs])
            p = p / p.sum(0)
            left = env.full(k, shape).round()
            rest = torch.ones(shape, dtype=env.dtype, device=env.device)
            counts = {}
            for i, t in enumerate(keys_[:-1]):
                ratio = (p[i] / rest).clamp(0.0, 1.0).nan_to_num(0.0)
                c = torch.binomial(left, ratio.contiguous(), generator=gen)
                counts[t] = c.to(torch.int32)
                left = left - c
                rest = rest - p[i]
            counts[keys_[-1]] = left.to(torch.int32)
            return counts

        return Generator(fn, frozenset(probs + [k]))

    @staticmethod
    def optional(pmf: dict, k) -> "Multinomial":
        total = R.sum_(list(pmf.values()))
        new_pmf = {(t,): p for t, p in pmf.items()}
        new_pmf[None] = R.one - total
        return Multinomial(new_pmf, k)
