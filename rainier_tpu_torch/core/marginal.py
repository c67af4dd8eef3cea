"""Marginalized (Rao-Blackwellized) discrete latent variables (port of
rainier_tpu/core/marginal.py).

A finite-support (or explicitly truncated) discrete latent is summed out
by exact enumeration,

    log p(rest) = logsumexp_k [ log pmf(z = v_k) + log p(rest | z = v_k) ]

and its exact conditional posterior p(z = v_k | rest) = softmax_k(log
joint_k) is a Real, evaluable per posterior draw.  Enumeration happens
when the graph is built: the density holds one ``LogSumExp`` over the
support, a row of a data column's when the body is column-shaped, which
the fused kernel's emitter takes like any other row term.

Usage::

    z = marginalize(Bernoulli(theta),
                    lambda z: Normal(mus[z], 1.0).log_density(xs))
    model = Model.likelihood(z.log_density)
    ...
    probs = trace.evaluate(z.posterior_prob(1))   # p(z=1 | data), per draw
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from ..compute import real as R
from .discrete import (Bernoulli, BetaBinomial, Binomial, Discrete,
                       DiscreteConstant, DiscreteMixture)


def enumerated_support(dist: Discrete,
                       max_value: Optional[int] = None) -> Optional[list]:
    """The distribution's support as concrete values, when finite (or
    truncatable to {0..max_value}).  Returns None when it cannot be
    enumerated without an explicit truncation."""
    if isinstance(dist, DiscreteConstant):
        if isinstance(dist.constant, R.Constant):
            return [float(dist.constant.value)]
        return None
    if isinstance(dist, Bernoulli):
        return [0.0, 1.0]
    if isinstance(dist, (Binomial, BetaBinomial)):
        if isinstance(dist.k, R.Constant):
            return [float(i) for i in range(int(dist.k.value) + 1)]
        return None
    if isinstance(dist, DiscreteMixture):
        vals: list[float] = []
        for comp in dist.components:
            sub = enumerated_support(comp, max_value)
            if sub is None:
                return None
            vals.extend(v for v in sub if v not in vals)
        return sorted(vals)
    # Geometric / Poisson / NegativeBinomial: infinite support, enumerable
    # only under an explicit truncation
    if max_value is not None:
        return [float(i) for i in range(int(max_value) + 1)]
    return None


class MarginalizedLatent:
    """The result of summing a discrete latent out of a model fragment.

    ``log_density`` is the marginal log-density Real to condition on
    (``Model.likelihood``); the ``posterior_*`` accessors give the exact
    conditional distribution of the latent given everything else, as
    Reals evaluable per posterior draw."""

    def __init__(self, values: Sequence[float], log_joints: Sequence[R.Real]):
        self.values = list(values)
        self.log_joints = list(log_joints)
        self.log_density = R.log_sum_exp(self.log_joints)

    def posterior_logit(self, index: int) -> R.Real:
        """log p(z = values[index] | rest), normalized."""
        return self.log_joints[index] - self.log_density

    def posterior_prob(self, index: int) -> R.Real:
        return self.posterior_logit(index).exp()

    def posterior_probs(self) -> list[R.Real]:
        return [self.posterior_prob(i) for i in range(len(self.values))]

    def posterior_mean(self) -> R.Real:
        """E[z | rest], the Rao-Blackwellized point estimate."""
        return R.sum_([R.const(v) * p
                       for v, p in zip(self.values, self.posterior_probs())])


def marginalize(dist: Discrete,
                body: Callable[[int], R.Real] = None,
                support: Optional[Sequence] = None,
                max_value: Optional[int] = None) -> MarginalizedLatent:
    """Sum a discrete latent ``z ~ dist`` out of ``body(z)``.

    ``body`` receives each support value as a plain Python number (so it
    can index Python collections as well as enter Real arithmetic) and
    returns the log-density of the model fragment downstream of ``z``.
    Omit ``body`` to marginalize a bare latent (prior only).  ``support``
    overrides enumeration; ``max_value`` truncates infinite-support
    families to {0..max_value} (the truncated tail mass is the caller's
    to keep negligible).
    """
    if support is None:
        support = enumerated_support(dist, max_value)
    if support is None:
        raise ValueError(
            f"{type(dist).__name__} has no finite support to enumerate; "
            "pass support=[...] or max_value=N to truncate")
    values = [float(v) for v in support]
    if len(values) == 0:
        raise ValueError("empty support")
    log_joints = []
    for v in values:
        lj = dist.log_density_at(R.const(v))
        if body is not None:
            contrib = body(int(v) if float(v).is_integer() else v)
            lj = lj + R.to_real(contrib)
        log_joints.append(lj)
    return MarginalizedLatent(values, log_joints)
