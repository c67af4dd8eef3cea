"""Variationally inferred parameterization (VIP): partial (non-)centering
of location-scale latents (port of rainier_tpu/core/reparam.py:37-90).

For ``x ~ Fam(mu, sigma)`` with interpolation weight ``lam`` in [0, 1],
the sampled parameter is

    x_raw ~ Fam(lam * mu, sigma ** lam)
    x     = mu + sigma ** (1 - lam) * (x_raw - lam * mu)

``lam = 0`` is the default non-centred latent, ``lam = 1`` the centred
one (Gorinova, Moore & Hoffman, arXiv:1906.03028 §3).  ``lam`` enters the
``Real`` DAG, so the emitted CUDA density carries it like any constant.
``auto_vip`` (rainier_tpu/core/reparam.py:92-130) picks ``lam`` by the
paper's criterion, the ELBO of a short mean-field ADVI fit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

from ..compute import bounds
from ..compute import real as R
from ..compute.vec import Vec


def _vip_prior(family, location: R.Real, scale: R.Real, lam: R.Real):
    """log Fam((p - lam*mu) / sigma^lam) - lam*log(sigma), the density of
    the raw parameter x_raw ~ Fam(lam*mu, sigma^lam)."""

    def prior(p: R.Real) -> R.Real:
        sd = scale.pow(lam)
        z = (p - lam * location) / sd
        return family._std_log_density(z) - sd.log()

    return prior


def _vip_family(family):
    from .continuous import Normal, _LocationScaleFamily

    family = Normal if family is None else family
    if not isinstance(family, _LocationScaleFamily):
        raise TypeError("VIP applies to location-scale families "
                        "(Normal/Cauchy/Laplace); got "
                        f"{type(family).__name__}")
    return family


def _vip_args(location, scale, lam):
    location, scale = R.to_real(location), R.to_real(scale)
    lam = R.to_real(lam)
    bounds.check(scale, "σ >= 0", lambda v: v >= 0.0)
    bounds.check(lam, "0 <= λ <= 1", lambda v: 0.0 <= v <= 1.0)
    return location, scale, lam


def vip_latent(location, scale, lam=0.0, family=None) -> R.Real:
    """A location-scale latent at interpolation weight ``lam``:
    ``vip_latent(mu, s, 0.0)`` is ``Normal(mu, s).latent()``
    (non-centred), ``lam=1.0`` the centred parameterization.  ``family``
    defaults to Normal; Cauchy and Laplace work too."""
    family = _vip_family(family)
    location, scale, lam = _vip_args(location, scale, lam)
    x_raw = R.parameter(_vip_prior(family, location, scale, lam))
    return location + scale.pow(R.one - lam) * (x_raw - lam * location)


def vip_latent_vec(location, scale, k: int, lam=0.0, family=None) -> Vec:
    """Vector form: k iid location-scale latents sharing one interpolation
    weight, as a single VectorParameter leaf."""
    family = _vip_family(family)
    location, scale, lam = _vip_args(location, scale, lam)
    vp = R.vector_parameter(k, _vip_prior(family, location, scale, lam))
    return Vec(element=location + scale.pow(R.one - lam) *
               (vp - lam * location), n=k)


@dataclass
class AutoVIPResult:
    model: object            # the Model built at the winning lam
    lam: object              # the winning candidate (as passed to build)
    elbos: list              # final ELBO per candidate, same order
    candidates: list

    def __repr__(self):
        pairs = ", ".join(f"{c}: {e:.2f}"
                          for c, e in zip(self.candidates, self.elbos))
        return f"AutoVIPResult(lam={self.lam}, elbos={{{pairs}}})"


def auto_vip(build: Callable, candidates: Sequence = (0.0, 0.5, 1.0),
             n_steps: int = 600, n_samples: int = 8, seed: int = 0,
             **advi_kwargs) -> AutoVIPResult:
    """Automatic reparameterization: rebuild the model at each candidate
    interpolation weight, score each by the ELBO of a short mean-field
    ADVI fit (arXiv:1906.03028 §4), averaged over the last tenth of its
    recorded ELBOs, and return the winner.  ``build(lam)`` constructs a
    fresh Model using ``vip_latent(..., lam=lam)``; `advi_kwargs` go to
    ``advi`` (``device=``, ``learning_rate=``)."""
    from ..variational import advi

    elbos, models = [], []
    for cand in candidates:
        model = build(cand)
        fit = advi(model, n_steps=n_steps, n_samples=n_samples, seed=seed,
                   **advi_kwargs)
        tail = fit.elbo_trace[-max(1, len(fit.elbo_trace) // 10):]
        elbos.append(float(sum(tail) / len(tail)))
        models.append(model)
    best = max(range(len(candidates)), key=lambda i: elbos[i])
    return AutoVIPResult(model=models[best], lam=candidates[best],
                         elbos=elbos, candidates=list(candidates))
