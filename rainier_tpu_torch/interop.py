"""Carrying the adaptation product between the two packages.

The model itself needs no conversion — ``build(rt)`` rebuilds it through
either package.  What crosses is the warmup's product (the JAX package's
``WarmupProduct``, rainier_tpu/sampler/driver.py:70-78) as numpy arrays
with chains first: chain positions, potentials and gradients, the mass
diagonal or the dense Σ̂ and its Cholesky factor, the step sizes, and
EHMC's ring of trajectory lengths.  With it a test can feed the JAX
warmup into the port's sampling phase and compare the two kernels draw by
draw.  A fitted variational posterior crosses the same way: its mu and
its log_sigma or Cholesky factor.  The L-BFGS and SMC states need
nothing: their inputs are the model's flat parameter vectors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .sampler.driver import WarmupProduct
from .sampler.leapfrog import ChainState
from .sampler.mass import MassState
from .sampler.samplers import RingBuffer
from .sampler.stats import StatsState
from .variational import VariationalPosterior


def warmup_product_from_numpy(d: dict, device=None) -> WarmupProduct:
    """{'q' (C, n), 'potential' (C,), 'grad' (C, n), 'mass_diag' (C, n),
    'mass_cov' and 'mass_chol' (C, n, n), 'step_size' (C,), 'ring_buf'
    (C, size), 'ring_idx' and 'ring_count' (C,)}, the mass and ring keys
    None or absent where the run has none → the port's WarmupProduct in
    float32, the fused kernel's type (the ring's positions int32).  Warmup
    statistics are not carried: they start at zero with prev_energy =
    potential."""
    dev = config.resolve_device(device)

    def t(key, dtype=torch.float32):
        x = d.get(key)
        return None if x is None else torch.as_tensor(
            np.array(x), dtype=dtype, device=dev)

    potential = t("potential")
    zi = torch.zeros(potential.shape, dtype=torch.int32, device=dev)
    z = torch.zeros_like(potential)
    stats = StatsState(iterations=zi, divergences=zi, accept_sum=z,
                       grad_evals=zi, prev_energy=potential, energy_trans2=z,
                       e_count=z, e_mean=z, e_raw=z)
    extra = () if d.get("ring_buf") is None else RingBuffer(
        buf=t("ring_buf"), idx=t("ring_idx", torch.int32),
        count=t("ring_count", torch.int32))
    return WarmupProduct(
        chain=ChainState(q=t("q"), potential=potential, grad=t("grad")),
        extra=extra,
        mass=MassState(diag=t("mass_diag"), cov=t("mass_cov"),
                       chol=t("mass_chol")),
        step_size=t("step_size"), warmup_stats=stats)


def warmup_product_to_numpy(wp) -> dict:
    """The inverse: any WarmupProduct-shaped object (the port's, or the
    JAX package's with its arrays) → the dict of numpy arrays above."""
    def a(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
        return np.asarray(x)

    ring = wp.extra if hasattr(wp.extra, "buf") else None
    return {"q": a(wp.chain.q), "potential": a(wp.chain.potential),
            "grad": a(wp.chain.grad), "mass_diag": a(wp.mass.diag),
            "mass_cov": a(wp.mass.cov), "mass_chol": a(wp.mass.chol),
            "step_size": a(wp.step_size),
            "ring_buf": None if ring is None else a(ring.buf),
            "ring_idx": None if ring is None else a(ring.idx),
            "ring_count": None if ring is None else a(ring.count)}


def variational_posterior_from_numpy(mu, log_sigma=None, chol=None,
                                     model=None, compiled=None,
                                     elbo_trace=None, device=None,
                                     dtype=None) -> VariationalPosterior:
    """The port's VariationalPosterior of a fit given as numpy arrays (the
    JAX one's ``mu`` and ``log_sigma`` or ``chol``), on `device` in
    `dtype` (default ``config.dtype()``): its ``sample``, ``evaluate``
    and ``mean`` then read the same q.  `compiled` defaults to the
    model's density."""
    dev = config.resolve_device(device)
    dtype = dtype or config.dtype()

    def t(x):
        return None if x is None else torch.as_tensor(
            np.array(x), dtype=dtype, device=dev)

    if compiled is None and model is not None:
        compiled = model.density()
    return VariationalPosterior(
        mu=t(mu), log_sigma=t(log_sigma), chol=t(chol),
        elbo_trace=np.asarray([] if elbo_trace is None else elbo_trace),
        model=model, compiled=compiled)
