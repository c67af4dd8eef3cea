"""Carrying the adaptation product between the two packages.

The model itself needs no conversion — ``build(rt)`` rebuilds it through
either package.  What crosses is the warmup's product (the JAX package's
``WarmupProduct``, rainier_tpu/sampler/driver.py:70-78): chain positions,
potentials and gradients, the mass diagonal and the step sizes, as numpy
arrays with chains first.  With it a test can feed the JAX warmup into
the port's sampling phase and compare the two kernels draw by draw.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .sampler.driver import WarmupProduct
from .sampler.leapfrog import ChainState
from .sampler.mass import MassState
from .sampler.stats import StatsState

_KEYS = ("q", "potential", "grad", "mass_diag", "step_size")


def warmup_product_from_numpy(d: dict, device=None) -> WarmupProduct:
    """{'q' (C, n), 'potential' (C,), 'grad' (C, n), 'mass_diag' (C, n) or
    None, 'step_size' (C,)} → the port's WarmupProduct in float32, the
    fused kernel's type.  Warmup statistics are not carried: they start at
    zero with prev_energy = potential."""
    dev = config.resolve_device(device)

    def t(x):
        return torch.as_tensor(np.array(x), dtype=torch.float32, device=dev)

    potential = t(d["potential"])
    zi = torch.zeros(potential.shape, dtype=torch.int32, device=dev)
    z = torch.zeros_like(potential)
    stats = StatsState(iterations=zi, divergences=zi, accept_sum=z,
                       grad_evals=zi, prev_energy=potential, energy_trans2=z,
                       e_count=z, e_mean=z, e_raw=z)
    diag = d.get("mass_diag")
    return WarmupProduct(
        chain=ChainState(q=t(d["q"]), potential=potential,
                         grad=t(d["grad"])),
        extra=(), mass=MassState(diag=None if diag is None else t(diag)),
        step_size=t(d["step_size"]), warmup_stats=stats)


def warmup_product_to_numpy(wp) -> dict:
    """The inverse: any WarmupProduct-shaped object (the port's, or the
    JAX package's with its arrays) → the dict of numpy arrays above."""
    def a(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
        return np.asarray(x)

    diag = wp.mass.diag
    return {"q": a(wp.chain.q), "potential": a(wp.chain.potential),
            "grad": a(wp.chain.grad),
            "mass_diag": None if diag is None else a(diag),
            "step_size": a(wp.step_size)}
