"""Transition kernels behind one interface used by the driver (port of
rainier_tpu/sampler/samplers.py, HMC branch):

    init_extra(cfg)                            -> extra state
    step(cfg, gen, chain, eps, mass, extra,
         lpg, warmup)                          -> (TransitionResult, extra,
                                                   n_grad_evals)

HMC: sampler/HMC.scala.  EHMC and NUTS come in a later slice of the port.
"""

from __future__ import annotations

from . import config as C
from .leapfrog import hmc_transition


def _unported(cfg):
    return NotImplementedError(
        f"{type(cfg).__name__} sampling comes in a later slice of the "
        "port; use sampler=HMC(n_steps)")


def init_extra(cfg):
    if isinstance(cfg, C.HMC):
        return ()
    raise _unported(cfg)


def step(cfg, gen, chain, eps, mass, extra, lpg, warmup: bool):
    if isinstance(cfg, C.HMC):
        res = hmc_transition(gen, chain, eps, cfg.n_steps, mass, lpg)
        return res, extra, cfg.n_steps
    raise _unported(cfg)
