"""rainier_tpu_torch: the PyTorch/CUDA port of rainier_tpu.

The same modelling DSL, compiler and HMC samplers as the JAX package,
for an NVIDIA H100: plain tensor code is PyTorch, and the JAX package's
Pallas TPU kernel is a CUDA kernel written by hand for Hopper
(``ops/fused_hmc.py``).  The public names mirror ``rainier_tpu``'s, so
one ``build(rt)`` function builds the same model through either package.
This package imports neither ``jax`` nor any module of ``rainier_tpu``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` or calls ``config.set_device("cpu")``.
"""

from . import compute
from .compute import (Real, Vec, const, to_real, parameter,
                      vector_parameter, sum_, log_sum_exp, eq, lt, gt, lte,
                      gte, compare, lookup, zero, one, two, neg_one, pi,
                      infinity, neg_infinity, Column, IntColumn, MatColumn)
from . import config
from . import core
from .core import (Beta, Bernoulli, BetaBinomial, Binomial, Cauchy,
                   Continuous, Discrete, DiscreteConstant, DiscreteMixture,
                   Distribution, Exponential, Gamma, Generator, Geometric,
                   Laplace, LogNormal, Mixture, Model, Multinomial,
                   MVNormal, NegativeBinomial, Normal, Poisson, Uniform,
                   MarginalizedLatent, marginalize, auto_vip, vip_latent,
                   vip_latent_vec)
from . import sampler
from .sampler import (EHMC, HMC, NUTS, SamplerConfig, StaticMassMatrix,
                      StaticStepSize)
from . import optimizer
from . import variational
from .variational import advi
from . import ops
from . import viz
from . import inspect as inspection
from . import parallel

__version__ = "0.1.0"
