from . import combinatorics
from .combinatorics import beta as log_beta, choose as log_choose
from .combinatorics import factorial as log_factorial, gamma as log_gamma
from .continuous import (Beta, Cauchy, Continuous, Exponential, Gamma,
                         Laplace, LogNormal, Mixture, Normal, Uniform)
from .discrete import (Bernoulli, BetaBinomial, Binomial, Discrete,
                       DiscreteConstant, DiscreteMixture, Geometric,
                       NegativeBinomial, Poisson)
from .distribution import Distribution
from .generator import Env, Generator, to_generator
from .injection import Exp, Injection, Scale, Translate
from .marginal import MarginalizedLatent, enumerated_support, marginalize
from .model import Model
from .multinomial import Multinomial
from .mvnormal import MVNormal
from .reparam import AutoVIPResult, auto_vip, vip_latent, vip_latent_vec
from .sbc import SBC, Rep, rank_uniformity_pvalue
from .support import (BoundedAboveSupport, BoundedBelowSupport,
                      BoundedSupport, Support, UnboundedSupport)
from .trace import Diagnostics, Trace

__all__ = [
    "combinatorics", "log_beta", "log_choose", "log_factorial", "log_gamma",
    "Beta", "Cauchy", "Continuous", "Exponential", "Gamma", "Laplace",
    "LogNormal", "Mixture", "Normal", "Uniform", "Bernoulli", "BetaBinomial",
    "Binomial", "Discrete", "DiscreteConstant", "DiscreteMixture",
    "Geometric", "NegativeBinomial", "Poisson", "Distribution", "Env",
    "Generator", "to_generator", "Exp", "Injection", "Scale", "Translate",
    "Model", "Multinomial", "BoundedAboveSupport", "BoundedBelowSupport",
    "BoundedSupport", "Support", "UnboundedSupport", "SBC", "Rep",
    "rank_uniformity_pvalue", "Diagnostics", "Trace", "vip_latent",
    "vip_latent_vec", "MVNormal", "MarginalizedLatent",
    "enumerated_support", "marginalize", "AutoVIPResult", "auto_vip",
]
