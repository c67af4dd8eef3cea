from .config import (EHMC, HMC, NUTS, DenseMassMatrixTuner,
                     DiagonalMassMatrixTuner, DualAvgStepSize,
                     IdentityMassMatrix, SamplerConfig, StaticMassMatrix,
                     StaticStepSize, ehmc, hmc, nuts)
from .driver import sample
from .leapfrog import ChainState, hmc_transition, leapfrog
from .mass import MassState, dense_mass, diag_mass, identity_mass
from .stats import StatsState

__all__ = [
    "EHMC", "HMC", "NUTS", "DenseMassMatrixTuner", "DiagonalMassMatrixTuner",
    "DualAvgStepSize", "IdentityMassMatrix", "SamplerConfig",
    "StaticMassMatrix", "StaticStepSize", "ehmc", "hmc", "nuts", "sample",
    "ChainState", "hmc_transition", "leapfrog", "MassState", "dense_mass",
    "diag_mass", "identity_mass", "StatsState",
]
