from .config import (EHMC, HMC, NUTS, DenseMassMatrixTuner,
                     DiagonalMassMatrixTuner, DualAvgStepSize,
                     IdentityMassMatrix, SamplerConfig, StaticMassMatrix,
                     StaticStepSize, ehmc, hmc, nuts)
from .driver import sample
from .leapfrog import ChainState, hmc_transition, leapfrog
from .mass import MassState, dense_mass, diag_mass, identity_mass
from .progress import (ConsoleProgress, HTMLProgress, Progress,
                       SilentProgress)
from .smc import SMCConfig, SMCResult, run_smc, smc, systematic_resample
from .stats import StatsState, accept_rate, bfmi

__all__ = [
    "EHMC", "HMC", "NUTS", "DenseMassMatrixTuner", "DiagonalMassMatrixTuner",
    "DualAvgStepSize", "IdentityMassMatrix", "SamplerConfig",
    "StaticMassMatrix", "StaticStepSize", "ehmc", "hmc", "nuts", "sample",
    "ChainState", "hmc_transition", "leapfrog", "MassState", "dense_mass",
    "diag_mass", "identity_mass", "ConsoleProgress", "HTMLProgress",
    "Progress", "SilentProgress", "SMCConfig", "SMCResult", "run_smc", "smc",
    "systematic_resample", "StatsState", "accept_rate", "bfmi",
]
