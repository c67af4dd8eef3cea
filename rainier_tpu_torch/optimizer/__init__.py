from .lbfgs import LBFGSState, lbfgs_map, minimize

__all__ = ["LBFGSState", "lbfgs_map", "minimize"]
