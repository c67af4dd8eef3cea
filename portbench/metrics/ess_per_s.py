"""Effective draws a second: each counted fit's least bulk rank-normalised
ESS over its coordinates (portbench/ess.py), summed over the fits, over
the same fits' summed wall time."""


def read(run):
    return (sum(run.ess_min(i) for i in range(len(run.fits)))
            / sum(f.wall for f in run.fits))
