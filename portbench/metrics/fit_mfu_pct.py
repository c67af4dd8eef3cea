"""The whole fit's share of the card's float32 peak: the float32
operations of warmup's and sampling's HMC iterations of every chain,
counted from the configuration's shapes (portbench/work.py), over the
counted fits' wall time."""

from portbench.work import fit_ops


def read(run):
    if run.peaks is None:
        return None
    t = run.traffic
    ops = fit_ops(run.work, t["chains"], t["warmup"], t["draws"],
                  t["hmc_steps"])
    return (100.0 * ops * len(run.fits)
            / (sum(f.wall for f in run.fits) * run.peaks["flops"]))
