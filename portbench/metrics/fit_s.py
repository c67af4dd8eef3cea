"""Seconds a user waits for one posterior: the counted fits' summed wall
time over their number."""


def read(run):
    return sum(f.wall for f in run.fits) / len(run.fits)
