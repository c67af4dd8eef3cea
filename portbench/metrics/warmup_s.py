"""The program's own `Trace.timings["warmup_s"]`, the mean over the counted
fits."""


def read(run):
    return run.timing("warmup_s")
