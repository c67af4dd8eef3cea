"""The program's own `Trace.timings["build_s"]`, the mean over the counted
fits."""


def read(run):
    return run.timing("build_s")
