"""The program's own `Trace.timings["transfer_s"]`, the mean over the counted
fits."""


def read(run):
    return run.timing("transfer_s")
