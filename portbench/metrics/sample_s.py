"""The program's own `Trace.timings["sample_s"]`, the mean over the counted
fits."""


def read(run):
    return run.timing("sample_s")
