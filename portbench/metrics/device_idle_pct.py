"""The device's idle share over the traced fits: one less the union of
its operations' intervals (kernels, copies, sets) over the fits' summed
wall time."""


def read(run):
    if run.activity is None:
        return None
    busy, _ = run.activity.busy()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / run.activity.window_s)
