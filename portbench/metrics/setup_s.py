"""Set-up seconds: from the process's start to the window's (imports, data,
model build, kernel build or cache load, the set-up fit)."""


def read(run):
    return run.setup_s
