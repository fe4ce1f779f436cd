"""Set-up seconds: from the process's start (imports included) to the
window's start, once the model is loaded and the cell's shapes warmed."""


def read(run):
    return run.setup_s
