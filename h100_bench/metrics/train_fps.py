"""Frames of the optimizer steps completed in the window, over the time
from the window's start to the end of the last of them (which ends in a
sync)."""


def read(run):
    steps = run.extra["steps"]
    if not steps:
        return None
    return len(steps) * run.extra["rows"] / run.window_s
