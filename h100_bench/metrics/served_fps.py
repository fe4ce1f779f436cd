"""Depth maps completed inside the window, over the window's seconds."""


def read(run):
    return run.completed_in_window() / run.window_s
