"""Milliseconds a chunk in ``BatchedRunner``'s ``runner.readback`` span
(waiting for the card, the copy of the maps back, NumPy), the mean over
the window before the traced slice (``program_spans``)."""

from h100_bench import program_spans


def read(run):
    return program_spans.mean_ms(run, "runner.readback")
