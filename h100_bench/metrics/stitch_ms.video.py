"""Milliseconds a window in the engine's ``clip.stitch`` span (the
least-squares alignment and the blend, issued on the card; host time),
the mean over the window before the traced slice (``program_spans``)."""

from h100_bench import program_spans


def read(run):
    return program_spans.mean_ms(run, "clip.stitch")
