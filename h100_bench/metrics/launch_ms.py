"""Milliseconds a chunk in ``BatchedRunner``'s ``runner.launch`` span
(issuing the forward: resize, normalisation, model, resize back; host
time, the card runs on after it), the mean over the window before the
traced slice (``program_spans``)."""

from h100_bench import program_spans


def read(run):
    return program_spans.mean_ms(run, "runner.launch")
