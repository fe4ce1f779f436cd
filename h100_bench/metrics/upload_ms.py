"""Milliseconds a chunk in ``BatchedRunner``'s ``runner.upload`` span
(stacking and padding the frames on the host, the copy to the card), the
mean over the window before the traced slice (``program_spans``)."""

from h100_bench import program_spans


def read(run):
    return program_spans.mean_ms(run, "runner.upload")
