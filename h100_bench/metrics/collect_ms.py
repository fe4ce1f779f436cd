"""Milliseconds the engine took to collect a batch, its first frame taken
to the batch closed (full, at the flush deadline or at shutdown;
``engine.collect``), the mean over the window before the traced slice
(``program_spans``)."""

from h100_bench import program_spans


def read(run):
    return program_spans.mean_ms(run, "engine.collect")
