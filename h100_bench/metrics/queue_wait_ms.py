"""Milliseconds a frame waited in the engine's queue, ``submit()`` to the
batcher taking it into a batch (``engine.queue``), the mean over the
window before the traced slice (``program_spans``)."""

from h100_bench import program_spans


def read(run):
    return program_spans.mean_ms(run, "engine.queue")
