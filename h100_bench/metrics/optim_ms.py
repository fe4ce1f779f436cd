"""Device milliseconds a step of ``DepthTask.train_step``'s optimizer
(``train.optimizer``: the gradient sync, the clip, AdamW and the
schedule, timed by CUDA events on the card), the mean over the window
before the traced step (``program_spans``); None where a span has no
device time."""

from h100_bench import program_spans


def read(run):
    got = program_spans.spans(run, "train.optimizer")
    if got is None or any(s.device_ms is None for s in got):
        return None
    return sum(s.device_ms for s in got) / len(got)
