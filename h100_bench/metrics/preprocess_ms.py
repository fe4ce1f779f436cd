"""Host milliseconds a training step spent in ``DevicePreprocessor``
(``train.preprocess`` spans): their sum over the window before the traced
step, over the steps finished in it (``program_spans``)."""

from h100_bench import program_spans


def read(run):
    got = program_spans.spans(run, "train.preprocess")
    units = (run.extra.get("pre") or {}).get("units")
    if got is None or not units:
        return None
    return sum(s.ms for s in got) / units
