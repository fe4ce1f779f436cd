"""The share of the rows ``BatchedRunner`` ran that were padding, in
percent: 100 x the counter ``runner.padded_rows`` over ``runner.rows``,
summed over the window before the traced slice (``program_spans``)."""

from h100_bench import program_spans


def read(run):
    rows = program_spans.counts(run, "runner.rows")
    pads = program_spans.counts(run, "runner.padded_rows")
    if rows is None or pads is None:
        return None
    total = sum(c.n for c in rows)
    return 100.0 * sum(c.n for c in pads) / total if total else None
