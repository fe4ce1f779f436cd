"""The share of the window positions run that were carried from the
window before, in percent: 100 x the counter ``clip.carried_frames``
over ``clip.new_frames`` + ``clip.carried_frames`` +
``clip.padded_frames``, summed over the whole measured window (counting
positions is not slowed by the traced slice; over the part before the
slice alone, the two procedures that start together at the window's
start weigh more). A 352-frame procedure runs 150 of its 512 positions
carried (29.3%); it falls only if carried frames stop being re-run."""

from h100_bench import program_spans


def read(run):
    rec = program_spans.recorder()
    if rec is None or run.window is None or run.trace is None:
        return None
    lo, hi = round(run.window.t0 * 1e9), round(run.window.t1 * 1e9)
    if rec.dropped(lo):
        return None
    total = {name: sum(c.n for c in rec.counts(f"clip.{name}_frames", lo,
                                               hi))
             for name in ("new", "carried", "padded")}
    n = sum(total.values())
    return 100.0 * total["carried"] / n if n else None
