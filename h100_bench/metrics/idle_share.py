"""The share of the window in which the device ran nothing, in percent:
one less the device's busy seconds per unit of work (a served batch, or a
training step), read from the traced slice (the union of its kernels',
copies' and sets' intervals over the units finished inside it), times
the units finished in the window before the slice, over those seconds.
Neither the slice's wall nor the time after it is the divisor: recording
every host op slows the driving thread in the slice and stopping the
profiler stalls it after, which would count as idle device time."""


def read(run):
    units, pre = run.extra.get("slice_units", 0), run.extra.get("pre")
    if run.trace is None or units <= 0 or not pre or not pre["units"]:
        return None
    busy_per_unit = run.trace.busy_s / units
    return 100.0 * (1.0 - busy_per_unit * pre["units"] / pre["seconds"])
