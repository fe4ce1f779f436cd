"""The share of the traced slice's busy device time spent in the motion
modules, in percent: the device time of the kernels launched inside the
``temporal.module`` spans' profiler twins (on the engine's thread) over
the slice's busy time; None where the slice holds no such twin."""


def read(run):
    tr = run.trace
    if tr is None or not hasattr(tr, "range_device_s") or tr.busy_s <= 0:
        return None
    secs = tr.range_device_s("temporal.module")
    return None if secs is None else 100.0 * secs / tr.busy_s
