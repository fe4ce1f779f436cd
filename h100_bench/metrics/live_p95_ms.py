"""The 95th percentile, over every frame due in the window, of the time
from when the frame was due to when its future resolved. A frame that
failed, or was still out at the window's close plus the traffic's
``grace_s``, counts at that deadline: above any limit."""

import numpy as np


def read(run):
    w = run.window
    if not w.requests:
        return None
    deadline = w.t1 + float(run.traffic["grace_s"])
    lat = [(r.done if r.ok else deadline) - r.due for r in w.requests]
    return float(np.percentile(np.asarray(lat), 95) * 1e3)
