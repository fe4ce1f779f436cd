"""Mean frames per batch the engine served in the window before the
traced slice (``DepthServingEngine.stats()['mean_batch_fill']``)."""


def read(run):
    pre = run.extra.get("pre")
    return pre["mean_batch_fill"] if pre and pre["units"] else None
