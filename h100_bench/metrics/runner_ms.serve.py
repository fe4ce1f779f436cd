"""Milliseconds a batch inside the engine's runner (upload, forward,
readback) in the window before the traced slice: ``runner_seconds /
batches`` of ``DepthServingEngine.stats()``."""


def read(run):
    pre = run.extra.get("pre")
    if not pre or not pre["units"]:
        return None
    return 1e3 * pre["runner_seconds"] / pre["units"]
