"""Traffic generators, one file each, found by the name a traffic file
gives as its ``generator``.

Each module has ``run(spec, seed, seconds, trace, device, t_start)``,
which makes the cell's set-up, drives its window with the traffic's
parameters (``spec["traffic"]``), checks what the window produced and
returns a ``harness.Outcome``. Serving generators hand a ``drive`` to
``serving.run``; training generators build on ``training``.
"""
