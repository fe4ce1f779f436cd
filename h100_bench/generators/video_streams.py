"""Recorded procedures as video streams, back to back: Video Depth
Anything behind the serving engine's clip mode, ``procedures_in_flight``
streams at once, each kept ``ahead`` frames submitted (``video.drive``),
the checked procedure's final maps held to the reference's windowed run
(``video.check``)."""

from __future__ import annotations

from h100_bench import video


def run(spec: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float):
    return video.run(spec, seed, seconds, trace, device, t_start)
