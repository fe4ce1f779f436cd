"""Whole optimizer steps back to back: the port's ``DepthTask`` on the
seed's uint8 images, uint16 depths and augmentation draws
(``training.window``), its first steps held to the reference's
(``training.check``)."""

from __future__ import annotations

from h100_bench import training


def run(spec: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float):
    return training.run(spec, seed, seconds, trace, device, t_start)
