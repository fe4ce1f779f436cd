"""Running-mean metric accumulators that stay on the device.

The JAX package's ``MeanAccumulator``/``MetricBank`` (torchmetrics
``MeanMetric`` semantics): totals and counts are tensors on the metrics'
device, so updating them never waits for the card; the host reads them
only when it logs.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch


def _scalar(value, device=None) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=device)


@dataclasses.dataclass
class MeanAccumulator:
    """Running mean of scalars."""
    total: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def zero(device=None) -> "MeanAccumulator":
        return MeanAccumulator(_scalar(0.0, device), _scalar(0.0, device))

    def update(self, value, weight=1.0) -> "MeanAccumulator":
        w = _scalar(weight, self.total.device)
        return MeanAccumulator(
            self.total + _scalar(value, self.total.device) * w,
            self.count + w)

    def compute(self) -> torch.Tensor:
        return self.total / torch.clamp(self.count, min=1e-12)


class MetricBank:
    """Named collection of MeanAccumulators as a plain dict."""

    @staticmethod
    def zeros(names, device=None) -> dict[str, MeanAccumulator]:
        return {n: MeanAccumulator.zero(device) for n in names}

    @staticmethod
    def update(bank: Mapping[str, MeanAccumulator],
               values: Mapping[str, torch.Tensor],
               weight=1.0) -> dict[str, MeanAccumulator]:
        return {n: (acc.update(values[n], weight) if n in values else acc)
                for n, acc in bank.items()}

    @staticmethod
    def compute(bank: Mapping[str, MeanAccumulator]
                ) -> dict[str, torch.Tensor]:
        return {n: acc.compute() for n, acc in bank.items()}
