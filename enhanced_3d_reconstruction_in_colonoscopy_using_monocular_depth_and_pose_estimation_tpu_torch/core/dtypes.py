"""Mixed-precision policy of the port.

As in the JAX package: parameters in f32 (master weights), activations and
matmuls in bf16 (the tensor cores' native type, with f32's exponent range,
so no loss scaling), and losses, metrics and the metric-depth output head
in f32 so the regression does not drift.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32  # loss/metrics/depth head


POLICY_BF16 = DtypePolicy()
POLICY_F32 = DtypePolicy(compute_dtype=torch.float32)


def policy_from_precision(precision: str) -> DtypePolicy:
    """Map reference precision strings to policies."""
    if precision in ("16-mixed", "bf16-mixed", "bf16"):
        return POLICY_BF16
    if precision in ("32-true", "32", "fp32"):
        return POLICY_F32
    raise ValueError(f"unknown precision: {precision}")
