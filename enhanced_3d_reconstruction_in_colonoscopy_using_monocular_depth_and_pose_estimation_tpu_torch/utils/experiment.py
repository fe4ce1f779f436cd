"""Experiment naming, matching the reference's run-id scheme (the JAX
package's ``utils/experiment.py``):
``m{encoder}_el{enc_lr}_dl{dec_lr}_b{batch}_e{epochs}_d{ds_type}_p{pct_start}``.
"""

from __future__ import annotations


def experiment_id(encoder: str, encoder_lr: float, decoder_lr: float,
                  batch_size: int, max_epochs: int, ds_type: str,
                  pct_start: float) -> str:
    return (
        f"m{encoder}_el{encoder_lr}_dl{decoder_lr}"
        f"_b{batch_size}_e{max_epochs}_d{ds_type}_p{pct_start}"
    )


def pose_experiment_id(lr: float, batch_size: int, max_epochs: int) -> str:
    """Pose run dir: ``l{lr}_b{batch}_e{epochs}``
    (``configs/pose_estimation/pose_estimation.yaml``)."""
    return f"l{lr}_b{batch_size}_e{max_epochs}"
