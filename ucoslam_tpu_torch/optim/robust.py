"""Robust-kernel weights (port of `ucoslam_tpu/optim/robust.py`)."""

from __future__ import annotations

import torch


def huber_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """IRLS weight of the Huber kernel for squared error chi2:
    min(1, delta / sqrt(chi2))."""
    return torch.sqrt(delta2 / chi2.clamp(min=1e-12)).clamp(max=1.0)
