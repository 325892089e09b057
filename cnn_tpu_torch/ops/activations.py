"""ReLU, counterpart of ``cnn_tpu/ops/activations.py``: x where x > 0, else 0."""

from __future__ import annotations

import torch


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))
