"""BatchNorm2D in eval mode, counterpart of ``cnn_tpu/ops/batchnorm.py``.

Uses the moving statistics, with ``cnn_tpu``'s exact formula:
``inv = gamma / sqrt(var + eps)`` as ``gamma * reciprocal(sqrt(var + eps))``,
then ``x * inv + (beta - mean * inv)``, in float32. Training-mode BN comes
with the training slice of the port.
"""

from __future__ import annotations

import torch


def batch_norm2d_eval(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, mean: torch.Tensor,
                      var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """NHWC; the statistics broadcast over the last (channel) axis."""
    gamma, beta = gamma.float(), beta.float()
    inv = gamma * torch.reciprocal(torch.sqrt(var.float() + eps))
    y = x.float() * inv + (beta - mean.float() * inv)
    return y.to(x.dtype)
