"""BatchNorm2D over NHWC, counterpart of ``cnn_tpu/ops/batchnorm.py``.

``cnn_tpu``'s exact formulas, in float32:
- eval: the moving statistics;
- train: the batch statistics in one pass, ``E[x^2] - E[x]^2`` clamped at 0
  (biased: divided by N = B*H*W), and the moving statistics updated as
  ``(1 - momentum) * moving + momentum * batch`` with that same biased
  variance. ``F.batch_norm`` would update with the unbiased one, so BN is
  written out here; autograd differentiates it through the batch
  statistics, as ``jax.grad`` does.
Both normalize as ``x * inv + (beta - mean * inv)`` with
``inv = gamma * reciprocal(sqrt(var + eps))``.
"""

from __future__ import annotations

import torch


def _normalize(x, gamma, beta, mean, var, eps):
    inv = gamma.float() * torch.reciprocal(torch.sqrt(var + eps))
    y = x.float() * inv + (beta.float() - mean * inv)
    return y.to(x.dtype)


def batch_norm2d_eval(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, mean: torch.Tensor,
                      var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """NHWC; the statistics broadcast over the last (channel) axis."""
    return _normalize(x, gamma, beta, mean.float(), var.float(), eps)


def batch_norm2d_train(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, moving_mean: torch.Tensor,
                       moving_var: torch.Tensor, eps: float = 1e-5,
                       momentum: float = 0.1):
    """NHWC, batch statistics. Returns ``(y, new_mean, new_var)``; the new
    moving statistics are detached and keep the moving statistics' dtype."""
    x32 = x.float()
    mean = x32.mean(dim=(0, 1, 2))
    var = torch.clamp(x32.square().mean(dim=(0, 1, 2)) - mean.square(),
                      min=0.0)
    with torch.no_grad():
        new_mean = ((1.0 - momentum) * moving_mean.float()
                    + momentum * mean).to(moving_mean.dtype)
        new_var = ((1.0 - momentum) * moving_var.float()
                   + momentum * var).to(moving_var.dtype)
    return _normalize(x, gamma, beta, mean, var, eps), new_mean, new_var
