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

The batch's ``E[x]`` and ``E[x^2]`` come from float64 sums (one float64
pass, ``_Moments``), each rounded to float32 once: so they are the same
float32 bits however the batch is split (the float64 sums of two orders
round alike, but for a value within about 1e-12 of a rounding boundary),
and a sharded step normalizes exactly as one process does. Float32 sums
in another order would move their last bits, and with them, at a batch of
256, a few ReLU masks and pool taps at near-ties, which move the
gradients by about 1e-3 of their size. The sums' backward stays in
float32.

On a mesh whose batch shards over ``'data'`` and whose image rows shard
over ``'spatial'`` the statistics are the global batch's over all its
rows, as in ``cnn_tpu``'s GSPMD step: each rank's per-channel sums of
``x`` and ``x^2`` and its count of pixels are summed over both axes
(differentiably, ``parallel/collectives.py:psum``) before the mean and the
variance, so the moving statistics agree on every rank and with one
process's. The counts are summed, not assumed: row strips can be uneven
(111 rows over two ranks) or empty.
"""

from __future__ import annotations

import torch


def _normalize(x, gamma, beta, mean, var, eps):
    inv = gamma.float() * torch.reciprocal(torch.sqrt(var + eps))
    y = x.float() * inv + (beta.float() - mean * inv)
    return y.to(x.dtype)


class _Moments(torch.autograd.Function):
    """x [..., C] float32 -> [3, C] float64: per channel the sum of x, the
    sum of x^2 and the count, from one float64 pass (``torch.var_mean``);
    the backward in float32, ``g_sum + 2 x g_sq``."""

    @staticmethod
    def forward(ctx, x32):
        ctx.save_for_backward(x32)
        flat = x32.reshape(-1, x32.shape[-1])
        n = flat.shape[0]
        if n == 0:      # a strip with no rows here
            return flat.new_zeros((3, flat.shape[1]), dtype=torch.float64)
        var, mean = torch.var_mean(flat.double(), dim=0, correction=0)
        return torch.stack([mean * n, (var + mean * mean) * n,
                            torch.full_like(mean, n)])

    @staticmethod
    def backward(ctx, g):
        (x32,) = ctx.saved_tensors
        g = g.float()
        return torch.addcmul(g[0], x32, 2.0 * g[1])


def batch_norm2d_eval(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, mean: torch.Tensor,
                      var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """NHWC; the statistics broadcast over the last (channel) axis."""
    return _normalize(x, gamma, beta, mean.float(), var.float(), eps)


def batch_norm2d_train(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, moving_mean: torch.Tensor,
                       moving_var: torch.Tensor, eps: float = 1e-5,
                       momentum: float = 0.1, mesh=None):
    """NHWC, batch statistics, over ``mesh``'s ``'data'`` and
    ``'spatial'`` axes where it has them. Returns ``(y, new_mean,
    new_var)``; the new moving statistics are detached and keep the moving
    statistics' dtype."""
    sums = _Moments.apply(x.float())
    for axis in ("data", "spatial"):
        if mesh is not None and mesh.active(axis):
            sums = mesh.psum(sums, axis)
    mean, sq = (sums[0] / sums[2]).float(), (sums[1] / sums[2]).float()
    var = torch.clamp(sq - mean.square(), min=0.0)
    with torch.no_grad():
        new_mean = ((1.0 - momentum) * moving_mean.float()
                    + momentum * mean).to(moving_mean.dtype)
        new_var = ((1.0 - momentum) * moving_var.float()
                   + momentum * var).to(moving_var.dtype)
    return _normalize(x, gamma, beta, mean, var, eps), new_mean, new_var
