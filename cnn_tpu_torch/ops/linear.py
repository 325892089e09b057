"""Dense layer, counterpart of ``cnn_tpu/ops/linear.py``.

``w`` is [in, out], as in ``cnn_tpu``; trailing dims of ``x`` flatten in
NHWC order, so weights carry across without a permute. The product goes to
``torch.matmul``, as ``cnn_tpu`` leaves it to XLA.

Under a compute dtype (bf16) ``x`` and ``w`` are cast to it and the bias to
the product's dtype, as ``cnn_tpu``'s ``linear(compute_dtype=)`` does. A
bf16 product in ``cnn_tpu`` sums in float32; cuBLAS may sum split-K
partials in bf16 while
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` is
True (PyTorch's default), so the port's bf16 products, forward and
backward, run with it off (``full_precision_reduction``).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_precision_reduction():
    """cuBLAS's bf16 products sum in float32 inside the block, whatever the
    global setting, which is restored after."""
    flags = torch.backends.cuda.matmul
    before = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_bf16_reduced_precision_reduction = before


class _Bf16MatmulFn(torch.autograd.Function):
    """``x @ w`` (2-d, or batched over a leading axis) whose forward and
    backward products sum in float32."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with full_precision_reduction():
            return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        with full_precision_reduction():
            if ctx.needs_input_grad[0]:
                dx = g @ w.mT
            if ctx.needs_input_grad[1]:
                dw = x.mT @ g
        return dx, dw


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in their dtype; bf16 products sum in float32, forward and
    backward (``full_precision_reduction``)."""
    if x.dtype == torch.bfloat16:
        return _Bf16MatmulFn.apply(x, w)
    return x @ w


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           compute_dtype=None) -> torch.Tensor:
    """[B, ..., in] -> [B, out], in ``compute_dtype`` when given."""
    x = x.reshape(x.shape[0], -1)
    if compute_dtype is None or compute_dtype == torch.float32:
        return x @ w + b
    out = matmul(x.to(compute_dtype), w.to(compute_dtype))
    return out + b.to(out.dtype)
