"""Conv + bias (+ ReLU), NHWC / HWIO (plain version of the conv kernels),
and the depthwise conv.

Counterpart of ``cnn_tpu/ops/conv.py:conv2d`` and of
``cnn_tpu/ops/pallas/conv.py:_forward``. Follows the kernel's arithmetic:
k*k shifted [Ho*Wo, Cin] x [Cin, Cout] products summed in float32, then the
bias, then the optional ReLU. ``padding`` zero-pads the input symmetrically
first, as ``cnn_tpu``'s ``Conv2D(padding=)`` (an XLA conv there; the Pallas
kernel is VALID only): a tap in the padding adds a zero product.

In bf16 (x, w and b all bf16) it follows ``_conv_kernel``'s bf16 path: each
tap's product is taken in float32 from the bf16 values (exact: a product of
two 8-bit significands fits in float32's 24), the taps are summed in
float32 in tap order, the bias is read into float32 and added, then the
optional ReLU, then one rounding to bf16. The CUDA kernels are
``ops/hopper/conv.py``.

``depthwise_conv2d`` is ``cnn_tpu``'s XLA grouped conv
(``feature_group_count=C``), which no Pallas kernel replaces: here it is
ATen's grouped convolution (``DepthwiseConvFn``), float32 with TF32 off,
and in bf16 XLA's order: the conv rounded to bf16, then a bf16 bias added.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn import grad as nn_grad


def conv_out_size(size: int, kernel: int, stride: int,
                  padding: int = 0) -> int:
    """floor((H - k + 2p) / s) + 1."""
    return (size - kernel + 2 * padding) // stride + 1


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride: int = 2, relu: bool = False,
           padding: int = 0) -> torch.Tensor:
    """x [B,H,W,Cin], w [k,k,Cin,Cout], b [Cout] -> [B,Ho,Wo,Cout] in x's
    dtype: float32, or bf16 summed in float32 and rounded once."""
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    bsz, h, wid, cin = x.shape
    k, cout = w.shape[0], w.shape[-1]
    ho, wo = conv_out_size(h, k, stride), conv_out_size(wid, k, stride)
    out_dtype = x.dtype
    if out_dtype == torch.bfloat16:
        x, w, b = x.float(), w.float(), b.float()
    acc = torch.zeros(bsz * ho * wo, cout, dtype=x.dtype, device=x.device)
    for dy in range(k):
        for dx in range(k):
            patch = x[:, dy:dy + stride * (ho - 1) + 1:stride,
                      dx:dx + stride * (wo - 1) + 1:stride, :]
            acc = acc + patch.reshape(-1, cin) @ w[dy, dx]
    acc = acc + b
    if relu:
        acc = torch.where(acc > 0, acc, torch.zeros((), dtype=acc.dtype,
                                                    device=acc.device))
    return acc.reshape(bsz, ho, wo, cout).to(out_dtype)


class DepthwiseConvFn(torch.autograd.Function):
    """ATen's grouped conv (groups = C) on NHWC / HWIO views, forward and
    backward with cuDNN's TF32 off whatever the global setting, as
    ``cnn_tpu`` runs its float32 convs at ``Precision.HIGHEST``."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        with torch.backends.cudnn.flags(allow_tf32=False):
            y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                         stride=stride, padding=padding, groups=x.shape[-1])
        return y.permute(0, 2, 3, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        x_nchw, w_oihw = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
        g_nchw = g.permute(0, 3, 1, 2)
        dx = dw = None
        kw = {"stride": ctx.stride, "padding": ctx.padding,
              "groups": x.shape[-1]}
        with torch.backends.cudnn.flags(allow_tf32=False):
            if ctx.needs_input_grad[0]:
                dx = nn_grad.conv2d_input(x_nchw.shape, w_oihw, g_nchw, **kw)
                dx = dx.permute(0, 2, 3, 1).contiguous()
            if ctx.needs_input_grad[1]:
                dw = nn_grad.conv2d_weight(x_nchw, w_oihw.shape, g_nchw, **kw)
                dw = dw.permute(2, 3, 1, 0).contiguous()
        return dx, dw, None, None


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     stride: int = 1, padding: int = 0,
                     channel_multiplier: int | None = None) -> torch.Tensor:
    """x [B,H,W,C], w [k,k,1,C*mult], b [C*mult] -> [B,Ho,Wo,C*mult]:
    output channel ``g*mult + m`` reads input channel ``g`` only. x, w and b
    in one dtype; bf16 rounds the conv, then adds the bias in bf16.

    ``channel_multiplier``: the layer's own; ``w.shape[3] == C * mult`` is
    checked exactly (an input with half the channels would still divide
    ``w.shape[3]``), as ``cnn_tpu`` does."""
    channels = x.shape[-1]
    if w.shape[2] != 1 or w.shape[3] % channels:
        raise ValueError(f"depthwise filter bank {tuple(w.shape)} does not "
                         f"fit {channels} input channels")
    if (channel_multiplier is not None
            and w.shape[3] != channels * channel_multiplier):
        raise ValueError(
            f"depthwise filter bank {tuple(w.shape)} was built for "
            f"{w.shape[3] // channel_multiplier} channels x mult "
            f"{channel_multiplier}; input has {channels} channels")
    return DepthwiseConvFn.apply(x, w, stride, padding) + b
