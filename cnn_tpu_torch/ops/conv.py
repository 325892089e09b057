"""VALID conv + bias (+ ReLU), NHWC / HWIO (plain version of the conv kernels).

Counterpart of ``cnn_tpu/ops/conv.py:conv2d`` and of
``cnn_tpu/ops/pallas/conv.py:_forward``. Follows the kernel's arithmetic:
k*k shifted [Ho*Wo, Cin] x [Cin, Cout] products summed in float32, then the
bias, then the optional ReLU.

In bf16 (x, w and b all bf16) it follows ``_conv_kernel``'s bf16 path: each
tap's product is taken in float32 from the bf16 values (exact: a product of
two 8-bit significands fits in float32's 24), the taps are summed in
float32 in tap order, the bias is read into float32 and added, then the
optional ReLU, then one rounding to bf16. The CUDA kernels are
``ops/hopper/conv.py``.
"""

from __future__ import annotations

import torch


def conv_out_size(size: int, kernel: int, stride: int) -> int:
    """floor((H - k) / s) + 1, the VALID extent."""
    return (size - kernel) // stride + 1


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride: int = 2, relu: bool = False) -> torch.Tensor:
    """x [B,H,W,Cin], w [k,k,Cin,Cout], b [Cout] -> [B,Ho,Wo,Cout] in x's
    dtype: float32, or bf16 summed in float32 and rounded once."""
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
