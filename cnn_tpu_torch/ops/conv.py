"""VALID conv + bias (+ ReLU), NHWC / HWIO (plain version of the conv kernel).

Counterpart of ``cnn_tpu/ops/conv.py:conv2d`` and of
``cnn_tpu/ops/pallas/conv.py:_forward``. Follows the kernel's arithmetic:
k*k shifted [Ho*Wo, Cin] x [Cin, Cout] products summed in float32, then the
bias, then the optional ReLU. The CUDA kernel is ``ops/hopper/conv.py``.
"""

from __future__ import annotations

import torch


def conv_out_size(size: int, kernel: int, stride: int) -> int:
    """floor((H - k) / s) + 1, the VALID extent."""
    return (size - kernel) // stride + 1


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride: int = 2, relu: bool = False) -> torch.Tensor:
    """x [B,H,W,Cin], w [k,k,Cin,Cout], b [Cout] -> [B,Ho,Wo,Cout], float32."""
    bsz, h, wid, cin = x.shape
    k, cout = w.shape[0], w.shape[-1]
    ho, wo = conv_out_size(h, k, stride), conv_out_size(wid, k, stride)
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
    return acc.reshape(bsz, ho, wo, cout)
