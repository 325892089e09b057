"""Max pooling, NHWC and VALID, counterpart of ``cnn_tpu/ops/pool.py:
max_pool2d``, and the plain version of the 2x2 stride-2 pool kernel
(``cnn_tpu/ops/pallas/pool.py``, forward and backward).

``max_pool2d(x, kernel_size, stride)`` takes any window and stride, as
``lax.reduce_window`` does in ``cnn_tpu``: a window that does not fit is
cropped (the last rows and columns an extent leaves over). The tie rule
is XLA's select-and-scatter's: the first maximum in row-major window
order is the window's maximum and takes its cotangent, and where windows
overlap (stride < window) a pixel adds up the cotangents of every window
it is the maximum of. Ties matter after ReLU, where exact zeros tie. A
maximum is exact, so the forward is exact in any dtype.

2x2 at stride 2 runs ``max_pool2d_taps`` (the taps 00, 01, 10, 11 in that
order, the earliest of a tie kept), whose tap index the backward
``max_pool2d_bwd`` routes by: the plain version of the CUDA kernels in
``ops/hopper/pool.py``. Any other window has no kernel in ``cnn_tpu`` (it
is XLA's ``reduce_window`` there) and runs ``F.max_pool2d`` over the
channels-last view, on either device; its autograd keeps the index of the
first maximum of each window and adds the cotangents a pixel receives.

``avg_pool2d`` and ``global_avg_pool`` (no kernel in ``cnn_tpu``) sum in
float32 and return the input's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool2d_taps(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B,H,W,C] -> (max [B,H//2,W//2,C], tap index 0..3 as uint8)."""
    h2, w2 = x.shape[1] // 2, x.shape[2] // 2
    x = x[:, : 2 * h2, : 2 * w2]
    x00, x01 = x[:, 0::2, 0::2], x[:, 0::2, 1::2]
    x10, x11 = x[:, 1::2, 0::2], x[:, 1::2, 1::2]
    r0, r1 = x01 > x00, x11 > x10
    m0, m1 = torch.where(r0, x01, x00), torch.where(r1, x11, x10)
    down = m1 > m0
    i0 = r0.to(torch.uint8)
    i1 = r1.to(torch.uint8) + 2
    return torch.where(down, m1, m0), torch.where(down, i1, i0)


def max_pool2d(x: torch.Tensor, kernel_size: int = 2,
               stride: int = 2) -> torch.Tensor:
    """[B,H,W,C] -> [B,(H-k)//s+1,(W-k)//s+1,C] in x's dtype."""
    if (kernel_size, stride) == (2, 2):
        return max_pool2d_taps(x)[0]
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size, stride)
    return y.permute(0, 2, 3, 1)


def max_pool2d_bwd(tap: torch.Tensor, g: torch.Tensor, h: int,
                   w: int) -> torch.Tensor:
    """Cotangent g [B,H//2,W//2,C] through the taps -> dx [B,h,w,C].

    Each g goes to its window's recorded tap, zeros elsewhere and in the row
    and column an odd extent cropped (``_bwd_kernel``)."""
    b, h2, w2, c = g.shape
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    taps = [torch.where(tap == k, g, zero) for k in range(4)]
    top = torch.stack(taps[:2], dim=3)               # [B,h2,w2,2,C]
    bot = torch.stack(taps[2:], dim=3)
    dx = torch.stack([top, bot], dim=2).reshape(b, 2 * h2, 2 * w2, c)
    return F.pad(dx, (0, 0, 0, w - 2 * w2, 0, h - 2 * h2))


def avg_pool2d(x: torch.Tensor, kernel_size: int = 2,
               stride: int = 2) -> torch.Tensor:
    """NHWC average pooling, VALID: each window summed in float32, divided
    by its size, cast back to x's dtype (``cnn_tpu/ops/pool.py``)."""
    y = F.avg_pool2d(x.float().permute(0, 3, 1, 2), kernel_size, stride)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] -> [B,C], the spatial mean in float32, in x's dtype."""
    return x.float().mean(dim=(1, 2)).to(x.dtype)
