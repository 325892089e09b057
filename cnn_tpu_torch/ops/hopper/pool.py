"""2x2 stride-2 max pool, forward and backward: wrappers of ``csrc/pool.cu``.

Replaces ``cnn_tpu/ops/pallas/pool.py``: ``_fwd_call`` (``max_pool2d_fwd``)
and ``_bwd_call`` (``max_pool2d_bwd``), and its ``custom_vjp``
(``max_pool2d_fn``, a ``torch.autograd.Function``). The tap index is the
forward's 2-bit window argmax, kept as uint8 (``cnn_tpu`` stores int32).

Two kernels compute the backward: one thread per pooled window and 4
channels (``cnn_maxpool2x2_bwd_window``) where C % 4 == 0 and g and the
tap allow its 16- and 4-byte loads, and one thread per dx element
(``cnn_maxpool2x2_bwd``) for the rest; ``pool_bwd_variant`` chooses by
shape and alignment alone. Both only route values and give the same bits.
"""

from __future__ import annotations

import torch

from cnn_tpu_torch.ops import pool as plain
from cnn_tpu_torch.ops.hopper._build import cuda_args, launch


def max_pool2d_fwd(x: torch.Tensor, with_tap: bool = False):
    """[B,H,W,C] float32 -> max [B,H//2,W//2,C], and the tap index (uint8)
    when ``with_tap``. A CPU tensor takes the plain version."""
    if x.dim() != 4:
        raise ValueError(f"max_pool2d_fwd: expects [B,H,W,C], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        out, tap = plain.max_pool2d_taps(x)
        return (out, tap) if with_tap else out
    stream = cuda_args("max_pool2d_fwd", x, dtypes=(torch.float32,))
    b, h, w, c = x.shape
    if h < 2 or w < 2:
        raise ValueError(f"max_pool2d_fwd: extent {h}x{w} is below the window")
    out = torch.empty((b, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    tap = (torch.empty(out.shape, dtype=torch.uint8, device=x.device)
           if with_tap else None)
    launch("cnn_maxpool2x2_fwd", x.device, stream, x.data_ptr(),
           out.data_ptr(), tap.data_ptr() if with_tap else None, b, h, w, c)
    max_pool2d_fwd.launches += 1
    return (out, tap) if with_tap else out


max_pool2d_fwd.launches = 0


def pool_bwd_variant(b: int, h2: int, w2: int, c: int,
                     aligned: bool) -> str:
    """"window" when C % 4 == 0, g is 16-byte and the tap 4-byte aligned
    (``aligned``) and there is a window to own the output; else
    "element"."""
    return "window" if c % 4 == 0 and aligned and b * h2 * w2 > 0 \
        else "element"


def _check_bwd(tap, g, h, w):
    if g.dim() != 4 or tap.shape != g.shape:
        raise ValueError(f"max_pool2d_bwd: tap {tuple(tap.shape)} and g "
                         f"{tuple(g.shape)} must be one [B,H2,W2,C] shape")
    if h // 2 != g.shape[1] or w // 2 != g.shape[2]:
        raise ValueError(f"max_pool2d_bwd: extent {h}x{w} does not pool to "
                         f"{g.shape[1]}x{g.shape[2]}")


def launch_pool_bwd(tap: torch.Tensor, g: torch.Tensor, h: int, w: int,
                    variant: str) -> torch.Tensor:
    """Launches the ``variant`` backward kernel ("window" or "element") on
    CUDA tensors; counts nothing."""
    _check_bwd(tap, g, h, w)
    stream = cuda_args("max_pool2d_bwd", tap, g,
                       dtypes=(torch.uint8, torch.float32))
    b, _, _, c = g.shape
    dx = torch.empty((b, h, w, c), dtype=g.dtype, device=g.device)
    name = {"window": "cnn_maxpool2x2_bwd_window",
            "element": "cnn_maxpool2x2_bwd"}[variant]
    launch(name, g.device, stream, tap.data_ptr(), g.data_ptr(),
           dx.data_ptr(), b, h, w, c)
    return dx


def max_pool2d_bwd(tap: torch.Tensor, g: torch.Tensor, h: int,
                   w: int) -> torch.Tensor:
    """g [B,h//2,w//2,C] float32 through the uint8 taps -> dx [B,h,w,C],
    bit-identical to ``ops/pool.py:max_pool2d_bwd``. A CPU tensor takes the
    plain version."""
    _check_bwd(tap, g, h, w)
    if g.device.type == "cpu":
        return plain.max_pool2d_bwd(tap, g, h, w)
    b, h2, w2, c = g.shape
    variant = pool_bwd_variant(b, h2, w2, c, g.data_ptr() % 16 == 0
                               and tap.data_ptr() % 4 == 0)
    dx = launch_pool_bwd(tap, g, h, w, variant)
    if variant == "window":
        max_pool2d_bwd.launches_window += 1
    else:
        max_pool2d_bwd.launches_element += 1
    max_pool2d_bwd.launches += 1
    return dx


max_pool2d_bwd.launches = 0            # every launch, either kernel
max_pool2d_bwd.launches_window = 0
max_pool2d_bwd.launches_element = 0


class MaxPool2dFn(torch.autograd.Function):
    """Max pool whose forward keeps the uint8 tap and whose backward runs
    the backward kernel (``cnn_tpu``'s ``_vjp_fwd`` / ``_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, x):
        out, tap = max_pool2d_fwd(x, with_tap=True)
        ctx.save_for_backward(tap)
        ctx.extent = x.shape[1], x.shape[2]
        return out

    @staticmethod
    def backward(ctx, g):
        (tap,) = ctx.saved_tensors
        return max_pool2d_bwd(tap, g.contiguous(), *ctx.extent)


def max_pool2d_fn(x: torch.Tensor) -> torch.Tensor:
    """Differentiable 2x2 max pool through the two kernels."""
    return MaxPool2dFn.apply(x)
