"""2x2 stride-2 max pool, forward and backward, float32 and bf16: wrappers
of ``csrc/pool.cu``.

Replaces ``cnn_tpu/ops/pallas/pool.py``: ``_fwd_call`` (``max_pool2d_fwd``)
and ``_bwd_call`` (``max_pool2d_bwd``), and its ``custom_vjp``
(``max_pool2d_fn``, a ``torch.autograd.Function``). The tap index is the
forward's 2-bit window argmax, kept as uint8 (``cnn_tpu`` stores int32).
Values keep their dtype, as ``_fwd_call`` and ``_bwd_call`` keep
``x.dtype`` and ``g.dtype``.

Two kernels compute the forward in either dtype, and ``pool_fwd_variant``
chooses by shape, dtype and alignment alone: the window kernel
(``cnn_maxpool2x2_fwd_window[_bf16]``: one thread per pooled pixel and 16
bytes of channels, four 16-byte loads, one 16-byte store of y and one of
its taps, in blocks of ``pool_fwd_block``) where C is a multiple of 4
(float32) or 8 (bf16) and x is 16-byte aligned (every AlexNet and VGG
pool), and the element kernel (``cnn_maxpool2x2_fwd[_bf16]``, one thread
per output element) for the rest. Its bound is bytes: x's covered rows
read once, y and the tap written once.

Two kernels compute the float32 backward: one thread per pooled window and
4 channels (``cnn_maxpool2x2_bwd_window``) where C % 4 == 0 and g and the
tap allow its 16- and 4-byte loads, and one thread per dx element
(``cnn_maxpool2x2_bwd``) for the rest; ``pool_bwd_variant`` chooses by
shape and alignment alone. In bf16 the window backward runs its bf16
instance (``cnn_maxpool2x2_bwd_window_bf16``); a bf16 backward the window
kernel cannot take (C % 4 != 0, g not 8-byte aligned) raises. All the
kernels only compare and route values: each variant gives the same bits.

Each wrapper counts every launch in ``launches``, its bf16 launches in
``launches_bf16``, and each variant's: ``launches_window`` /
``launches_element`` count the float32 kernels, the forward's
``launches_bf16_window`` / ``launches_bf16_element`` its bf16 ones.
``launch_pool_fwd`` and ``launch_pool_bwd`` launch a named variant without
counting, for comparisons.

The kernels take the 2x2 window at stride 2 only, as the Pallas kernel
does: ``nn/module.py:MaxPool2D`` sends that window here and any other to
the plain op (``ops/pool.py:max_pool2d``), as ``cnn_tpu`` runs every
other window through XLA. On a CUDA tensor each wrapper here launches its
kernel or raises; only a CPU tensor takes the plain version.

``max_pool2d_fwd_op`` is the forward without the tap as a PyTorch operator
(``torch.ops.cnn_tpu_torch.max_pool2d_fwd``) with a fake version, so that
``torch.export`` records the kernel's call by name: while a program is
exported the wrapper goes through it (``export.py``).
"""

from __future__ import annotations

import torch

from cnn_tpu_torch.ops import pool as plain
from cnn_tpu_torch.ops.hopper._build import cuda_args, launch


BF16 = torch.bfloat16


def pool_fwd_variant(b: int, h2: int, w2: int, c: int, bf16: bool,
                     aligned: bool) -> str:
    """"window" when C is a multiple of the channels in 16 bytes (8 in bf16,
    4 in float32), x is 16-byte aligned (``aligned``; the wrapper's y is)
    and there is a window to pool; else "element"."""
    return "window" if c % (8 if bf16 else 4) == 0 and aligned \
        and b * h2 * w2 > 0 else "element"


def pool_fwd_block(b: int, h2: int, w2: int, c: int,
                   bf16: bool) -> tuple[int, int, int]:
    """The window forward's block (tx, ty) and its number of blocks: tx
    threads on a pooled row's W2 * G groups of 16 bytes (rounded up to a
    warp, at most 512; a thread strides by tx over more), ty pooled rows a
    block, so that a block has about 256 threads."""
    n = w2 * (c // (8 if bf16 else 4))
    tx = min(512, -(-n // 32) * 32)
    rows = b * h2
    ty = max(1, min(256 // tx, rows))
    return tx, ty, -(-rows // ty)


def launch_pool_fwd(x: torch.Tensor, with_tap: bool, variant: str):
    """Launches the ``variant`` forward kernel ("window" or "element") on a
    CUDA tensor, float32 or bf16; returns y and the tap (None without
    ``with_tap``); counts nothing."""
    bf16 = x.dtype == BF16
    stream = cuda_args("max_pool2d_fwd", x,
                       dtypes=(BF16 if bf16 else torch.float32,))
    b, h, w, c = x.shape
    if h < 2 or w < 2:
        raise ValueError(f"max_pool2d_fwd: extent {h}x{w} is below the window")
    out = torch.empty((b, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    tap = (torch.empty(out.shape, dtype=torch.uint8, device=x.device)
           if with_tap else None)
    name = {"window": "cnn_maxpool2x2_fwd_window",
            "element": "cnn_maxpool2x2_fwd"}[variant] + ("_bf16" if bf16
                                                         else "")
    args = (x.data_ptr(), out.data_ptr(),
            tap.data_ptr() if with_tap else None, b, h, w, c)
    if variant == "window":
        args += pool_fwd_block(b, h // 2, w // 2, c, bf16)[:2]
    launch(name, x.device, stream, *args)
    return out, tap


def max_pool2d_fwd(x: torch.Tensor, with_tap: bool = False):
    """[B,H,W,C] float32 or bf16 -> max [B,H//2,W//2,C] in x's dtype, and
    the tap index (uint8) when ``with_tap``. A CPU tensor takes the plain
    version."""
    if x.dim() != 4:
        raise ValueError(f"max_pool2d_fwd: expects [B,H,W,C], got {tuple(x.shape)}")
    if torch.compiler.is_exporting() and not with_tap:
        return max_pool2d_fwd_op(x)
    if x.device.type == "cpu":
        out, tap = plain.max_pool2d_taps(x)
        return (out, tap) if with_tap else out
    b, h, w, c = x.shape
    bf16 = x.dtype == BF16
    variant = pool_fwd_variant(b, h // 2, w // 2, c, bf16,
                               x.data_ptr() % 16 == 0)
    out, tap = launch_pool_fwd(x, with_tap, variant)
    counter = f"launches_bf16_{variant}" if bf16 else f"launches_{variant}"
    setattr(max_pool2d_fwd, counter, getattr(max_pool2d_fwd, counter) + 1)
    if bf16:
        max_pool2d_fwd.launches_bf16 += 1
    max_pool2d_fwd.launches += 1
    return (out, tap) if with_tap else out


max_pool2d_fwd.launches = 0               # every launch, either dtype
max_pool2d_fwd.launches_window = 0        # the float32 kernels
max_pool2d_fwd.launches_element = 0
max_pool2d_fwd.launches_bf16 = 0          # the bf16 kernels
max_pool2d_fwd.launches_bf16_window = 0
max_pool2d_fwd.launches_bf16_element = 0


@torch.library.custom_op("cnn_tpu_torch::max_pool2d_fwd", mutates_args=())
def max_pool2d_fwd_op(x: torch.Tensor) -> torch.Tensor:
    """``max_pool2d_fwd(x)`` as an operator: the kernel on a CUDA tensor,
    the plain version on a CPU one."""
    return max_pool2d_fwd(x)


@max_pool2d_fwd_op.register_fake
def _(x):
    b, h, w, c = x.shape
    return x.new_empty((b, h // 2, w // 2, c))


def pool_bwd_variant(b: int, h2: int, w2: int, c: int,
                     aligned: bool) -> str:
    """"window" when C % 4 == 0, g's 4 channels (16 bytes in float32, 8 in
    bf16) and the tap's 4 bytes are aligned (``aligned``) and there is a
    window to own the output; else "element" (float32 only)."""
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
    CUDA tensors, float32 or (window only) bf16; counts nothing."""
    _check_bwd(tap, g, h, w)
    bf16 = g.dtype == BF16
    stream = cuda_args("max_pool2d_bwd", tap, g,
                       dtypes=(torch.uint8, BF16 if bf16 else torch.float32))
    if bf16 and variant != "window":
        raise ValueError("max_pool2d_bwd: bf16 runs the window kernel only, "
                         "which needs C % 4 == 0, g 8-byte and the tap "
                         "4-byte aligned")
    b, _, _, c = g.shape
    dx = torch.empty((b, h, w, c), dtype=g.dtype, device=g.device)
    name = {"window": "cnn_maxpool2x2_bwd_window",
            "element": "cnn_maxpool2x2_bwd"}[variant] + ("_bf16" if bf16
                                                         else "")
    launch(name, g.device, stream, tap.data_ptr(), g.data_ptr(),
           dx.data_ptr(), b, h, w, c)
    return dx


def max_pool2d_bwd(tap: torch.Tensor, g: torch.Tensor, h: int,
                   w: int) -> torch.Tensor:
    """g [B,h//2,w//2,C] float32 or bf16 through the uint8 taps -> dx
    [B,h,w,C] in g's dtype, bit-identical to ``ops/pool.py:max_pool2d_bwd``.
    A CPU tensor takes the plain version."""
    _check_bwd(tap, g, h, w)
    if g.device.type == "cpu":
        return plain.max_pool2d_bwd(tap, g, h, w)
    b, h2, w2, c = g.shape
    variant = pool_bwd_variant(b, h2, w2, c,
                               g.data_ptr() % (4 * g.element_size()) == 0
                               and tap.data_ptr() % 4 == 0)
    dx = launch_pool_bwd(tap, g, h, w, variant)
    if g.dtype == BF16:
        max_pool2d_bwd.launches_bf16 += 1
    elif variant == "window":
        max_pool2d_bwd.launches_window += 1
    else:
        max_pool2d_bwd.launches_element += 1
    max_pool2d_bwd.launches += 1
    return dx


max_pool2d_bwd.launches = 0            # every launch, any kernel
max_pool2d_bwd.launches_window = 0     # the float32 kernels
max_pool2d_bwd.launches_element = 0
max_pool2d_bwd.launches_bf16 = 0       # the bf16 window kernel


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
