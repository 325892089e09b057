"""2x2 stride-2 max pool forward: wrapper of ``csrc/pool.cu``.

Replaces ``cnn_tpu/ops/pallas/pool.py:_fwd_call``. The tap index is the
kernel's 2-bit window argmax, kept as uint8 (``cnn_tpu`` stores int32); the
pool backward that reads it is still to be ported.
"""

from __future__ import annotations

import torch

from cnn_tpu_torch.ops.hopper._build import cuda_args, launch
from cnn_tpu_torch.ops.pool import max_pool2d_taps


def max_pool2d_fwd(x: torch.Tensor, with_tap: bool = False):
    """[B,H,W,C] float32 -> max [B,H//2,W//2,C], and the tap index (uint8)
    when ``with_tap``. A CPU tensor takes the plain version."""
    if x.dim() != 4:
        raise ValueError(f"max_pool2d_fwd: expects [B,H,W,C], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        out, tap = max_pool2d_taps(x)
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
