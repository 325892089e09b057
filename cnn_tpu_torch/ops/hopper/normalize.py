"""uint8 -> float32 normalize: wrapper of ``csrc/normalize.cu``.

Replaces ``cnn_tpu/ops/pallas/normalize.py:uint8_normalize_pallas``.
"""

from __future__ import annotations

import torch

from cnn_tpu_torch.ops.hopper._build import cuda_args, launch
from cnn_tpu_torch.ops.preprocess import uint8_to_float


def uint8_normalize(x: torch.Tensor) -> torch.Tensor:
    """[..] uint8 -> [..] float32 x / 255, bit-identical to ``uint8_to_float``.

    A CPU tensor takes the plain version; a CUDA tensor the kernel.
    """
    if x.device.type == "cpu":
        return uint8_to_float(x)
    stream = cuda_args("uint8_normalize", x, dtypes=(torch.uint8,))
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    launch("cnn_normalize_u8", x.device, stream, x.data_ptr(), y.data_ptr(),
           x.numel())
    uint8_normalize.launches += 1
    return y


uint8_normalize.launches = 0
