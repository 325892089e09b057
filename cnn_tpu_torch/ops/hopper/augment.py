"""Three-shear rotation of [B,S,S,C] canvases: wrapper of ``csrc/rotate.cu``.

Replaces ``cnn_tpu/ops/pallas/augment.py:rotate_shear_pallas``. The shift
vectors come from ``ops/augment.py:shift_vectors``, on the device, so the
kernel and the plain version (``rotate_core_plain``) shear by the same
amounts; the kernel's result is bit-identical to the plain version's.
"""

from __future__ import annotations

import torch

from cnn_tpu_torch.ops.augment import geometry, rotate_shear_plain, shift_vectors
from cnn_tpu_torch.ops.hopper._build import cuda_args, launch

DTYPES = (torch.float32, torch.bfloat16)


def rotate_shear(imgs: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotate the sampling coordinates of [B,S,S,C] float32 or bf16 canvases
    by ``theta[b]`` radians about the center. A CPU tensor takes the plain
    version."""
    if imgs.dim() != 4 or imgs.shape[1] != imgs.shape[2] \
            or theta.shape != imgs.shape[:1]:
        raise ValueError(f"rotate_shear: expects [B,S,S,C] and theta [B], got "
                         f"{tuple(imgs.shape)} and {tuple(theta.shape)}")
    if imgs.dtype not in DTYPES:
        raise TypeError(f"rotate_shear: expects float32 or bf16, got {imgs.dtype}")
    if imgs.device.type == "cpu":
        return rotate_shear_plain(imgs, theta)
    b, s, _, c = imgs.shape
    s1, s2, s3 = (v.contiguous() for v in shift_vectors(theta, s, c))
    stream = cuda_args("rotate_shear", imgs, s1, s2, s3,
                       dtypes=(imgs.dtype,) + (torch.float32,) * 3)
    g = geometry(s, c)
    out = torch.empty_like(imgs)
    launch("cnn_rotate_shear", imgs.device, stream, imgs.data_ptr(),
           s1.data_ptr(), s2.data_ptr(), s3.data_ptr(), out.data_ptr(), b, s,
           c, g.lane, g.pad_l, int(imgs.dtype == torch.bfloat16))
    rotate_shear.launches += 1
    return out


rotate_shear.launches = 0
