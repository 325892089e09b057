"""Tensor utility ops, counterpart of ``cnn_tpu/ops/tensor.py``: the
reference ``Tensor3D`` helpers its main paths never call (``div``,
``rot180``, ``pad2d``, ``argmax_flat``), and ``minmax_normalize``, the
Grad-CAM normalization (``tools/gradcam.py`` uses it). NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def div(x: torch.Tensor, times) -> torch.Tensor:
    """Elementwise division (reference Tensor3D::div)."""
    return x / times


def rot180(x: torch.Tensor) -> torch.Tensor:
    """Each spatial plane rotated by 180 degrees: H and W flipped."""
    return torch.flip(x, dims=(-3, -2))


def pad2d(x: torch.Tensor, padding: int = 1, value: float = 0.0) -> torch.Tensor:
    """Symmetric spatial pad with ``value`` (reference Tensor3D::pad)."""
    return F.pad(x, (0, 0, padding, padding, padding, padding), value=value)


def argmax_flat(x: torch.Tensor) -> torch.Tensor:
    """Flat argmax over the whole tensor: an index into the row-major
    buffer (reference Tensor3D::argmax)."""
    return torch.argmax(x.reshape(-1))


def minmax_normalize(x: torch.Tensor) -> torch.Tensor:
    """(x - min) / (max - min); a constant input (zero range) maps to
    zeros, not NaN."""
    lo, hi = x.min(), x.max()
    return (x - lo) / torch.clamp(hi - lo, min=1e-12)
