"""Dense layer, counterpart of ``cnn_tpu/ops/linear.py``.

``w`` is [in, out], as in ``cnn_tpu``; trailing dims of ``x`` flatten in
NHWC order, so weights carry across without a permute. The product goes to
``torch.matmul``, as ``cnn_tpu`` leaves it to XLA.
"""

from __future__ import annotations

import torch


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, ..., in] -> [B, out]."""
    return x.reshape(x.shape[0], -1) @ w + b
