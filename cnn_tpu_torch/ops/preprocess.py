"""uint8 -> float preprocessing (plain version of the normalize kernel).

Counterpart of ``cnn_tpu/ops/preprocess.py``. The CUDA kernel is
``ops/hopper/normalize.py``.
"""

from __future__ import annotations

import torch


def uint8_to_float(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[.., H, W, C] uint8 -> ``dtype`` in [0, 1] by true division.

    Divides by a 0-d tensor on ``x``'s device rather than by a Python
    number: on CUDA, PyTorch turns division by a host scalar into a
    reciprocal multiply, which differs by 1 ulp for some byte values. The
    divisor is filled on the device (``torch.full``), not copied from the
    host, so that a CUDA graph can capture the call.

    Another ``dtype`` (bf16) is the float32 quotient rounded to it, which
    is ``cnn_tpu``'s ``uint8_to_float(x, jnp.bfloat16)`` bit for bit on all
    256 bytes.
    """
    return (x.float() / torch.full((), 255.0, device=x.device)).to(dtype)
