"""uint8 -> float preprocessing (plain version of the normalize kernel).

Counterpart of ``cnn_tpu/ops/preprocess.py``. The CUDA kernel is
``ops/hopper/normalize.py``. ``normalize`` (mean / std, the reference's BGR
statistics) and ``preprocess_batch`` (uint8 -> float, then optionally
``normalize``) are ``cnn_tpu``'s.
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


def normalize(x: torch.Tensor, mean=(0.406, 0.456, 0.485),
              std=(0.225, 0.224, 0.229)) -> torch.Tensor:
    """Channel-wise ``(x - mean) / std`` in ``x``'s dtype; the defaults are
    the reference's BGR statistics, as in ``cnn_tpu``."""
    mean = torch.tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def preprocess_batch(raw_uint8: torch.Tensor, dtype=torch.float32,
                     with_normalize: bool = False) -> torch.Tensor:
    """uint8 NHWC batch -> float NHWC batch in ``dtype``: the normalize
    kernel on a CUDA tensor (``ops/hopper/normalize.py:uint8_normalize``),
    ``uint8_to_float`` on a CPU one; then ``normalize`` if asked."""
    if raw_uint8.device.type == "cpu":
        x = uint8_to_float(raw_uint8, dtype)
    else:
        # imported here: the kernel's module imports this one
        from cnn_tpu_torch.ops.hopper.normalize import uint8_normalize
        x = uint8_normalize(raw_uint8, dtype)
    if with_normalize:
        x = normalize(x)
    return x
