"""Hand-written CUDA kernels for Hopper, counterparts of ``cnn_tpu/ops/pallas``.

Each wrapper takes its plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor, or raises; it counts its launches in
``<wrapper>.launches``.
"""

from cnn_tpu_torch.ops.hopper.conv import conv2d_bias_relu  # noqa: F401
from cnn_tpu_torch.ops.hopper.normalize import uint8_normalize  # noqa: F401
from cnn_tpu_torch.ops.hopper.pool import max_pool2d_fwd  # noqa: F401

WRAPPERS = (uint8_normalize, max_pool2d_fwd, conv2d_bias_relu)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
