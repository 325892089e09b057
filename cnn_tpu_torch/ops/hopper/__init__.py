"""Hand-written CUDA kernels for Hopper, counterparts of ``cnn_tpu/ops/pallas``.

Each wrapper takes its plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor, or raises; it counts its launches in
``<wrapper>.launches``.
"""

from cnn_tpu_torch.ops.hopper.augment import (launch_rotate,  # noqa: F401
                                              rotate_shear,
                                              rotate_tile_plan)
from cnn_tpu_torch.ops.hopper.conv import (STRIP_ROWS,  # noqa: F401
                                           TILES, conv2d_bias_relu,
                                           conv2d_bias_relu_fn,
                                           conv_tile_plan)
from cnn_tpu_torch.ops.hopper.normalize import uint8_normalize  # noqa: F401
from cnn_tpu_torch.ops.hopper.pool import (launch_pool_bwd,  # noqa: F401
                                           max_pool2d_bwd, max_pool2d_fn,
                                           max_pool2d_fwd, pool_bwd_variant)

WRAPPERS = (uint8_normalize, max_pool2d_fwd, max_pool2d_bwd, conv2d_bias_relu,
            rotate_shear)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    conv2d_bias_relu.launches_strip = conv2d_bias_relu.launches_tiled = 0
    conv2d_bias_relu.launches_direct = 0
    max_pool2d_bwd.launches_window = max_pool2d_bwd.launches_element = 0
