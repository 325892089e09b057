"""Hand-written CUDA kernels for Hopper, counterparts of ``cnn_tpu/ops/pallas``
(and, in ``resize.py``, of the native loader's ``cv::resize``).

Each wrapper takes its plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor, or raises; it counts its launches in
``<wrapper>.launches``, and those of each kernel variant beside it.

A CUDA graph replays launches without calling the wrappers, so their
counters do not move; ``counted_capture`` records what a capture would
have counted, and the graph's owner adds it per replay (``add_counters``).
"""

from cnn_tpu_torch.ops.hopper.augment import (launch_rotate,  # noqa: F401
                                              rotate_shear,
                                              rotate_tile_plan)
from cnn_tpu_torch.ops.hopper.conv import (BF16_STRIP_ROWS,  # noqa: F401
                                           BF16_STRIP_TILES, BF16_TILES,
                                           PW_TILES, STRIP_ROWS, TILES,
                                           TMA_TILES, WGMMA_TILES,
                                           conv2d_bias_relu,
                                           conv2d_bias_relu_fn,
                                           conv2d_bias_relu_op,
                                           conv_bf16_plan, conv_tile_plan,
                                           launch_conv_bf16)
from cnn_tpu_torch.ops.hopper.normalize import (launch_normalize,  # noqa: F401
                                                normalize_plan,
                                                uint8_normalize)
from cnn_tpu_torch.ops.hopper.pool import (launch_pool_bwd,  # noqa: F401
                                           launch_pool_fwd, max_pool2d_bwd,
                                           max_pool2d_fn, max_pool2d_fwd,
                                           pool_bwd_variant, pool_fwd_block,
                                           pool_fwd_variant)
from cnn_tpu_torch.ops.hopper.resize import (launch_resize,  # noqa: F401
                                             resize_batch_plain,
                                             resize_linear_u8)

# every counter of each wrapper: all its launches, then each variant's
COUNTERS = {
    uint8_normalize: ("launches", "launches_wide", "launches_bytes"),
    max_pool2d_fwd: ("launches", "launches_window", "launches_element",
                     "launches_bf16", "launches_bf16_window",
                     "launches_bf16_element"),
    max_pool2d_bwd: ("launches", "launches_window", "launches_element",
                     "launches_bf16"),
    conv2d_bias_relu: ("launches", "launches_strip", "launches_tiled",
                       "launches_pw", "launches_direct", "launches_bf16",
                       "launches_bf16_gather", "launches_bf16_vec",
                       "launches_bf16_strip", "launches_bf16_wgmma",
                       "launches_bf16_tma",
                       "launches_padded", "launches_1x1",
                       "launches_bf16_padded", "launches_bf16_1x1",
                       "launches_strip_padded",
                       "launches_bf16_strip_padded"),
    rotate_shear: ("launches",),
    resize_linear_u8: ("launches",),
}
_BY_NAME = {fn.__name__: fn for fn in COUNTERS}


def read_counters() -> dict[str, int]:
    """Every counter, keyed ``"<wrapper>.<counter>"``."""
    return {f"{fn.__name__}.{c}": getattr(fn, c)
            for fn, names in COUNTERS.items() for c in names}


def add_counters(delta: dict[str, int]) -> None:
    """Adds ``delta`` (keyed as ``read_counters``) to the counters."""
    for key, n in delta.items():
        name, counter = key.split(".")
        fn = _BY_NAME[name]
        setattr(fn, counter, getattr(fn, counter) + n)


def reset_launches() -> None:
    for fn, names in COUNTERS.items():
        for c in names:
            setattr(fn, c, 0)


def counted_capture(capture):
    """Calls ``capture()`` and takes back what its wrapper calls counted, as
    nothing ran: returns its result and the counters it moved (only the
    non-zero ones), which each replay of the captured work adds."""
    before = read_counters()
    out = capture()
    after = read_counters()
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    add_counters({k: -n for k, n in delta.items()})
    return out, delta
