"""uint8 -> float32 normalize: wrapper of ``csrc/normalize.cu``.

Replaces ``cnn_tpu/ops/pallas/normalize.py:uint8_normalize_pallas``.

``normalize_plan`` chooses the kernel's variant, grid, head and tail from
the length and the two pointers: "wide" (16-byte loads) where some element
has its input byte and its output float both 16-byte aligned, else "bytes"
(chunks aligned on the output, read as the 4-byte words that hold them and
shifted into place). The previous design,
``cnn_normalize_u8_direct``, is on no path: ``launch_normalize(...,
direct=True)`` reaches it for comparisons.

The Pallas kernel is uint8 -> float32 only; a bf16 compute dtype
(``uint8_normalize(x, torch.bfloat16)``) runs this kernel and rounds its
output to bf16, which is ``cnn_tpu``'s ``uint8_to_float(x, jnp.bfloat16)``
bit for bit.

``uint8_normalize_op`` is the wrapper as a PyTorch operator
(``torch.ops.cnn_tpu_torch.uint8_normalize``) with a fake version, so that
``torch.export`` records the kernel's call by name: while a program is
exported the wrapper goes through it (``export.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cnn_tpu_torch.ops.hopper._build import cuda_args, launch
from cnn_tpu_torch.ops.preprocess import uint8_to_float

THREADS = 256
BLOCKS_PER_SM = 8      # __launch_bounds__(256, 8) in csrc/normalize.cu
H100_SMS = 132
WAVE = H100_SMS * BLOCKS_PER_SM   # blocks resident at once
CHUNK = 16             # elements a chunk: one 16-byte load, four float4 stores
UNROLL = 2             # chunks a thread has in flight
VARIANTS = ("wide", "bytes")   # the entry point's variant argument


class NormalizePlan(NamedTuple):
    variant: str   # "wide" or "bytes"
    blocks: int
    head: int      # elements converted one at a time before the first chunk
    tail: int      # and after the last


def normalize_plan(n: int, x_ptr: int, y_ptr: int) -> NormalizePlan:
    """The launch of ``cnn_normalize_u8`` for ``n`` elements from the uint8
    address ``x_ptr`` to the float32 address ``y_ptr``.

    Chunks start at the first element whose byte and float are both 16-byte
    aligned, which exists iff (4 * x - y) % 16 == 0 ("wide"); else at the
    first float that is ("bytes"). Blocks: enough for one trip of UNROLL
    chunks a thread when that is less than a wave, else whole waves, each
    thread taking at least one full trip.
    """
    if y_ptr % 4:
        raise ValueError(f"normalize: float32 output at {y_ptr:#x} is not "
                         "4-byte aligned")
    if (4 * x_ptr - y_ptr) % 16 == 0:
        variant, head = "wide", (-x_ptr) % 16
    else:
        variant, head = "bytes", ((-y_ptr) % 16) // 4
    head = min(head, n)
    chunks = (n - head) // CHUNK
    per_block = THREADS * UNROLL      # chunks a block takes in one trip
    if chunks <= WAVE * per_block:
        blocks = max(1, -(-chunks // per_block))
    else:
        blocks = WAVE * (chunks // (WAVE * per_block))
    return NormalizePlan(variant, blocks, head, n - head - CHUNK * chunks)


def launch_normalize(x: torch.Tensor, y: torch.Tensor | None = None,
                     direct: bool = False) -> tuple[torch.Tensor, str]:
    """Converts the CUDA uint8 ``x`` into ``y`` (float32 of its shape,
    allocated when None) with the plan's kernel, or the previous design if
    ``direct``; returns ``y`` and the variant launched. Counts nothing."""
    if y is None:
        stream = cuda_args("uint8_normalize", x, dtypes=(torch.uint8,))
        y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    else:
        stream = cuda_args("uint8_normalize", x, y,
                           dtypes=(torch.uint8, torch.float32))
        if y.shape != x.shape:
            raise ValueError(f"normalize: y {tuple(y.shape)} is not x's "
                             f"{tuple(x.shape)}")
    if direct:
        launch("cnn_normalize_u8_direct", x.device, stream, x.data_ptr(),
               y.data_ptr(), x.numel())
        return y, "direct"
    plan = normalize_plan(x.numel(), x.data_ptr(), y.data_ptr())
    launch("cnn_normalize_u8", x.device, stream, x.data_ptr(), y.data_ptr(),
           x.numel(), VARIANTS.index(plan.variant), plan.blocks, plan.head)
    return y, plan.variant


def uint8_normalize(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[..] uint8 -> [..] x / 255 in float32, then rounded to ``dtype``:
    bit-identical to ``uint8_to_float(x, dtype)``.

    A CPU tensor takes the plain version; a CUDA tensor the kernel.
    """
    if torch.compiler.is_exporting():
        return uint8_normalize_op(x).to(dtype)
    if x.device.type == "cpu":
        return uint8_to_float(x, dtype)
    y, variant = launch_normalize(x)
    counter = f"launches_{variant}"
    setattr(uint8_normalize, counter, getattr(uint8_normalize, counter) + 1)
    uint8_normalize.launches += 1
    return y.to(dtype)


uint8_normalize.launches = 0           # every launch, either variant
uint8_normalize.launches_wide = 0
uint8_normalize.launches_bytes = 0


@torch.library.custom_op("cnn_tpu_torch::uint8_normalize", mutates_args=())
def uint8_normalize_op(x: torch.Tensor) -> torch.Tensor:
    """``uint8_normalize(x)`` (float32) as an operator: the kernel on a
    CUDA tensor, the plain version on a CPU one."""
    return uint8_normalize(x)


@uint8_normalize_op.register_fake
def _(x):
    return x.new_empty(x.shape, dtype=torch.float32)
