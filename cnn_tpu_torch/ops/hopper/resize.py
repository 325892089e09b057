"""Batched cv2-exact bilinear resize: wrapper of ``csrc/resize.cu``.

Replaces no Pallas kernel: it is the ``cv::resize`` of ``cnn_tpu``'s native
loader (``csrc/dataloader.cpp:28``), which ``data/native.py`` runs for a
whole batch in one launch after decoding on the host.

A batch is *packed* into one flat uint8 buffer, so that it reaches the card
in one copy: per image its (offset, height, width) as int64 (``meta``
[n, 3]), its column and row taps as int32 (``xtab`` / ``ytab`` [n, 4, s],
``data/image.py:tap_tables``), then the source images back to back, HWC
uint8 (``src``). ``pack_layout`` places the four sections (16-byte aligned),
``pack_into`` fills a buffer, ``unpack`` views any buffer of that layout, on
the host or on the card, as a ``Packed``.

``resize_linear_u8(p)`` is the wrapper: the kernel on CUDA tensors, counted
in ``resize_linear_u8.launches``; ``resize_batch_plain(p)``, the plain
version, on CPU tensors. ``launch_resize`` launches the kernel without
counting, for comparisons.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from cnn_tpu_torch.ops.hopper._build import cuda_args, launch

MAX_GRID_YZ = 65535    # the kernel's grid: y the output row, z the image


class Packed(NamedTuple):
    src: torch.Tensor    # uint8 [bytes]: the images, HWC, back to back
    meta: torch.Tensor   # int64 [n, 3]: offset into src, height, width
    xtab: torch.Tensor   # int32 [n, 4, size]: (i0, i1, c0, c1) per column
    ytab: torch.Tensor   # int32 [n, 4, size]: the same per row
    size: int            # the output's height and width


class Layout(NamedTuple):
    n: int
    size: int
    offsets: tuple       # each image's offset into the src section
    meta_at: int         # byte offsets of the four sections in the buffer
    xtab_at: int
    ytab_at: int
    src_at: int
    nbytes: int          # the buffer's bytes in use


def _align(v: int, m: int = 16) -> int:
    return -(-v // m) * m


def pack_layout(shapes: Sequence[tuple], size: int) -> Layout:
    """Where a batch of HWC uint8 images of ``shapes`` (each (H, W, 3))
    lies in a packed buffer for a resize to ``size`` x ``size``."""
    n = len(shapes)
    if not 1 <= size <= MAX_GRID_YZ or n > MAX_GRID_YZ:
        raise ValueError(f"resize: {n} images to {size} px is out of the "
                         f"kernel's grid ({MAX_GRID_YZ} rows, images)")
    offsets, total = [], 0
    for shape in shapes:
        if len(shape) != 3 or shape[2] != 3 or min(shape) < 1:
            raise ValueError(f"resize takes HWC images of 3 channels, not "
                             f"{tuple(shape)}")
        offsets.append(total)
        total += shape[0] * shape[1] * 3
    meta_at = 0
    xtab_at = _align(meta_at + 8 * 3 * n)
    ytab_at = _align(xtab_at + 4 * 4 * size * n)
    src_at = _align(ytab_at + 4 * 4 * size * n)
    return Layout(n, size, tuple(offsets), meta_at, xtab_at, ytab_at, src_at,
                  src_at + total)


def unpack(buf: torch.Tensor, layout: Layout) -> Packed:
    """The four sections of the flat uint8 ``buf`` as tensors (views)."""
    n, s = layout.n, layout.size

    def section(at, count, dtype, shape):
        width = torch.empty((), dtype=dtype).element_size()
        return buf[at:at + count * width].view(dtype).view(shape)

    return Packed(buf[layout.src_at:layout.nbytes],
                  section(layout.meta_at, 3 * n, torch.int64, (n, 3)),
                  section(layout.xtab_at, 4 * s * n, torch.int32, (n, 4, s)),
                  section(layout.ytab_at, 4 * s * n, torch.int32, (n, 4, s)),
                  s)


def pack_into(buf: torch.Tensor, images: Sequence[np.ndarray],
              layout: Layout) -> Packed:
    """Writes ``images`` (HWC uint8 numpy) and their taps into the CPU
    uint8 tensor ``buf`` (at least ``layout.nbytes``); returns its views."""
    # imported here: the data package imports this package
    from cnn_tpu_torch.data.image import tap_tables
    p = unpack(buf, layout)
    meta = p.meta.numpy()
    xtab, ytab, src = p.xtab.numpy(), p.ytab.numpy(), p.src.numpy()
    s = layout.size
    for b, (img, off) in enumerate(zip(images, layout.offsets)):
        h, w = img.shape[:2]
        meta[b] = (off, h, w)
        xtab[b], ytab[b] = tap_tables(h, w, s, s)
        src[off:off + img.size] = np.ascontiguousarray(img).reshape(-1)
    return p


def pack(images: Sequence[np.ndarray], size: int) -> Packed:
    """``images`` packed into a new CPU buffer."""
    layout = pack_layout([im.shape for im in images], size)
    buf = torch.empty(layout.nbytes, dtype=torch.uint8)
    return pack_into(buf, images, layout)


def to_device(p: Packed, device) -> Packed:
    """``p``'s tensors copied to ``device`` (for comparisons: the loader
    copies its packed buffer whole)."""
    return Packed(*(t.to(device) for t in p[:4]), p.size)


def resize_batch_plain(p: Packed) -> torch.Tensor:
    """uint8 [n, size, size, 3]: each image resized with its taps in
    ``data/image.py:resize``'s integer arithmetic, on ``p``'s device."""
    n, s = p.meta.shape[0], p.size
    out = torch.empty((n, s, s, 3), dtype=torch.uint8, device=p.src.device)
    for b, (off, h, w) in enumerate(p.meta.tolist()):
        img = p.src[off:off + h * w * 3].view(h, w, 3).to(torch.int32)
        x0, x1, a0, a1 = p.xtab[b].long()
        y0, y1, b0, b1 = p.ytab[b].long()
        a0, a1 = a0.view(1, s, 1), a1.view(1, s, 1)

        def horizontal(rows):
            r = img[rows]
            return r[:, x0] * a0 + r[:, x1] * a1

        h0 = horizontal(y0) >> 4
        h1 = horizontal(y1) >> 4
        v = ((h0 * b0.view(s, 1, 1)) >> 16) + ((h1 * b1.view(s, 1, 1)) >> 16)
        out[b] = ((v + 2) >> 2).to(torch.uint8)
    return out


def launch_resize(p: Packed, out: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel on the CUDA tensors of ``p`` into ``out`` (uint8 [n, s,
    s, 3], allocated when None), on the current stream. Counts nothing."""
    n, s = p.meta.shape[0], p.size
    if out is None:
        out = torch.empty((n, s, s, 3), dtype=torch.uint8,
                          device=p.src.device)
    stream = cuda_args("resize_linear_u8", p.src, p.meta, p.xtab, p.ytab, out,
                       dtypes=(torch.uint8, torch.int64, torch.int32,
                               torch.int32, torch.uint8))
    if out.shape != (n, s, s, 3) or p.xtab.shape != (n, 4, s) \
            or p.ytab.shape != (n, 4, s) or p.meta.shape != (n, 3):
        raise ValueError(f"resize: out {tuple(out.shape)}, taps "
                         f"{tuple(p.xtab.shape)} / {tuple(p.ytab.shape)} "
                         f"and meta {tuple(p.meta.shape)} do not fit {n} "
                         f"images to {s} px")
    if n:
        launch("cnn_resize_linear_u8", p.src.device, stream,
               p.src.data_ptr(), p.meta.data_ptr(), p.xtab.data_ptr(),
               p.ytab.data_ptr(), out.data_ptr(), n, s)
    return out


def resize_linear_u8(p: Packed, out: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """uint8 [n, size, size, 3], the batch ``p`` resized, bit-identical to
    ``resize_batch_plain(p)`` (and to ``cv2.resize`` of each image).

    CPU tensors take the plain version; CUDA tensors the kernel.
    """
    if p.src.device.type == "cpu":
        y = resize_batch_plain(p)
        return y if out is None else out.copy_(y)
    y = launch_resize(p, out)
    resize_linear_u8.launches += 1
    return y


resize_linear_u8.launches = 0
