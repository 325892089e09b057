"""Host image augmentation in numpy, counterpart of ``cnn_tpu/data/augment.py``.

The reference's four ops (hflip p=.5, vflip p=.2, crop p=.7 with keep
ratio 0.7 + U(0, 0.25) at a uniform position, rotate p=.5 by U(15, 75)
degrees of random sign onto an expanded canvas) run in a shuffled order on
the decoded image, before the loader's resize. ``ImageAugmentor`` draws
from ``np.random.default_rng`` exactly as ``cnn_tpu``'s does (the
permutation, then per op ``uniform``, then the op's own ``uniform`` /
``integers``), so one generator gives the same ops, crops, angles and
flips in both packages.

``cnn_tpu`` rotates through ``cv2.getRotationMatrix2D`` and
``cv2.warpAffine``; the port has no cv2, so both are here in numpy:

- ``get_rotation_matrix_2d`` is cv2's float64 arithmetic (the centre as
  float32, as cv2's ``Point2f`` holds it), bit-equal to cv2's matrix.
- ``warp_affine`` is cv2 5.0's bilinear warp of uint8 images with a
  constant-0 border, in its float32 arithmetic (not the fixed-point
  interpolation of older cv2 releases): the matrix is inverted in float64
  and cast to float32; per output row ``rx = M1*y + M2`` and ``ry = M4*y +
  M5`` in float32 (two roundings each); per pixel ``sx = fma(M0, x, rx)``,
  ``sy = fma(M3, x, ry)``; ``ix = floor(sx)``, ``ax = sx - ix``; ``p0 =
  fma(ax, p01 - p00, p00)``, ``p1`` alike on the next row, ``v = fma(ay,
  p1 - p0, p0)``, rounded half to even and saturated; a tap outside the
  source reads 0. cv2 computes 16 columns at a time (its AVX-512 build)
  and the last ``w % 16`` columns of a row one by one, as ``sx =
  fma(x, M0, M1*y) + M2`` (``M1*y`` and the sum rounded to float32).
  An FMA is a float64 product and sum rounded once to float32. The tests
  hold the result bit-equal to ``cv2.warpAffine`` where cv2 runs that
  build, on every shape and angle they try.
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32
# the columns cv2 5.0's vectorised warp computes together (16 float32
# lanes of AVX-512); the w % BLOCK columns past the last whole block take
# its scalar tail
BLOCK = 16


def get_rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the 2x3 float64 matrix rotating by
    ``angle`` degrees (counter-clockwise) about ``center`` = (x, y), scaled
    by ``scale``."""
    cx, cy = (float(_F32(c)) for c in center)
    rad = angle * (np.pi / 180)
    a = np.cos(rad) * scale
    b = np.sin(rad) * scale
    return np.array([[a, b, (1 - a) * cx - b * cy],
                     [-b, a, b * cx + (1 - a) * cy]], np.float64)


def _invert(m: np.ndarray) -> np.ndarray:
    """The inverse of a 2x3 affine matrix in cv2's float64 order (its
    ``invertAffineTransform``), as 6 float32 values."""
    m0, m1, m2, m3, m4, m5 = (float(v) for v in np.asarray(m).reshape(6))
    d = m0 * m4 - m1 * m3
    d = 1.0 / d if d != 0 else 0.0
    a0, a1, a3, a4 = m4 * d, m1 * -d, m3 * -d, m0 * d
    return np.array([a0, a1, -a0 * m2 - a1 * m5, a3, a4, -a3 * m2 - a4 * m5],
                    _F32)


def _fma(a, b, c) -> np.ndarray:
    """``a * b + c`` rounded once to float32 (float64 product and sum)."""
    return (np.asarray(a, np.float64) * b + c).astype(_F32)


def _source_coords(mi: np.ndarray, w: int, h: int):
    """Each output pixel's source point ``(sx, sy)``, float32 [h, w]."""
    m0, m1, m2, m3, m4, m5 = mi
    y = np.arange(h, dtype=_F32)[:, None]
    x = np.arange(w, dtype=_F32)[None, :]
    sx = _fma(m0, x, m1 * y + m2)
    sy = _fma(m3, x, m4 * y + m5)
    tail = w - w % BLOCK
    if tail < w:
        xt = x[:, tail:]
        sx[:, tail:] = _fma(xt, m0, m1 * y) + m2
        sy[:, tail:] = _fma(xt, m3, m4 * y) + m5
    return sx, sy


def warp_affine(img: np.ndarray, m: np.ndarray,
                dsize: tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize)`` for a uint8 [H,W,C] image:
    bilinear, constant-0 border, ``dsize`` = (width, height); the module
    docstring gives the arithmetic."""
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"warp_affine takes uint8 HxWxC images, got "
                         f"{img.dtype} {img.shape}")
    w, h = dsize
    src_h, src_w, c = img.shape
    sx, sy = _source_coords(_invert(m), w, h)
    fx, fy = np.floor(sx), np.floor(sy)
    out = np.zeros((h * w, c), np.uint8)
    # only pixels with a tap inside the source: the others read 4 zeros
    sel = np.flatnonzero((fx >= -1) & (fx < src_w) & (fy >= -1)
                         & (fy < src_h))
    fx, fy = fx.ravel()[sel], fy.ravel()[sel]
    ax = (sx.ravel()[sel] - fx).astype(np.float64)[:, None]
    ay = (sy.ravel()[sel] - fy).astype(np.float64)[:, None]
    # a 1-pixel zero frame holds the taps at -1 and W (or H)
    pad = np.zeros((src_h + 2, src_w + 2, c), np.uint8)
    pad[1:-1, 1:-1] = img
    flat = pad.reshape(-1, c)
    top = (fy.astype(np.int64) + 1) * (src_w + 2) + fx.astype(np.int64) + 1

    def tap(offset):
        return np.take(flat, top + offset, axis=0).astype(_F32)

    p00, p01 = tap(0), tap(1)
    p10, p11 = tap(src_w + 2), tap(src_w + 3)
    p0 = _fma(ax, p01 - p00, p00)
    p1 = _fma(ax, p11 - p10, p10)
    v = _fma(ay, p1 - p0, p0)
    out[sel] = np.clip(np.rint(v), 0, 255)
    return out.reshape(h, w, c)


def rotate_expand(img: np.ndarray, angle_deg: float) -> np.ndarray:
    """Rotate without cropping (expand canvas) — reference
    pipeline.cpp:23-33; ``cnn_tpu``'s ``rotate_expand``."""
    h, w = img.shape[:2]
    center = ((w - 1) / 2.0, (h - 1) / 2.0)
    rot = get_rotation_matrix_2d(center, angle_deg, 1.0)
    cos, sin = abs(rot[0, 0]), abs(rot[0, 1])
    new_w = int(h * sin + w * cos)
    new_h = int(h * cos + w * sin)
    rot[0, 2] += new_w / 2.0 - w / 2.0
    rot[1, 2] += new_h / 2.0 - h / 2.0
    return warp_affine(img, rot, (new_w, new_h))


class ImageAugmentor:
    DEFAULT_OPS = (("hflip", 0.5), ("vflip", 0.2), ("crop", 0.7),
                   ("rotate", 0.5))

    def __init__(self, ops=DEFAULT_OPS, seed: int = 212):
        self.ops = list(ops)
        self.rng = np.random.default_rng(seed)

    def __call__(self, img: np.ndarray,
                 rng: np.random.Generator | None = None) -> np.ndarray:
        """Augment one image. Pass ``rng`` for thread-safe deterministic use
        (the loader derives one per (seed, epoch, sample)). An op fires
        when ``U(0, 1) >= 1 - p``."""
        rng = rng if rng is not None else self.rng
        order = rng.permutation(len(self.ops))
        for idx in order:
            name, p = self.ops[idx]
            if rng.uniform() < 1.0 - p:
                continue
            if name == "hflip":
                img = img[:, ::-1]
            elif name == "vflip":
                img = img[::-1]
            elif name == "crop":
                h, w = img.shape[:2]
                ratio = 0.7 + rng.uniform(0.0, 0.25)
                ch, cw = int(h * ratio), int(w * ratio)
                y0 = rng.integers(0, h - ch + 1)
                x0 = rng.integers(0, w - cw + 1)
                img = img[y0:y0 + ch, x0:x0 + cw]
            elif name == "rotate":
                angle = rng.uniform(15.0, 75.0)
                if rng.integers(1, 11) & 1:
                    angle = -angle
                img = rotate_expand(np.ascontiguousarray(img), angle)
            else:
                raise ValueError(f"unknown augment op '{name}'")
        return img
