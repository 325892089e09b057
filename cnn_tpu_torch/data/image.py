"""Image decode and resize on the host, the port's replacement for the
``cv2.imread`` and ``cv2.resize`` calls of ``cnn_tpu/data/loader.py``.

``imread(path)`` returns what ``cv2.imread(path)`` returns for a colour
image: a BGR uint8 [H,W,3] array; ``imdecode(data)`` the same for encoded
bytes, as ``cv2.imdecode`` (None where they do not decode). A binary PPM (P6, maxval 255) is decoded
in numpy; every other format through PIL, imported at the first such call
(baseline JPEG and PNG decode bit-equal to ``cv2.imread``; the EXIF
orientation is applied, as ``cv2.imread`` does). A file that neither can
read raises ``IOError("unreadable image: ...")``, where ``cnn_tpu`` maps
``cv2.imread``'s None to the same error.

``resize(img, (w, h))`` is ``cv2.resize(img, (w, h))`` for uint8 images,
bilinear (INTER_LINEAR), in cv2's fixed-point arithmetic:
- per output column ``fx = (x + 0.5) * sw / dw - 0.5`` in float32,
  ``sx = floor(fx)``, 11-bit weights ``c0 = round((1 - f) * 2048)``,
  ``c1 = round(f * 2048)``; a column past either edge is clamped to the
  edge with ``f = 0``;
- the horizontal pass in integers, ``S[sx] * c0 + S[sx + 1] * c1``;
- per output row the same weights, but only the source rows are clamped
  (the weights keep their fraction), then
  ``v = ((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16)`` and the output
  ``(v + 2) >> 2``.
The row rule is cv2's own: where both rows clamp to the same edge row of
an upscale, the two floors of the sum can lose one grey level against the
row itself, and so does cv2. An exact 2x downscale (which cv2 runs as
INTER_AREA) gives the same values. The tests hold it bit-equal to
``cv2.resize`` on downscales and upscales alike.

``apply_colormap_jet(u8)`` is ``cv2.applyColorMap(u8, cv2.COLORMAP_JET)``
and ``imwrite(path, img)`` writes a PNG that ``cv2.imread`` reads back as
``img``, as ``cv2.imwrite`` does; the two serve Grad-CAM's heatmaps.
"""

from __future__ import annotations

import functools
import struct
import zlib

import numpy as np

_COEF_SCALE = 2048      # cv2's INTER_RESIZE_COEF_SCALE (11 bits)


def _ppm_token(data: bytes, pos: int) -> tuple[bytes, int]:
    """The next header token of a PNM file from ``pos``, skipping
    whitespace and ``#`` comments; returns it and the position after it."""
    n = len(data)
    while pos < n:
        c = data[pos:pos + 1]
        if c == b"#":
            while pos < n and data[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
        elif c.isspace():
            pos += 1
        else:
            break
    end = pos
    while end < n and not data[end:end + 1].isspace() \
            and data[end:end + 1] != b"#":
        end += 1
    return data[pos:end], end


def _decode_p6(data: bytes):
    """A binary PPM with maxval 255 as BGR uint8, or None for any other
    PNM variant (those go to PIL)."""
    tokens, pos = [], 2
    for _ in range(3):
        tok, pos = _ppm_token(data, pos)
        if not tok.isdigit():
            return None
        tokens.append(int(tok))
    w, h, maxval = tokens
    if maxval != 255 or w < 1 or h < 1:
        return None
    pos += 1     # the single whitespace byte that ends the header
    body = np.frombuffer(data, np.uint8, count=h * w * 3, offset=pos) \
        if len(data) - pos >= h * w * 3 else None
    if body is None:
        return None
    return np.ascontiguousarray(body.reshape(h, w, 3)[:, :, ::-1])


def _decode_pil(path: str, data: bytes) -> np.ndarray:
    try:
        from PIL import Image, ImageOps, UnidentifiedImageError
    except ImportError as e:
        raise ImportError(
            f"cannot decode {path}: it is not a binary PPM (P6, maxval 255) "
            "and PIL, the decoder for every other format, is not "
            "installed") from e
    import io
    try:
        with Image.open(io.BytesIO(data)) as im:
            im = ImageOps.exif_transpose(im)
            rgb = np.asarray(im.convert("RGB"))
    except (UnidentifiedImageError, OSError, ValueError, SyntaxError) as e:
        raise IOError(f"unreadable image: {path}") from e
    return np.ascontiguousarray(rgb[:, :, ::-1])


def _decode(what: str, data: bytes) -> np.ndarray:
    if data[:2] == b"P6":
        img = _decode_p6(data)
        if img is not None:
            return img
    return _decode_pil(what, data)


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path)``: BGR uint8 [H,W,3]; raises ``IOError`` for a
    missing or unreadable file."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise IOError(f"unreadable image: {path}") from e
    return _decode(path, data)


def imdecode(data: bytes):
    """``cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)``:
    the encoded image ``data`` as BGR uint8 [H,W,3], or None where it does
    not decode (the TCP server's frames)."""
    try:
        return _decode("<bytes>", bytes(data))
    except IOError:
        return None


def _taps(src: int, dst: int, clamp_weights: bool):
    """cv2's INTER_LINEAR taps along one axis: (i0, i1, c0, c1), int32."""
    scale = 1.0 / (np.float64(dst) / np.float64(src))   # cv2: 1 / inv_scale
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = (f - i0.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        edge = (i0 < 0) | (i0 >= src - 1)
        f[edge] = 0.0
        i0 = np.clip(i0, 0, src - 1)
    c0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE))
    c1 = np.rint(f * np.float32(_COEF_SCALE))
    i1 = np.clip(i0 + 1, 0, src - 1)
    i0 = np.clip(i0, 0, src - 1)
    return (i0.astype(np.int32), i1.astype(np.int32), c0.astype(np.int32),
            c1.astype(np.int32))


@functools.lru_cache(maxsize=256)
def tap_tables(sh: int, sw: int, dh: int, dw: int) -> tuple[np.ndarray,
                                                            np.ndarray]:
    """cv2's INTER_LINEAR taps of a resize from ``sh`` x ``sw`` to ``dh`` x
    ``dw``: the columns' [4, dw] and the rows' [4, dh] int32 tables, each
    row of a table (i0, i1, c0, c1) (module docstring: the columns'
    weights clamp at the edges, the rows' keep their fraction). ``resize``,
    ``ops/hopper/resize.py``'s kernel and its plain version all read
    these; read-only, shared between calls."""
    xt = np.stack(_taps(sw, dw, clamp_weights=True))
    yt = np.stack(_taps(sh, dh, clamp_weights=False))
    for t in (xt, yt):
        t.flags.writeable = False
    return xt, yt


def resize(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size)`` (``size`` = (width, height)) for a uint8
    [H,W] or [H,W,C] image, bilinear (module docstring)."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize takes uint8 images, not {img.dtype}")
    dw, dh = int(size[0]), int(size[1])
    sh, sw = img.shape[:2]
    if (dw, dh) == (sw, sh):
        return img.copy()
    (x0, x1, a0, a1), (y0, y1, b0, b1) = tap_tables(sh, sw, dh, dw)
    s = img.astype(np.int32)
    extra = (1,) * (img.ndim - 2)
    a0 = a0.reshape(1, dw, *extra)
    a1 = a1.reshape(1, dw, *extra)

    def horizontal(rows):
        r = s[rows]
        return r[:, x0] * a0 + r[:, x1] * a1

    h0 = horizontal(y0) >> 4
    h1 = horizontal(y1) >> 4
    b0 = b0.reshape(dh, 1, *extra)
    b1 = b1.reshape(dh, 1, *extra)
    v = ((h0 * b0) >> 16) + ((h1 * b1) >> 16)
    # C order, as cv2 returns it (the gathers above leave another)
    return np.ascontiguousarray(((v + 2) >> 2).astype(np.uint8))


def _jet_table() -> np.ndarray:
    """cv2's COLORMAP_JET as a [256, 3] BGR uint8 table.

    Channel k (1 blue, 2 green, 3 red) is the trapezoid
    ``255 * clip(1.5 - |4x - k|, 0, 1)`` at ``x = i / 255``: it rises from
    0 at ``x = (k - 1.5) / 4`` to 255 at ``(k - 0.5) / 4``, holds, and
    falls to 0 at ``(k + 1.5) / 4`` (blue starts at half, red ends at
    half). cv2 samples it in float32 and rounds half to even; its float32
    lands just below the half at blue's entry 159, which it rounds down.
    """
    i4 = 4 * np.arange(256)
    # 255 * (1.5 - |4x - k|) = 382.5 - |4i - 255k|, exact in float64
    table = np.stack([np.clip(np.rint(382.5 - np.abs(i4 - 255 * k)), 0, 255)
                      for k in (1, 2, 3)], axis=1)
    table[159, 0] = 1
    return table.astype(np.uint8)


_JET = _jet_table()


def apply_colormap_jet(img: np.ndarray) -> np.ndarray:
    """``cv2.applyColorMap(img, cv2.COLORMAP_JET)`` for a uint8 [H,W]
    image: BGR uint8 [H,W,3]."""
    if img.dtype != np.uint8 or img.ndim != 2:
        raise TypeError(f"apply_colormap_jet takes a uint8 [H,W] image, "
                        f"not {img.dtype} {img.shape}")
    return _JET[img]


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def imwrite(path: str, img: np.ndarray) -> None:
    """Writes a BGR uint8 [H,W,3] image (cv2's layout) as an 8-bit RGB PNG,
    rows unfiltered, zlib level 6: the same bytes for the same array."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise TypeError(f"imwrite takes a uint8 [H,W,3] image, not "
                        f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + 3 * w), np.uint8)     # each row: filter 0
    rows[:, 1:] = img[:, :, ::-1].reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
           + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + _png_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
