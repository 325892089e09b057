"""Device-side batched augmentation, counterpart of ``cnn_tpu/ops/augment.py``
and of the plain twin of ``cnn_tpu/ops/pallas/augment.py``.

The reference policy (hflip p=.5, vflip p=.2, random crop p=.7 with keep
ratio U[0.7, 0.95], rotate p=.5 by +-U[15, 75] degrees) runs on the device
as banded-matmul resamples and a three-shear rotation. Each policy is split
into a *draw* (``draw_full`` / ``draw_fast``: the random parameters, from an
explicit ``torch.Generator``) and an *apply* (``apply_full`` /
``apply_fast``: the deterministic function of the images and those
parameters), so the port's apply can be held against ``cnn_tpu``'s helpers
on the same parameters; threefry and Philox give different bits.

- ``apply_full`` (``augment_batch``): place (flips and the 1/f pre-shrink,
  f = |cos| + |sin|, as two banded matmuls) -> rotate (the rotation kernel,
  ``ops/hopper/augment.py:rotate_shear``) -> crop and resize (two banded
  matmuls). A uint8 input is divided by 255 elementwise first.
- ``apply_fast`` (``augment_batch_fast``): flips, crop and resize as two
  banded matmuls, with the /255 folded into the row matrix; no rotation.

The banded resamples are plain batched products (``torch.matmul``), as
``cnn_tpu`` leaves them to XLA; they run in the policy's ``dtype``: float32,
with TF32 off unless the caller turned it on, or bf16, summed in float32
(``ops/linear.py:full_precision_reduction``), as XLA's bf16 dot does.

``rotate_shear_plain`` is the plain version of the rotation kernel: the
same three shears as ``_rotate_core``, each a direct gather of its two taps.

``batch_mix`` (MixUp / CutMix) and ``color_jitter`` are split the same way
(``draw_mix`` / ``apply_mix``, ``draw_jitter`` / ``apply_jitter``); they
are elementwise PyTorch, as ``cnn_tpu`` leaves them to XLA.

Per-image draws on a sharded batch (``shard_draws(index, count)``, which
the sharded train steps enter): each rank holds shard ``index`` of
``count`` equal shards of the global batch and draws, from a generator in
the same state on every rank, the parameters of the whole global batch,
keeping its own images'. So the shards together are augmented as the
single-device step augments the global batch.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import NamedTuple

import torch

from cnn_tpu_torch.ops.linear import full_precision_reduction


# ---------------------------------------------------------------------------
# rotation: geometry and the plain three-shear version
# ---------------------------------------------------------------------------

def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def shear_bounds(s: int) -> tuple[int, int, int]:
    """Max |shift| in px per shear for content pre-shrunk by 1/f:
    tan(th/2)*h, sin(th)*h*(1+tan(th/2)), tan(th/2)*h*f, maximized over
    th in [15, 75] deg with h = s/(2f)."""
    return int(0.313 * s) + 2, int(0.696 * s) + 2, int(0.384 * s) + 2


class Geometry(NamedTuple):
    """``cnn_tpu``'s padded working canvas: ``pad_l`` pixels of padding left
    of the image along a row, ``lane`` padded row elements (C per pixel);
    ``pad_s`` rows above, ``sub`` rows in all."""
    s: int
    c: int
    sub: int
    lane: int
    pad_s: int
    pad_l: int


def geometry(s: int, c: int) -> Geometry:
    p1, p2, p3 = shear_bounds(s)
    pad_l = max(p1, p3) + 1
    pad_s = p2 + 1
    return Geometry(s, c, _round_up(s + 2 * pad_s + 1, 8),
                    _round_up((s + 2 * pad_l + 1) * c, 128), pad_s, pad_l)


def shift_vectors(theta: torch.Tensor, s: int, c: int):
    """Per-image shifts of the three shears, float32: s1, s3 [B,S] per row,
    s2 [B,L] per padded lane, by the lane's true pixel coordinate."""
    g = geometry(s, c)
    p1, p2, p3 = shear_bounds(s)
    dev = theta.device
    theta = theta.float()
    cy = (s - 1) / 2.0
    d = (torch.arange(s, dtype=torch.float32, device=dev) - cy)[None, :]
    m = -torch.tan(theta / 2.0)[:, None]
    n = torch.sin(theta)[:, None]
    px = torch.div(torch.arange(g.lane, device=dev) - g.pad_l * c, c,
                   rounding_mode="floor")
    dl = (px.float() - cy)[None, :]
    return (torch.clamp(m * d, -p1, p1), torch.clamp(n * dl, -p2, p2),
            torch.clamp(m * d, -p3, p3))


def _split(shifts: torch.Tensor, dtype):
    k = torch.floor(shifts)
    return k.long(), (shifts - k).to(dtype)


def _blend(x0, x1, a):
    """x0 * (1 - a) + x1 * a, each operation rounded to the data type."""
    return x0 * (1 - a) + x1 * a


def _lane_shear(x: torch.Tensor, shifts: torch.Tensor, c: int) -> torch.Tensor:
    """out[b,r,u] = blend(x[b,r,u+c*k], x[b,r,u+c*k+c]), 0 where a tap
    leaves the padded row (only wrap-around junk is masked, not the window)."""
    lane = x.shape[2]
    k, a = _split(shifts, x.dtype)
    src = torch.arange(lane, device=x.device) + c * k[:, :, None]
    ok = (src >= 0) & (src + c < lane)
    t0 = x.gather(2, src.clamp(0, lane - 1))
    t1 = x.gather(2, (src + c).clamp(0, lane - 1))
    return torch.where(ok, _blend(t0, t1, a[:, :, None]),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _row_shear(x: torch.Tensor, shifts: torch.Tensor, pad: int) -> torch.Tensor:
    """out[b,r,u] = blend(x[b,r+k,u], x[b,r+k+1,u]) over the S rows, rows
    outside the image being zero; |k| < pad, so no source wraps."""
    b, s, lane = x.shape
    k, a = _split(shifts, x.dtype)
    xp = torch.zeros((b, s + 2 * pad + 1, lane), dtype=x.dtype,
                     device=x.device)
    xp[:, pad:pad + s] = x
    q = torch.arange(s, device=x.device)[None, :, None] + (k[:, None, :] + pad)
    return _blend(xp.gather(1, q), xp.gather(1, q + 1), a[:, None, :])


def rotate_core_plain(imgs: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor,
                      s3: torch.Tensor) -> torch.Tensor:
    """The three shears of ``_rotate_core`` on given shift vectors."""
    b, s, _, c = imgs.shape
    g = geometry(s, c)
    plc = g.pad_l * c
    x = torch.zeros((b, s, g.lane), dtype=imgs.dtype, device=imgs.device)
    x[:, :, plc:plc + s * c] = imgs.reshape(b, s, s * c)
    x = _lane_shear(x, s1, c)
    x = _row_shear(x, s2, g.pad_s)
    x = _lane_shear(x, s3, c)
    return x[:, :, plc:plc + s * c].reshape(b, s, s, c)


def rotate_shear_plain(imgs: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotate the sampling coordinates of [B,S,S,C] canvases (float32 or
    bf16) by ``theta[b]`` radians about the center; content must be
    pre-shrunk by 1/f, as ``apply_full`` does. Port of ``rotate_shear_xla``."""
    b, s, s2_, c = imgs.shape
    if s != s2_:
        raise ValueError(f"rotate_shear: square canvases expected, got {s}x{s2_}")
    return rotate_core_plain(imgs, *shift_vectors(theta, s, c))


# ---------------------------------------------------------------------------
# banded-matmul resampling
# ---------------------------------------------------------------------------

def resample_matrix(s: int, out_size: int, span: torch.Tensor,
                    off: torch.Tensor, flip: torch.Tensor, gain: float = 1.0,
                    clamp: bool = False) -> torch.Tensor:
    """[B,out,S] 2-tap bilinear row weights, ``src = off + (j+.5)*span/out
    - .5``, mirrored where ``flip``; ``clamp`` pins the taps inside the crop
    window ``[off, off+span-1]`` and renormalizes the rows. Batched
    ``_resample_matrix``."""
    dev = span.device
    grid = torch.arange(out_size, dtype=torch.float32, device=dev)[None, :]
    taps = torch.arange(s, dtype=torch.float32, device=dev)
    span, off = span.float()[:, None], off.float()[:, None]
    src = off + (grid + 0.5) * (span / out_size) - 0.5
    if clamp:
        src = torch.minimum(torch.maximum(src, off), off + span - 1.0)
    src = torch.where(flip[:, None], (s - 1.0) - src, src)
    w = torch.clamp(1.0 - torch.abs(taps[None, None, :] - src[:, :, None]),
                    min=0.0)
    if clamp:
        w = w / torch.clamp(w.sum(dim=2, keepdim=True), min=1e-6)
    return gain * w


def matmul_resample(x: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Per-image row and column weights: [B,S,S,C] -> [B,Oy,Ox,C]."""
    b, s, _, c = x.shape
    x, wy, wx = x.to(dtype), wy.to(dtype), wx.to(dtype)
    oy, ox = wy.shape[1], wx.shape[1]
    with full_precision_reduction():
        v = torch.matmul(wy, x.reshape(b, s, s * c)).reshape(b, oy, s, c)
        h = torch.matmul(wx, v.transpose(1, 2).reshape(b, s, oy * c))
    return h.reshape(b, ox, oy, c).transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# the policies: draw and apply
# ---------------------------------------------------------------------------

class FullParams(NamedTuple):
    """Per-image draws of the full policy ([B] each)."""
    hflip: torch.Tensor    # bool
    vflip: torch.Tensor    # bool
    angle: torch.Tensor    # radians; 0 when not rotated, else +-[15, 75] deg
    keep: torch.Tensor     # crop keep ratio: [0.7, 0.95], or 1 (no crop)
    uy: torch.Tensor       # crop offsets as fractions of the slack, U[0, 1)
    ux: torch.Tensor


class FastParams(NamedTuple):
    """Per-image draws of the fast policy ([B] each)."""
    hflip: torch.Tensor
    vflip: torch.Tensor
    keep: torch.Tensor
    uy: torch.Tensor
    ux: torch.Tensor


_SHARD = None   # (index, count) inside ``shard_draws``


@contextmanager
def shard_draws(index: int, count: int):
    """Inside, a per-image draw for ``batch`` images draws for the
    ``batch * count`` of the global batch and keeps shard ``index``'s."""
    global _SHARD
    before, _SHARD = _SHARD, (index, count)
    try:
        yield
    finally:
        _SHARD = before


def draw_rows(generator: torch.Generator, shape: tuple) -> torch.Tensor:
    """``torch.rand(shape)`` whose dim 1 counts images: under
    ``shard_draws``, this shard's columns of the global batch's draw."""
    if _SHARD is None:
        return torch.rand(shape, generator=generator, device=generator.device)
    index, count = _SHARD
    b = shape[1]
    u = torch.rand((shape[0], b * count, *shape[2:]), generator=generator,
                   device=generator.device)
    return u[:, index * b:(index + 1) * b]


def draw_full(generator: torch.Generator, batch: int, hflip_p: float = 0.5,
              vflip_p: float = 0.2, crop_p: float = 0.7,
              rotate_p: float = 0.5) -> FullParams:
    """The full policy's random parameters, from ``generator`` on its
    device (``augment_batch``'s ``draw``)."""
    u = draw_rows(generator, (9, batch))
    ang = 15.0 + u[0] * 60.0
    ang = torch.where(u[1] < 0.5, -ang, ang) * math.pi / 180.0
    ang = torch.where(u[2] < rotate_p, ang, torch.zeros_like(ang))
    keep = torch.where(u[3] < crop_p, 0.7 + u[4] * 0.25,
                       torch.ones_like(u[4]))
    return FullParams(u[5] < hflip_p, u[6] < vflip_p, ang, keep, u[7], u[8])


def draw_fast(generator: torch.Generator, batch: int, hflip_p: float = 0.5,
              vflip_p: float = 0.2, crop_p: float = 0.7) -> FastParams:
    """The fast policy's random parameters (``augment_batch_fast``'s)."""
    u = draw_rows(generator, (6, batch))
    keep = torch.where(u[0] < crop_p, 0.7 + u[1] * 0.25,
                       torch.ones_like(u[1]))
    return FastParams(u[2] < hflip_p, u[3] < vflip_p, keep, u[4], u[5])


def to_unit(images: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``images`` as ``dtype``, uint8 divided by 255 elementwise (true
    division by a device scalar, which PyTorch's CUDA division does not
    turn into a reciprocal multiply; filled on the device, so that a CUDA
    graph captures it)."""
    x = images.to(dtype)
    if images.dtype == torch.uint8:
        x = x / torch.full((), 255.0, dtype=dtype, device=x.device)
    return x


def place(x: torch.Tensor, p: FullParams) -> torch.Tensor:
    """Flips and the 1/f pre-shrink about the center, on the same canvas."""
    s = x.shape[1]
    f = torch.abs(torch.cos(p.angle)) + torch.abs(torch.sin(p.angle))
    span, off = f * s, s * (1.0 - f) / 2.0
    wy = resample_matrix(s, s, span, off, p.vflip)
    wx = resample_matrix(s, s, span, off, p.hflip)
    return matmul_resample(x, wy, wx, x.dtype)


def crop_resize(x: torch.Tensor, span: torch.Tensor, oy: torch.Tensor,
                ox: torch.Tensor, vflip: torch.Tensor, hflip: torch.Tensor,
                out_size: int, dtype=torch.float32,
                gain: float = 1.0) -> torch.Tensor:
    """Crop a ``span`` square at offsets (oy, ox), flip, and resize to
    ``out_size``; ``gain`` scales the row weights."""
    s = x.shape[1]
    wy = resample_matrix(s, out_size, span, oy, vflip, gain, clamp=True)
    wx = resample_matrix(s, out_size, span, ox, hflip, clamp=True)
    return matmul_resample(x, wy, wx, dtype)


def apply_full(images: torch.Tensor, p: FullParams, out_size: int = 224,
               dtype=torch.float32, rotate=None) -> torch.Tensor:
    """[B,S,S,C] uint8/float canvases -> [B,out,out,C] in [0, 1]: place,
    rotate, crop and resize. ``rotate`` defaults to the rotation kernel."""
    if rotate is None:
        from cnn_tpu_torch.ops.hopper.augment import rotate_shear as rotate
    j = place(to_unit(images, dtype), p)
    return crop_full(rotate(j, p.angle), p, out_size, dtype)


def crop_full(j: torch.Tensor, p: FullParams, out_size: int = 224,
              dtype=torch.float32) -> torch.Tensor:
    """The full policy's last stage: crop (no flip) and resize."""
    s = j.shape[1]
    span = p.keep * s
    no = torch.zeros_like(p.hflip)
    return crop_resize(j, span, p.uy * (s - span), p.ux * (s - span), no, no,
                       out_size, dtype)


def apply_fast(images: torch.Tensor, p: FastParams, out_size: int = 224,
               dtype=torch.float32) -> torch.Tensor:
    """Flips, crop, resize and the uint8 /255 in two banded matmuls."""
    s = images.shape[1]
    slack = (1.0 - p.keep) * s
    gain = 1.0 / 255.0 if images.dtype == torch.uint8 else 1.0
    return crop_resize(images, p.keep * s, p.uy * slack, p.ux * slack,
                       p.vflip, p.hflip, out_size, dtype, gain)


def augment_batch(generator: torch.Generator, images: torch.Tensor,
                  out_size: int = 224, hflip_p: float = 0.5,
                  vflip_p: float = 0.2, crop_p: float = 0.7,
                  rotate_p: float = 0.5, dtype=torch.float32,
                  rotate=None) -> torch.Tensor:
    """The full reference policy: draw, then apply (``rotate`` as in
    ``apply_full``)."""
    p = draw_full(generator, images.shape[0], hflip_p, vflip_p, crop_p,
                  rotate_p)
    return apply_full(images, p, out_size, dtype, rotate)


def augment_batch_fast(generator: torch.Generator, images: torch.Tensor,
                       out_size: int = 224, hflip_p: float = 0.5,
                       vflip_p: float = 0.2, crop_p: float = 0.7,
                       dtype=torch.float32) -> torch.Tensor:
    """Flips and random-resized-crop only (no rotation): draw, then apply."""
    p = draw_fast(generator, images.shape[0], hflip_p, vflip_p, crop_p)
    return apply_fast(images, p, out_size, dtype)


# ---------------------------------------------------------------------------
# batch mixing (MixUp / CutMix) and colour jitter: draw and apply
# ---------------------------------------------------------------------------

class MixDraw(NamedTuple):
    """``batch_mix``'s random values: the partner permutation [B] and, as
    0-d tensors, MixUp's lambda, CutMix's lambda before the box is clipped
    and the box centre, and, with both alphas, whether this batch cuts."""
    perm: torch.Tensor
    lam_mixup: torch.Tensor | None = None
    lam_cutmix: torch.Tensor | None = None
    cy: torch.Tensor | None = None
    cx: torch.Tensor | None = None
    use_cut: torch.Tensor | None = None


def draw_beta(generator: torch.Generator, alpha: float) -> torch.Tensor:
    """Beta(alpha, alpha) as float32 0-d, on the generator's device: the
    ratio of two float64 Gamma(alpha) draws."""
    g = torch._standard_gamma(
        torch.full((2,), float(alpha), dtype=torch.float64,
                   device=generator.device), generator=generator)
    return (g[0] / (g[0] + g[1])).float()


def draw_mix(generator: torch.Generator, batch: int, height: int, width: int,
             mixup_alpha: float = 0.0, cutmix_alpha: float = 0.0) -> MixDraw:
    """``batch_mix``'s draws, from ``generator`` on its device."""
    if not (mixup_alpha > 0.0 or cutmix_alpha > 0.0):
        raise ValueError("batch_mix needs mixup_alpha or cutmix_alpha")
    dev = generator.device
    perm = torch.randperm(batch, generator=generator, device=dev)
    lam_mixup = (draw_beta(generator, mixup_alpha) if mixup_alpha > 0.0
                 else None)
    lam_cutmix = cy = cx = None
    if cutmix_alpha > 0.0:
        lam_cutmix = draw_beta(generator, cutmix_alpha)
        cy = torch.randint(0, height, (), generator=generator, device=dev)
        cx = torch.randint(0, width, (), generator=generator, device=dev)
    use_cut = (torch.rand((), generator=generator, device=dev) < 0.5
               if mixup_alpha > 0.0 and cutmix_alpha > 0.0 else None)
    return MixDraw(perm, lam_mixup, lam_cutmix, cy, cx, use_cut)


def apply_mix(images: torch.Tensor, d: MixDraw, partners=None):
    """MixUp / CutMix of float NHWC ``images`` with ``d``'s draws; returns
    ``(mixed, perm, lam)``, ``lam`` float32 0-d. MixUp blends ``lam * x +
    (1 - lam) * x[perm]`` in the images' dtype; CutMix pastes the
    partner's box of side ``sqrt(1 - lam0)`` times the image's about the
    centre, clipped to the image, and re-derives ``lam`` from the clipped
    area; with both, ``use_cut`` picks. The loss mixes as ``lam * CE(y) +
    (1 - lam) * CE(y[perm])``. ``partners``: the batch ``d.perm`` indexes
    (default ``images``; a shard's rows take them from the global
    batch)."""
    b, h, w = images.shape[:3]
    partner = (images if partners is None else partners).index_select(
        0, d.perm)
    mixed = lam = None
    if d.lam_mixup is not None:
        lam = d.lam_mixup.float()
        mixed = (images * lam.to(images.dtype)
                 + partner * (1.0 - lam).to(images.dtype))
    if d.lam_cutmix is not None:
        cut = torch.sqrt(1.0 - d.lam_cutmix.float())
        ch = (cut * h).to(torch.int32)
        cw = (cut * w).to(torch.int32)
        y0 = torch.clamp(d.cy - ch // 2, 0, h)
        y1 = torch.clamp(d.cy + (ch + 1) // 2, 0, h)
        x0 = torch.clamp(d.cx - cw // 2, 0, w)
        x1 = torch.clamp(d.cx + (cw + 1) // 2, 0, w)
        rows = torch.arange(h, device=images.device)[:, None]
        cols = torch.arange(w, device=images.device)[None, :]
        inside = (rows >= y0) & (rows < y1) & (cols >= x0) & (cols < x1)
        cut_images = torch.where(inside[None, :, :, None], partner, images)
        cut_lam = 1.0 - ((y1 - y0) * (x1 - x0)).float() / float(h * w)
        if mixed is None:
            mixed, lam = cut_images, cut_lam
        else:
            mixed = torch.where(d.use_cut, cut_images, mixed)
            lam = torch.where(d.use_cut, cut_lam, lam)
    return mixed, d.perm, lam


def batch_mix(generator: torch.Generator, images: torch.Tensor,
              mixup_alpha: float = 0.0, cutmix_alpha: float = 0.0):
    """MixUp / CutMix (``cnn_tpu``'s ``batch_mix``): draw, then apply; one
    lambda per batch. Call on float images."""
    b, h, w = images.shape[:3]
    return apply_mix(images, draw_mix(generator, b, h, w, mixup_alpha,
                                      cutmix_alpha))


class JitterDraw(NamedTuple):
    """``color_jitter``'s per-image factors, [B,1,1,1] each."""
    bright: torch.Tensor     # U(-s, s)
    contrast: torch.Tensor   # U(1-s, 1+s)
    sat: torch.Tensor        # U(1-s, 1+s)


def draw_jitter(generator: torch.Generator, batch: int, strength: float,
                dtype=torch.float32) -> JitterDraw:
    """``color_jitter``'s draws, in ``dtype``, from ``generator`` on its
    device."""
    u = draw_rows(generator, (3, batch, 1, 1, 1))
    s = float(strength)
    return JitterDraw((-s + 2 * s * u[0]).to(dtype),
                      (1 - s + 2 * s * u[1]).to(dtype),
                      (1 - s + 2 * s * u[2]).to(dtype))


def apply_jitter(images: torch.Tensor, d: JitterDraw) -> torch.Tensor:
    """Saturation (lerp toward the per-pixel channel mean), contrast (about
    the per-image mean), brightness (added), then clipped to [0, 1]; on
    float images in [0, 1]. Each mean is ``jnp.mean``'s as XLA computes
    it: the float32 sum times ``1/n``, in the images' dtype."""
    def mean(t, dims):
        n = math.prod(t.shape[d] for d in dims)
        return (t.sum(dim=dims, keepdim=True, dtype=torch.float32)
                * (1.0 / n)).to(t.dtype)
    gray = mean(images, (-1,))
    x = gray + d.sat * (images - gray)
    m = mean(x, (1, 2, 3))
    x = m + d.contrast * (x - m) + d.bright
    return torch.clamp(x, 0.0, 1.0)


def color_jitter(generator: torch.Generator, images: torch.Tensor,
                 strength: float = 0.2) -> torch.Tensor:
    """Per-image brightness / contrast / saturation jitter (``cnn_tpu``'s
    ``color_jitter``): draw, then apply."""
    return apply_jitter(images, draw_jitter(generator, images.shape[0],
                                            strength, images.dtype))
