"""Collectives over one axis of a ``Mesh`` (``parallel/mesh.py``), written
over ``all_reduce`` alone: under gloo only ``broadcast``, ``all_reduce``
and ``barrier`` take CUDA tensors, so a gather is an ``all_reduce`` of a
zero-filled buffer that each rank writes its own part into.

A collective runs on an axis that ``Mesh.active`` says is live: one with
more than one rank, or any axis under NCCL (a device op, which a CUDA
graph captures). An axis of one rank under gloo would be a host round
trip for nothing, and is skipped; so is every axis of a mesh without a
process group.

The differentiable ones are ``torch.autograd.Function``s whose backward
follows ``cnn_tpu``'s GSPMD program, where the sharded step computes the
global batch's objective:

- over ``'data'``, ``'spatial'`` and ``'expert'`` each rank holds its own
  part of the objective (``parallel/train_step.py`` divides the loss by
  the product of their sizes), so a value that every rank reads after a
  sum or a gather gets back the sum of the ranks' cotangents (its slice
  of it, after a gather);
- over ``'model'`` every rank computes the same objective from the same
  replicated values, so after a sum or a gather each rank keeps its own
  cotangent (its slice, after a gather), and the input of a layer sharded
  over ``'model'`` (``model_input``) sums the ranks' partial cotangents.

``halo`` is the exchange of image rows over ``'spatial'``: a layer that
reads a window of rows (a conv, a pool) gets the rows its output rows
read from the ranks that hold them, in one ``all_reduce`` of a buffer of
just those rows (``halo_plan``); its backward sends each such row's
cotangent back to its owner, in one more, and adds it there. ``counts``
keeps the rows they carried.

``hop`` is the pipeline's move over ``'stage'`` (``cnn_tpu``'s ring
``lax.ppermute``, the wrap from the last stage to the first included):
each rank's tensor goes ``shift`` stages on. It is one ``all_reduce`` of
an ``S``-slot buffer in which each rank fills the slot of the rank it
sends to, so every rank of the line enters the same collective at every
hop, whatever it computed; ``counts["stage_hops"]`` counts them. Under
NCCL, with a GPU per rank, a ``batch_isend_irecv`` pair would move ``S``
times fewer bytes; it is not written, since one card cannot run such a
mesh (``ROADMAP.md`` Constraints), and the ``all_reduce`` runs under
both backends.

Low-precision floats are summed in float32 and rounded back once.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.distributed as dist

# the rows the halo exchanges' buffers carried, forward and backward
# (``halo``), and the pipeline's stage hops (``hop``)
counts = {"halo_rows": 0, "stage_hops": 0}


def even_split(n: int, index: int, size: int) -> tuple[int, int]:
    """Part ``index`` of ``size`` contiguous parts of ``n`` rows, as even
    as they go: ``[index * n // size, (index + 1) * n // size)``."""
    return index * n // size, (index + 1) * n // size


def all_sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (a new tensor; no
    gradient)."""
    if not mesh.active(axis):
        return x
    low = x.dtype in (torch.bfloat16, torch.float16)
    y = x.detach().to(torch.float32 if low else x.dtype,
                      copy=True).contiguous()
    dist.all_reduce(y, group=mesh.groups[axis])
    return y.to(x.dtype) if low else y


def assemble(x: torch.Tensor, mesh, axis: str, total: int, start: int,
             dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` placed along ``dim`` of a tensor of length
    ``total`` there, this rank's at ``start`` (the parts tile it); no
    gradient."""
    if not mesh.active(axis):
        return x
    shape = list(x.shape)
    shape[dim] = total
    buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
    buf.narrow(dim, start, x.shape[dim]).copy_(x)
    return all_sum(buf, mesh, axis)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_sum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.axis != "model":
            g = all_sum(g, ctx.mesh, ctx.axis)
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, total, start):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.start, ctx.k = start, x.shape[dim]
        return assemble(x, mesh, axis, total, start, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.axis != "model":
            g = all_sum(g, ctx.mesh, ctx.axis)
        part = g.narrow(ctx.dim, ctx.start, ctx.k).contiguous()
        return part, None, None, None, None, None


class _ModelInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g, ctx.mesh, "model"), None


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, differentiable (module docstring)."""
    if not mesh.active(axis):
        return x
    return _Psum.apply(x, mesh, axis)


def gather(x: torch.Tensor, mesh, axis: str, dim: int, total=None,
           start=None) -> torch.Tensor:
    """The ranks' parts ``x`` of ``axis`` joined along ``dim`` in rank
    order, differentiable (module docstring): equal parts by default, or
    this rank's at ``start`` of ``total`` (uneven parts that tile it)."""
    if not mesh.active(axis):
        return x
    if total is None:
        k = x.shape[dim]
        total, start = k * mesh.size(axis), mesh.index(axis) * k
    return _Gather.apply(x, mesh, axis, dim % x.dim(), total, start)


def model_input(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as the input of a layer sharded over ``'model'``: the identity,
    whose backward sums the ranks' partial cotangents."""
    if not mesh.active("model") or not torch.is_grad_enabled():
        return x
    return _ModelInput.apply(x, mesh)


# ---------------------------------------------------------- halo exchange --

class HaloPlan(NamedTuple):
    """The row exchange of one windowed layer over a ``'spatial'`` axis
    (``halo_plan``), every rank's part of it, in global rows of the input
    (rows outside ``[0, h)`` are the image's zero padding):

    - ``own[r]``: rank r's input rows ``[lo, hi)`` (``Mesh.strip``);
    - ``out[r]``: its output rows ``[olo, ohi)``, the strip of ``ho``;
    - ``span[r]``: the rows ``[start, end)`` of the strip it hands the
      layer, which runs it with its own padding: ``start`` lies
      ``ceil(p / s) * s - p`` zero rows above the first row its first
      output reads, so that output ``crop`` (``ceil(p / s)``) of the
      layer's is its output row ``olo``; empty where it owns no output
      row;
    - ``reads[r]``: the image rows ``[u, v)`` its output rows read;
    - ``segments``: ``(r, g0, g1, offset)``, the rows ``[g0, g1)`` that
      rank r reads and does not hold, at ``offset`` of the exchange's
      buffer of ``total`` rows."""
    h: int
    ho: int
    own: tuple
    out: tuple
    span: tuple
    reads: tuple
    crop: int
    segments: tuple
    total: int


@functools.lru_cache(maxsize=1024)
def halo_plan(h: int, k: int, stride: int, padding: int,
              size: int) -> HaloPlan:
    """The exchange for a layer of window ``k``, ``stride`` and
    ``padding`` on ``h`` input rows over ``size`` ranks, each output row
    ``i`` reading input rows ``[i * stride - padding, ... + k)``. Every
    rank computes the whole plan, so all agree on the buffer."""
    ho = (h + 2 * padding - k) // stride + 1
    own = tuple(even_split(h, r, size) for r in range(size))
    out = tuple(even_split(ho, r, size) for r in range(size))
    crop = -(-padding // stride)
    span, reads, segments, total = [], [], [], 0
    for r, ((lo, hi), (olo, ohi)) in enumerate(zip(own, out)):
        if ohi == olo:
            span.append((0, 0))
            reads.append((0, 0))
            continue
        first, end = olo * stride - padding, (ohi - 1) * stride - padding + k
        span.append(((olo - crop) * stride, end))
        # the image rows it reads, less those it holds: above and below
        u, v = max(first, 0), min(end, h)
        reads.append((u, v))
        for g0, g1 in ((u, min(v, lo)), (max(u, hi), v)):
            if g1 > g0:
                segments.append((r, g0, g1, total))
                total += g1 - g0
    return HaloPlan(h, ho, own, out, tuple(span), tuple(reads), crop,
                    tuple(segments), total)


def _fill(buf, src, lo, hi, g0, g1, at_buf, at_src):
    """Rows ``[g0, g1) ∩ [lo, hi)`` of ``src`` (global row ``at_src`` at
    its index 0) into ``buf`` (``at_buf``), added."""
    i0, i1 = max(g0, lo), min(g1, hi)
    if i1 > i0:
        buf[:, i0 - at_buf:i1 - at_buf] += src[:, i0 - at_src:i1 - at_src]


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, plan):
        me = mesh.index("spatial")
        (lo, hi), (start, end) = plan.own[me], plan.span[me]
        ctx.mesh, ctx.plan = mesh, plan
        bsz, _, w, c = x.shape
        strip = x.new_zeros(bsz, end - start, w, c)
        # the rows it reads and holds; the rest of the strip is zero: the
        # image's padding, and the rows above the first row it reads, which
        # feed only the outputs that the layer's caller crops
        _fill(strip, x, lo, hi, *plan.reads[me], start, lo)
        if plan.total:
            buf = x.new_zeros(bsz, plan.total, w, c)
            for _, g0, g1, off in plan.segments:
                _fill(buf, x, lo, hi, g0, g1, g0 - off, lo)
            buf = all_sum(buf, mesh, "spatial")
            for r, g0, g1, off in plan.segments:
                if r == me:
                    strip[:, g0 - start:g1 - start] = buf[:, off:off + g1 - g0]
            counts["halo_rows"] += plan.total
        return strip

    @staticmethod
    def backward(ctx, g):
        mesh, plan = ctx.mesh, ctx.plan
        me = mesh.index("spatial")
        (lo, hi), (start, end) = plan.own[me], plan.span[me]
        bsz, _, w, c = g.shape
        gx = g.new_zeros(bsz, hi - lo, w, c)
        _fill(gx, g, lo, hi, *plan.reads[me], lo, start)
        if plan.total:
            buf = g.new_zeros(bsz, plan.total, w, c)
            for r, g0, g1, off in plan.segments:
                if r == me:
                    buf[:, off:off + g1 - g0] = g[:, g0 - start:g1 - start]
            buf = all_sum(buf, mesh, "spatial")
            # each row's cotangents from the ranks that read it, added to
            # its own
            for _, g0, g1, off in plan.segments:
                _fill(gx, buf, lo, hi, g0, g1, lo, g0 - off)
            counts["halo_rows"] += plan.total
        return gx, None, None


def halo(x: torch.Tensor, mesh, plan: HaloPlan) -> torch.Tensor:
    """This rank's strip ``plan.span`` of the rows of the activation whose
    strip (``Mesh.strip``) ``x`` [B, h, W, C] is, rows outside the image
    zero, differentiable (module docstring). The rows it holds are copied,
    the others come in one exchange of ``plan.total`` rows."""
    return _Halo.apply(x, mesh, plan)


# ------------------------------------------------------------ stage hop --

def hop(x: torch.Tensor, mesh, shift: int) -> torch.Tensor:
    """The ring move over ``'stage'`` (module docstring): ``x`` goes from
    stage ``s`` to stage ``(s + shift) % S``, and the tensor of the same
    shape that stage ``(s - shift) % S`` sent comes back (no gradient).
    Every rank of the line calls it, in the same order."""
    if not mesh.active("stage"):
        return x
    size, me = mesh.size("stage"), mesh.index("stage")
    buf = x.new_zeros((size, *x.shape))
    buf[(me + shift) % size] = x
    counts["stage_hops"] += 1
    return all_sum(buf, mesh, "stage")[me]
