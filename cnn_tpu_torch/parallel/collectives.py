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

- over ``'data'`` each rank holds its own part of the objective (the loss
  is the sum of the ranks' parts), so a value that every rank reads after
  a sum gets back the sum of their cotangents;
- over ``'model'`` every rank computes the same objective from the same
  replicated values, so after a sum or a gather each rank keeps its own
  cotangent (its slice, after a gather), and the input of a layer sharded
  over ``'model'`` (``model_input``) sums the ranks' partial cotangents.

Low-precision floats are summed in float32 and rounded back once.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


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
        if ctx.axis == "data":
            g = all_sum(g, ctx.mesh, ctx.axis)
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        k = x.shape[dim]
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.start, ctx.k = mesh.index(axis) * k, k
        return assemble(x, mesh, axis, k * mesh.size(axis), ctx.start, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.axis == "data":
            g = all_sum(g, ctx.mesh, ctx.axis)
        part = g.narrow(ctx.dim, ctx.start, ctx.k).contiguous()
        return part, None, None, None


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


def gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' equal parts ``x`` of ``axis`` joined along ``dim`` in
    rank order, differentiable (module docstring)."""
    if not mesh.active(axis):
        return x
    return _Gather.apply(x, mesh, axis, dim % x.dim())


def model_input(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as the input of a layer sharded over ``'model'``: the identity,
    whose backward sums the ranks' partial cotangents."""
    if not mesh.active("model") or not torch.is_grad_enabled():
        return x
    return _ModelInput.apply(x, mesh)
