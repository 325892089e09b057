"""Layers, counterparts of ``cnn_tpu/nn/module.py``, as ``nn.Module``s.

Parameters keep ``cnn_tpu``'s names and layouts (conv ``w`` [k,k,Cin,Cout]
HWIO and ``b``; dense ``w`` [in,out] and ``b``; BN ``gamma``/``beta`` with
``mean``/``var`` buffers), so a ``cnn_tpu`` param tree loads as it is
(``utils/checkpoint.py:load_jax_params``). Activations are NHWC.

Conv2D and MaxPool2D (its 2x2 window at stride 2) go through the kernels
in ``ops/hopper``: the CUDA kernel for a CUDA tensor, the plain version
for a CPU tensor. When a gradient is asked for, they call the kernels'
autograd Functions (``conv2d_bias_relu_fn``, ``max_pool2d_fn``), whose
backward is the conv's ATen gradients and the pool backward kernel;
otherwise the bare wrappers.
BatchNorm2D normalizes by batch statistics in training mode and updates its
moving statistics in place. Dropout (``ops/dropout.py``) draws its channels
in training mode from the generator its ``forward`` is given, as
``cnn_tpu``'s layer draws from the key folded in for it.

Under a compute dtype (``forward(..., compute_dtype=torch.bfloat16)``, as
``cnn_tpu``'s ``apply(compute_dtype=)``) the parameters stay float32 and
Conv2D, DepthwiseConv2D and Linear cast their input and weights to it at
each call (the conv's bias too: its kernel reads the bf16 bias into
float32, as ``cnn_tpu/ops/conv.py`` casts it to the output's dtype).
Autograd carries the gradients back through the casts into the float32
parameters. BN keeps float32 statistics and returns its input's dtype.

The composite layers of the other families nest as ``cnn_tpu``'s do:
``ResidualBlock`` (``relu(body(x) + shortcut(x))``, its params under
``body`` and ``proj``) and ``StackedBlocks`` (``n_blocks`` copies of one
block whose params and BN state are stacked with a leading [L] axis, block
i reading slice i, with ``cnn_tpu``'s ``remat`` modes). ``tree_leaves``
walks any layer in ``cnn_tpu``'s tree paths, which name the parameters
(``parallel/train_step.py:named_params``) and the checkpoint trees
(``utils/checkpoint.py``).

On a mesh (``parallel/mesh.py``, set by ``parallel/train_step.py:
shard_model``) a layer holds it in ``mesh``: BN sums its batch statistics
over ``'data'`` and ``'spatial'``. ``param_pspecs`` declares, as
``cnn_tpu``'s layers do, which parameter axes shard over ``'model'`` (a
wide conv's out-channels, a dense layer's in-features); a layer whose
``w`` holds its shard keeps the mesh in ``tp`` and runs its slice through
the same kernels, then joins the ranks' results (``_forward_tp``).

On a mesh with a ``'spatial'`` axis each activation is this rank's strip
of its image rows (``Mesh.strip``; the model's entry cuts the images,
``nn/sequential.py:cut_rows``, after ``plan_rows`` has given each layer
the rows of its input over all ranks, ``rows``). A layer that reads a
window of rows (Conv2D, DepthwiseConv2D, MaxPool2D, AvgPool2D) takes the
rows its output rows read from their owners (``Mesh.halo``) and runs its
own op, kernels included, on that strip with its own padding, then crops
the outputs that read the rows above it (``_windowed``); GlobalAvgPool
sums its rows over the axis; Flatten and a Linear fed by a conv gather
the rows first (``_whole_rows``).
"""

from __future__ import annotations

import copy
import functools

import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from cnn_tpu_torch.ops.activations import relu
from cnn_tpu_torch.ops import dropout as dropout_ops
from cnn_tpu_torch.ops.batchnorm import batch_norm2d_eval, batch_norm2d_train
from cnn_tpu_torch.ops.conv import conv_out_size, depthwise_conv2d
from cnn_tpu_torch.ops.hopper.conv import (conv2d_bias_relu,
                                           conv2d_bias_relu_fn,
                                           conv2d_bias_relu_op)
from cnn_tpu_torch.ops.hopper.pool import max_pool2d_fn, max_pool2d_fwd
from cnn_tpu_torch.ops.linear import linear, matmul
from cnn_tpu_torch.ops.pool import avg_pool2d, global_avg_pool, max_pool2d


def leaf_name(path) -> str:
    """A tree path as a parameter name: the layer path joined by "/", then
    "." and the tensor's key (``conv_layer_1.w``,
    ``block_2/body/block_2_conv1.w``, ``trunk/body/b_conv1.w``)."""
    return "/".join(path[:-1]) + "." + path[-1]


def leaf_path(name: str) -> tuple[str, ...]:
    """``leaf_name``'s inverse."""
    layers, key = name.rsplit(".", 1)
    return (*layers.split("/"), key)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _normal(shape, generator, device, scale: float = 0.1) -> nn.Parameter:
    """N(0, 1) * ``scale`` (0.1 by default, ``cnn_tpu``'s init for conv and
    dense weights)."""
    return nn.Parameter(
        (torch.randn(shape, generator=generator) * scale).to(device))


class Layer(nn.Module):
    """A named layer. ``casts``: its ``forward`` takes ``compute_dtype``;
    ``draws``: it takes ``generator`` (and ``perms``, permutations drawn
    ahead for its Dropouts)."""
    casts = False
    draws = False
    mesh = None     # the mesh of a sharded step (parallel/train_step.py)
    tp = None       # the mesh whose 'model' axis shards ``w``
    ep = None       # the mesh whose 'expert' axis shards its experts
    rows = None     # the image rows of its input over a 'spatial' axis

    def __init__(self, name: str):
        super().__init__()
        self.name = name

    def param_pspecs(self, model_dim: int):
        """``{param key: spec}``, a spec naming the mesh axis of each of
        the tensor's dims (``cnn_tpu``'s ``PartitionSpec`` as a tuple), for
        the params that shard over ``'model'``; None to replicate all."""
        return None

    def tree_leaves(self):
        """``(path, tensor, is_state)`` of this layer's ``cnn_tpu`` param
        and state trees, paths relative to the layer: its own parameters,
        and BN's moving statistics as state."""
        for key, p in self.named_parameters(recurse=False):
            yield (key,), p, False

    def plan_rows(self, h):
        """Records ``h``, the image rows of its input over every
        ``'spatial'`` rank (None once a layer has taken them away), in
        ``rows``; returns its output's."""
        self.rows = h
        return h

    def on_strips(self) -> bool:
        """Whether its input is a strip of rows of a ``'spatial'`` mesh."""
        return (self.mesh is not None and self.rows is not None
                and self.mesh.active("spatial"))


def _windowed(layer, x, k, stride, padding, op, channels, dtype=None):
    """``op`` on this rank's strip of ``x``'s rows on a ``'spatial'`` mesh:
    the layer of window ``k``, ``stride`` and ``padding`` on ``layer.rows``
    image rows. The strip holds the rows its output rows read
    (``Mesh.halo``); ``op`` runs it with the layer's own padding, and the
    outputs that read the strip's top margin are cropped. A rank that owns
    no output row (fewer rows than ranks) returns an empty [B, 0, Wo,
    ``channels``] that still leads back to the exchange, whose backward
    every rank of the axis joins."""
    mesh = layer.mesh
    plan = mesh.halo_plan(layer.rows, k, stride, padding)
    me = mesh.index("spatial")
    strip = mesh.halo(x, plan)
    olo, ohi = plan.out[me]
    if ohi == olo:
        wo = (x.shape[2] + 2 * padding - k) // stride + 1
        return strip[:, :0, :1, :1].expand(
            x.shape[0], 0, wo, channels).to(dtype or x.dtype)
    y = op(strip)
    if plan.crop == 0 and y.shape[1] == ohi - olo:
        return y
    return y.narrow(1, plan.crop, ohi - olo)


def _whole_rows(layer, x):
    """A 4-D strip of a ``'spatial'`` mesh with every rank's rows joined
    (``Mesh.gather``); anything else as it is."""
    if x.dim() != 4 or not layer.on_strips():
        return x
    lo, _ = layer.mesh.strip(layer.rows)
    return layer.mesh.gather(x, "spatial", 1, layer.rows, lo)


class Conv2D(Layer):
    """NHWC/HWIO conv + bias with ``padding`` zero rows and columns on each
    side; ``forward(x, relu=True)`` fuses the ReLU. Weights and bias start
    at N(0, 1) * ``init_scale``.

    ``s2d``: ``cnn_tpu``'s flag for running a stride-2 conv as
    space-to-depth and a stride-1 conv over repacked weights, the same
    products summed in another order. It is checked (stride 2 only) and
    kept, but the conv runs as the stride-2 conv on the same kernels:
    the repacked conv was slower on the H100 than the strip and tiled
    kernels (``PERF.md``). The parameters keep their [k, k, Cin, Cout]
    layout either way.

    ``named_op``: with a gradient asked for, launch through the custom op
    (``conv2d_bias_relu_op``) rather than the autograd Function, so that a
    selective checkpoint policy sees the conv (``StackedBlocks``,
    ``remat='conv'``).

    ``pipe_tp``: ``(role, mesh)`` in a pipelined trunk's block under a
    ``'model'`` axis (``parallel/pipeline.py``, Megatron's pair): the
    ``"column"`` conv holds its out-channels' slice and takes its input
    through ``Mesh.model_input``; the ``"row"`` conv holds its
    in-channels' slice, and its partial sums, without the bias, are summed
    over the axis (the backward the identity), then the bias is added."""
    casts = True

    def __init__(self, name, in_channels=3, out_channels=16, kernel_size=3,
                 stride=2, padding=0, init_scale=0.1, s2d=False, *,
                 device=None, generator=None):
        super().__init__(name)
        assert not (s2d and stride != 2), \
            "s2d execution is the stride-2 specialization"
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.s2d = padding, s2d
        self.named_op = False
        self.pipe_tp = None
        k = kernel_size
        self.w = _normal((k, k, in_channels, out_channels), generator, device,
                         init_scale)
        self.b = _normal((out_channels,), generator, device, init_scale)

    def param_pspecs(self, model_dim: int):
        # wide convs only: a shard of a narrow one starves its kernel
        if model_dim > 1 and self.out_channels % model_dim == 0 \
                and self.out_channels >= 32 * model_dim:
            return {"w": (None, None, None, "model")}
        return None

    def plan_rows(self, h):
        self.rows = h
        return conv_out_size(h, self.kernel_size, self.stride, self.padding)

    def forward(self, x, relu: bool = False, compute_dtype=None):
        if self.on_strips():
            return _windowed(self, x, self.kernel_size, self.stride,
                             self.padding,
                             lambda s: self._forward(s, relu, compute_dtype),
                             self.out_channels, compute_dtype)
        return self._forward(x, relu, compute_dtype)

    def _forward(self, x, relu, compute_dtype):
        if self.tp is not None:
            return self._forward_tp(x, relu, compute_dtype)
        if self.pipe_tp is not None:
            return self._forward_pipe_tp(x, relu, compute_dtype)
        return self._conv(x, self.w, self.b, relu, compute_dtype)

    def _forward_pipe_tp(self, x, fuse_relu, compute_dtype):
        role, mesh = self.pipe_tp
        if role == "column":
            return self._conv(mesh.model_input(x), self.w, self.b, fuse_relu,
                              compute_dtype)
        y = self._conv(x, self.w, torch.zeros_like(self.b), False,
                       compute_dtype)
        y = mesh.psum(y, "model") + self.b.to(y.dtype)
        return relu(y) if fuse_relu else y

    def _forward_tp(self, x, relu, compute_dtype):
        """``w`` holds this rank's out-channels: the conv of the replicated
        ``x`` with them and their slice of the replicated bias, then the
        ranks' outputs joined along the channels."""
        mesh = self.tp
        k = self.w.shape[-1]
        lo = mesh.index("model") * k
        b = mesh.model_input(self.b)[lo:lo + k]
        y = self._conv(mesh.model_input(x), self.w, b, relu, compute_dtype)
        return mesh.gather(y, "model", -1)

    def _conv(self, x, w, b, relu, compute_dtype):
        if compute_dtype is not None:
            x, w, b = (x.to(compute_dtype), w.to(compute_dtype),
                       b.to(compute_dtype))
        if _wants_grad(x, w, b) and self.named_op:
            return conv2d_bias_relu_op(x, w, b, self.stride, relu,
                                       self.padding)
        # the padding goes as a sixth argument only where there is one
        pad = (self.padding,) if self.padding else ()
        if _wants_grad(x, w, b):
            return conv2d_bias_relu_fn(x, w, b, self.stride, relu, *pad)
        return conv2d_bias_relu(x, w, b, self.stride, relu, *pad)


class DepthwiseConv2D(Layer):
    """Per-channel conv (``ops/conv.py:depthwise_conv2d``): w [k,k,1,C*mult],
    b [C*mult], N(0, 1) * ``init_scale``."""
    casts = True

    def __init__(self, name, channels=32, channel_multiplier=1,
                 kernel_size=3, stride=1, padding=1, init_scale=0.1, *,
                 device=None, generator=None):
        super().__init__(name)
        self.channels, self.channel_multiplier = channels, channel_multiplier
        self.kernel_size, self.stride = kernel_size, stride
        self.padding = padding
        k, c = kernel_size, channels * channel_multiplier
        self.w = _normal((k, k, 1, c), generator, device, init_scale)
        self.b = _normal((c,), generator, device, init_scale)

    @property
    def out_channels(self) -> int:
        return self.channels * self.channel_multiplier

    def plan_rows(self, h):
        self.rows = h
        return conv_out_size(h, self.kernel_size, self.stride, self.padding)

    def forward(self, x, compute_dtype=None):
        if self.on_strips():
            return _windowed(self, x, self.kernel_size, self.stride,
                             self.padding,
                             lambda s: self._forward(s, compute_dtype),
                             self.out_channels, compute_dtype)
        return self._forward(x, compute_dtype)

    def _forward(self, x, compute_dtype):
        w, b = self.w, self.b
        if compute_dtype is not None:
            x, w, b = (x.to(compute_dtype), w.to(compute_dtype),
                       b.to(compute_dtype))
        return depthwise_conv2d(x, w, b, self.stride, self.padding,
                                self.channel_multiplier)


class MaxPool2D(Layer):
    """Max pool of any window and stride, VALID (``cnn_tpu``'s
    ``MaxPool2D``). The 2x2 window at stride 2, the one every family uses,
    runs the pool kernels (the autograd Function when a gradient is asked
    for, the bare forward otherwise), which on a CUDA tensor launch or
    raise; any other window has no kernel in ``cnn_tpu`` and runs the
    plain op (``ops/pool.py:max_pool2d``) on either device."""

    def __init__(self, name, kernel_size=2, stride=2):
        super().__init__(name)
        self.kernel_size, self.stride = kernel_size, stride

    def plan_rows(self, h):
        self.rows = h
        return conv_out_size(h, self.kernel_size, self.stride)

    def forward(self, x):
        if self.on_strips():
            return _windowed(self, x, self.kernel_size, self.stride, 0,
                             self._pool, x.shape[-1])
        return self._pool(x)

    def _pool(self, x):
        if (self.kernel_size, self.stride) != (2, 2):
            return max_pool2d(x, self.kernel_size, self.stride)
        if _wants_grad(x):
            return max_pool2d_fn(x)
        return max_pool2d_fwd(x)


class AvgPool2D(Layer):
    """Average pool (``ops/pool.py:avg_pool2d``)."""

    def __init__(self, name, kernel_size=2, stride=2):
        super().__init__(name)
        self.kernel_size, self.stride = kernel_size, stride

    def plan_rows(self, h):
        self.rows = h
        return (h - self.kernel_size) // self.stride + 1

    def forward(self, x):
        def pool(s):
            return avg_pool2d(s, self.kernel_size, self.stride)
        if self.on_strips():
            return _windowed(self, x, self.kernel_size, self.stride, 0, pool,
                             x.shape[-1])
        return pool(x)


class GlobalAvgPool(Layer):
    """[B,H,W,C] -> [B,C], the float32 spatial mean in x's dtype; on a
    ``'spatial'`` mesh each rank's float32 sum of its rows, summed over the
    axis and divided by the image's H x W."""

    def plan_rows(self, h):
        self.rows = h
        return None

    def forward(self, x):
        if not self.on_strips():
            return global_avg_pool(x)
        total = self.mesh.psum(x.float().sum(dim=(1, 2)), "spatial")
        return (total / (self.rows * x.shape[2])).to(x.dtype)


class ReLU(Layer):
    def forward(self, x):
        return relu(x)


class Flatten(Layer):
    """[B,H,W,C] -> [B, H*W*C], NHWC order (every ``'spatial'`` rank's rows
    joined first)."""

    def plan_rows(self, h):
        self.rows = h
        return None

    def forward(self, x):
        return _whole_rows(self, x).reshape(x.shape[0], -1)


class Linear(Layer):
    casts = True

    def __init__(self, name, in_features=4608, out_features=3, *,
                 device=None, generator=None):
        super().__init__(name)
        self.in_features, self.out_features = in_features, out_features
        self.w = _normal((in_features, out_features), generator, device)
        self.b = _normal((out_features,), generator, device)

    def param_pspecs(self, model_dim: int):
        # in-features over 'model': each rank's partial product, summed
        if model_dim > 1 and self.in_features % model_dim == 0:
            return {"w": ("model", None)}
        return None

    def plan_rows(self, h):
        self.rows = h
        return None

    def forward(self, x, compute_dtype=None):
        x = _whole_rows(self, x)      # the rows of a conv's strips, joined
        if self.tp is None:
            return linear(x, self.w, self.b, compute_dtype)
        # ``w`` holds a row range of the flattened (h, w, c) features: the
        # partial product of those columns of the replicated ``x``, summed
        # over the ranks, then the replicated bias once
        mesh = self.tp
        k = self.w.shape[0]
        lo = mesh.index("model") * k
        x = mesh.model_input(x.reshape(x.shape[0], -1))[:, lo:lo + k]
        if compute_dtype is None or compute_dtype == torch.float32:
            part = x @ self.w
        else:
            part = matmul(x.to(compute_dtype), self.w.to(compute_dtype))
        y = mesh.psum(part, "model")
        return y + self.b.to(y.dtype)


class BatchNorm2D(Layer):
    """Per-channel BN over NHWC: batch statistics in training mode (which
    also update ``mean``/``var`` in place), moving statistics in eval.
    The moving variance starts at 1, or at 0 with ``compat_zero_var_init``
    (the reference's own init).

    ``defer_update``: training leaves ``mean``/``var`` as they are and
    keeps the new statistics in ``pending`` for the caller
    (``StackedBlocks``, which writes them once, outside any recompute)."""

    def __init__(self, name, num_channels=16, eps=1e-5, momentum=0.1, *,
                 compat_zero_var_init=False, device=None):
        super().__init__(name)
        self.num_channels, self.eps, self.momentum = num_channels, eps, momentum
        self.gamma = nn.Parameter(torch.ones(num_channels, device=device))
        self.beta = nn.Parameter(torch.zeros(num_channels, device=device))
        self.register_buffer("mean", torch.zeros(num_channels, device=device))
        self.register_buffer("var", torch.full(
            (num_channels,), 0.0 if compat_zero_var_init else 1.0,
            device=device))
        self.defer_update = False
        self.pending = None

    def tree_leaves(self):
        yield from super().tree_leaves()
        yield ("mean",), self.mean, True
        yield ("var",), self.var, True

    def forward(self, x):
        if not self.training:
            return batch_norm2d_eval(x, self.gamma, self.beta, self.mean,
                                     self.var, self.eps)
        y, mean, var = batch_norm2d_train(x, self.gamma, self.beta, self.mean,
                                          self.var, self.eps, self.momentum,
                                          self.mesh)
        if self.defer_update:
            self.pending = (mean, var)
        else:
            self.mean.copy_(mean)
            self.var.copy_(var)
        return y


class Dropout(Layer):
    """Channel dropout (``ops/dropout.py``) in one of its ``compat`` modes.
    In training the two random modes draw a permutation of the channels
    from ``generator``, or take ``perm``, one drawn ahead.

    ``channel_cut``: the mesh whose ``'model'`` rank holds a slice of the
    channels (between a pipelined trunk's column and row convs,
    ``Conv2D.pipe_tp``): the mask is the whole layer's, from ``perm`` over
    every channel, and this rank applies its slice of it."""
    draws = True
    channel_cut = None

    def __init__(self, name, p=0.5, compat="inverted"):
        super().__init__(name)
        self.p, self.compat = p, compat

    @property
    def random(self) -> bool:
        return self.p > 0 and self.compat != "reference"

    def forward(self, x, generator=None, perm=None):
        if self.training and self.random and perm is None:
            if generator is None:
                raise ValueError(f"{self.name}: {self.compat} dropout needs "
                                 "a generator in training")
            perm = dropout_ops.draw_permutation(x.shape[-1], generator)
        if self.channel_cut is not None and self.p > 0.0:
            c = x.shape[-1]
            lo = self.channel_cut.index("model") * c
            mask = dropout_ops.channel_dropout(
                x.new_ones(c * self.channel_cut.size("model")), self.p,
                train=self.training, perm=perm, compat=self.compat)
            return x * mask[lo:lo + c]
        return dropout_ops.channel_dropout(x, self.p, train=self.training,
                                           perm=perm, compat=self.compat)


class ResidualBlock(Layer):
    """``relu(body(x) + shortcut(x))``: ``body`` a Sequential, the shortcut
    the identity or ``proj``, a 1x1 strided Conv2D where the shape changes
    (``cnn_tpu/nn/module.py:ResidualBlock``). Params nest as ``{"body":
    ..., "proj": ...}``, BN state as ``{"body": ...}``."""
    casts = True
    draws = True

    def __init__(self, name, body, proj=None):
        super().__init__(name)
        self.body = body
        self.proj = proj

    def tree_leaves(self):
        for path, t, is_state in self.body.tree_leaves():
            yield ("body", *path), t, is_state
        if self.proj is not None:
            for path, t, is_state in self.proj.tree_leaves():
                yield ("proj", *path), t, is_state

    def plan_rows(self, h):
        self.rows = h
        if self.proj is not None:
            self.proj.plan_rows(h)
        return self.body.plan_rows(h)

    def forward(self, x, compute_dtype=None, generator=None, perms=None):
        y = self.body(x, compute_dtype=compute_dtype, generator=generator,
                      perms=perms)
        return self.combine(y, self.shortcut(x, compute_dtype))

    def shortcut(self, x, compute_dtype=None):
        return x if self.proj is None else self.proj(
            x, compute_dtype=compute_dtype)

    @staticmethod
    def combine(y, sc):
        return relu(y + sc)


REMAT_MODES = (False, True, "full", "conv")


def _save_convs(ctx, op, *args, **kwargs):
    """The ``remat='conv'`` policy, ``cnn_tpu``'s
    ``save_only_these_names("conv_out", "bn_stats")``: keep each conv's
    output and BN's batch moments, recompute the rest."""
    if op in (torch.ops.cnn_tpu_torch.conv2d_bias_relu.default,
              torch.ops.aten.var_mean.correction):
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


class StackedBlocks(Layer):
    """``n_blocks`` structurally identical blocks applied in turn
    (``cnn_tpu``'s scan over layers). Every block's params and BN state are
    stacked with a leading [L] axis, registered here under their tree paths
    (``body/b_conv1/w`` of shape [L,3,3,C,C]), and block i runs ``block``'s
    layers on slice i through ``torch.func.functional_call``. ``block``
    itself is a template kept on the meta device: it holds no values.

    In training BN's new moving statistics come back from each block call
    and are written into slice i once, after it; random Dropouts draw their
    permutations for every block before the first, in block order, and
    take them as arguments. A recomputed block therefore updates nothing
    twice and draws nothing again.

    ``remat`` (training with a gradient asked for): False keeps every
    activation; True or 'full' wraps each block in
    ``torch.utils.checkpoint`` (the backward recomputes it); 'conv' is the
    selective policy of ``cnn_tpu``'s ``remat='conv'``: the block's convs
    launch through the custom op ``cnn_tpu_torch::conv2d_bias_relu``, whose
    outputs (and BN's batch moments) the checkpoint keeps, so the backward
    recomputes only the elementwise tail and never a conv. The three give
    the same gradients and statistics, bit for bit."""
    casts = True
    draws = True

    def __init__(self, name, blocks, remat=False):
        """``blocks``: the L initialised blocks (e.g. ``ResidualBlock``s),
        whose tensors are stacked."""
        super().__init__(name)
        if remat not in REMAT_MODES:
            raise ValueError(f"{name}: remat {remat!r} is not one of "
                             f"{REMAT_MODES}")
        self.n_blocks, self.remat = len(blocks), remat
        leaves = [list(b.tree_leaves()) for b in blocks]
        template = blocks[0]
        torch_name = {id(t): n for n, t in (*template.named_parameters(),
                                            *template.named_buffers())}
        # (registered key, name in the template, is_state)
        self._leaves = []
        for j, (path, t, is_state) in enumerate(leaves[0]):
            key = "/".join(path)
            stack = torch.stack([lv[j][1].detach() for lv in leaves])
            if is_state:
                self.register_buffer(key, stack)
            else:
                self.register_parameter(key, nn.Parameter(stack))
            self._leaves.append((key, torch_name[id(t)], is_state))
        layers = list(template.modules())
        bns = [m for m in layers if isinstance(m, BatchNorm2D)]
        # the BN layer and statistic (0 mean, 1 var) behind each state leaf
        owner = {}
        for m in bns:
            owner[id(m.mean)], owner[id(m.var)] = (m, 0), (m, 1)
        self._state_of = [owner[id(t)] for _, t, st in leaves[0] if st]
        self._drops = [m for m in layers if isinstance(m, Dropout)]
        for m in bns:
            m.defer_update = True
        if remat == "conv":
            for m in layers:
                if isinstance(m, Conv2D):
                    m.named_op = True
        # kept out of the module tree: only its structure is used
        object.__setattr__(self, "block", template.to("meta"))

    def tree_leaves(self):
        for key, _, is_state in self._leaves:
            yield tuple(key.split("/")), getattr(self, key), is_state

    def plan_rows(self, h):
        self.rows = h
        return self.block.plan_rows(h)    # every block alike

    def _run(self, perms, compute_dtype, x, *tensors):
        """One block on ``tensors`` (its slices, in ``_leaves`` order);
        returns its output and, in training, BN's new statistics in the
        order of the state leaves."""
        bound = {name: t for (_, name, _), t in zip(self._leaves, tensors)}
        y = torch.func.functional_call(
            self.block, bound, (x,),
            {"compute_dtype": compute_dtype, "perms": perms}, strict=True)
        if not self.training:
            return (y,)
        return (y, *[bn.pending[i] for bn, i in self._state_of])

    def forward(self, x, compute_dtype=None, generator=None, perms=None):
        drawn = (self.draw_perms(generator) if self.training
                 else [{}] * self.n_blocks)
        return self.run_blocks(x, range(self.n_blocks), drawn, compute_dtype)

    def draw_perms(self, generator) -> list:
        """Every block's Dropout permutations (``{name: perm}`` a block),
        drawn from ``generator`` in block order, as a training forward
        draws them."""
        drawn = [{} for _ in range(self.n_blocks)]
        for i in range(self.n_blocks):
            for d in self._drops:
                if d.random:
                    if generator is None:
                        raise ValueError(f"{self.name}: {d.name} needs a "
                                         "generator in training")
                    drawn[i][d.name] = dropout_ops.draw_permutation(
                        self._channels(d), generator)
        return drawn

    def run_blocks(self, x, rows, drawn, compute_dtype=None, *,
                   remat: bool = True, write_state: bool = True):
        """The blocks on ``rows`` of the stacked tensors in turn, block
        ``rows[j]`` with the permutations ``drawn[j]`` (``forward``: every
        row; a pipeline stage: its rows, ``parallel/pipeline.py``). In
        training each block's new BN statistics go into its row, unless
        ``write_state`` is False (a recompute); ``remat`` False runs
        without the checkpoint whatever the layer's mode."""
        self.block.train(self.training)
        states = [getattr(self, key) for key, _, st in self._leaves if st]
        remat = (remat and self.training and self.remat is not False
                 and torch.is_grad_enabled())
        for i, perms in zip(rows, drawn):
            # a checkpoint keeps its inputs for the recompute: the state
            # slices go in as copies, so that writing slice i below leaves
            # them as they were
            tensors = [getattr(self, key)[i].clone() if st and remat
                       else getattr(self, key)[i]
                       for key, _, st in self._leaves]
            run = functools.partial(self._run, perms, compute_dtype)
            # the block draws nothing (its permutations are drawn above), so
            # the checkpoint keeps no generator state: a CUDA graph, which
            # cannot read one, captures it
            if not remat:
                out = run(x, *tensors)
            elif self.remat == "conv":
                out = torch_checkpoint.checkpoint(
                    run, x, *tensors, use_reentrant=False,
                    preserve_rng_state=False,
                    context_fn=functools.partial(
                        torch_checkpoint.create_selective_checkpoint_contexts,
                        _save_convs))
            else:
                out = torch_checkpoint.checkpoint(run, x, *tensors,
                                                  use_reentrant=False,
                                                  preserve_rng_state=False)
            x = out[0]
            if self.training and write_state:
                with torch.no_grad():
                    for stack, new in zip(states, out[1:]):
                        stack[i].copy_(new)
        return x

    def block_at(self, i: int) -> Layer:
        """Block ``i`` as a module of its own, holding copies of slice i of
        the stacked tensors (which no gradient reaches), in this layer's
        mode (Grad-CAM's capture inside the trunk)."""
        device = getattr(self, self._leaves[0][0]).device
        block = copy.deepcopy(self.block).to_empty(device=device)
        with torch.no_grad():
            for key, name, is_state in self._leaves:
                dst = (block.get_buffer(name) if is_state
                       else block.get_parameter(name))
                dst.copy_(getattr(self, key)[i])
        return block.requires_grad_(False).train(self.training)

    def _channels(self, dropout) -> int:
        """The channels a Dropout of the block sees: the output channels
        of the conv before it."""
        prev = None
        for m in self.block.modules():
            if m is dropout:
                return prev.out_channels
            if isinstance(m, Conv2D):
                prev = m
        raise ValueError(f"{dropout.name}: no conv before it in the block")
