"""Layers, counterparts of ``cnn_tpu/nn/module.py``, as ``nn.Module``s.

Parameters keep ``cnn_tpu``'s names and layouts (conv ``w`` [k,k,Cin,Cout]
HWIO and ``b``; dense ``w`` [in,out] and ``b``; BN ``gamma``/``beta`` with
``mean``/``var`` buffers), so a ``cnn_tpu`` param tree loads as it is
(``utils/checkpoint.py:load_jax_params``). Activations are NHWC.

Conv2D and MaxPool2D go through the kernels in ``ops/hopper``: the CUDA
kernel for a CUDA tensor, the plain version for a CPU tensor. When a
gradient is asked for, they call the kernels' autograd Functions
(``conv2d_bias_relu_fn``, ``max_pool2d_fn``), whose backward is the conv's
ATen gradients and the pool backward kernel; otherwise the bare wrappers.
BatchNorm2D normalizes by batch statistics in training mode and updates its
moving statistics in place. Dropout (``ops/dropout.py``) draws its channels
in training mode from the generator its ``forward`` is given, as
``cnn_tpu``'s layer draws from the key folded in for it.

Under a compute dtype (``forward(..., compute_dtype=torch.bfloat16)``, as
``cnn_tpu``'s ``apply(compute_dtype=)``) the parameters stay float32 and
Conv2D and Linear cast their input and weights to it at each call (the
conv's bias too: its kernel reads the bf16 bias into float32, as
``cnn_tpu/ops/conv.py`` casts it to the output's dtype). Autograd carries
the gradients back through the casts into the float32 parameters. BN keeps
float32 statistics and returns its input's dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from cnn_tpu_torch.ops.activations import relu
from cnn_tpu_torch.ops import dropout as dropout_ops
from cnn_tpu_torch.ops.batchnorm import batch_norm2d_eval, batch_norm2d_train
from cnn_tpu_torch.ops.hopper.conv import conv2d_bias_relu, conv2d_bias_relu_fn
from cnn_tpu_torch.ops.hopper.pool import max_pool2d_fn, max_pool2d_fwd
from cnn_tpu_torch.ops.linear import linear


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _normal(shape, generator, device) -> nn.Parameter:
    """N(0, 1) / 10, ``cnn_tpu``'s init for conv and dense weights."""
    return nn.Parameter(
        (torch.randn(shape, generator=generator) * 0.1).to(device))


class Layer(nn.Module):
    def __init__(self, name: str):
        super().__init__()
        self.name = name


class Conv2D(Layer):
    """VALID NHWC/HWIO conv + bias; ``forward(x, relu=True)`` fuses the ReLU."""

    def __init__(self, name, in_channels=3, out_channels=16, kernel_size=3,
                 stride=2, *, device=None, generator=None):
        super().__init__(name)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride = kernel_size, stride
        k = kernel_size
        self.w = _normal((k, k, in_channels, out_channels), generator, device)
        self.b = _normal((out_channels,), generator, device)

    def forward(self, x, relu: bool = False, compute_dtype=None):
        w, b = self.w, self.b
        if compute_dtype is not None:
            x, w, b = (x.to(compute_dtype), w.to(compute_dtype),
                       b.to(compute_dtype))
        if _wants_grad(x, w, b):
            return conv2d_bias_relu_fn(x, w, b, self.stride, relu)
        return conv2d_bias_relu(x, w, b, self.stride, relu)


class MaxPool2D(Layer):
    """2x2 stride-2 max pool, the window AlexNet uses and the kernel takes."""

    def forward(self, x):
        if _wants_grad(x):
            return max_pool2d_fn(x)
        return max_pool2d_fwd(x)


class ReLU(Layer):
    def forward(self, x):
        return relu(x)


class Flatten(Layer):
    """[B,H,W,C] -> [B, H*W*C], NHWC order."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Linear(Layer):
    def __init__(self, name, in_features=4608, out_features=3, *,
                 device=None, generator=None):
        super().__init__(name)
        self.in_features, self.out_features = in_features, out_features
        self.w = _normal((in_features, out_features), generator, device)
        self.b = _normal((out_features,), generator, device)

    def forward(self, x, compute_dtype=None):
        return linear(x, self.w, self.b, compute_dtype)


class BatchNorm2D(Layer):
    """Per-channel BN over NHWC: batch statistics in training mode (which
    also update ``mean``/``var`` in place), moving statistics in eval.
    The moving variance starts at 1, or at 0 with ``compat_zero_var_init``
    (the reference's own init)."""

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

    def forward(self, x):
        if not self.training:
            return batch_norm2d_eval(x, self.gamma, self.beta, self.mean,
                                     self.var, self.eps)
        y, mean, var = batch_norm2d_train(x, self.gamma, self.beta, self.mean,
                                          self.var, self.eps, self.momentum)
        self.mean.copy_(mean)
        self.var.copy_(var)
        return y


class Dropout(Layer):
    """Channel dropout (``ops/dropout.py``) in one of its ``compat`` modes.
    In training the two random modes draw a permutation of the channels
    from ``generator``."""

    def __init__(self, name, p=0.5, compat="inverted"):
        super().__init__(name)
        self.p, self.compat = p, compat

    def forward(self, x, generator=None):
        perm = None
        if self.training and self.p > 0 and self.compat != "reference":
            if generator is None:
                raise ValueError(f"{self.name}: {self.compat} dropout needs "
                                 "a generator in training")
            perm = dropout_ops.draw_permutation(x.shape[-1], generator)
        return dropout_ops.channel_dropout(x, self.p, train=self.training,
                                           perm=perm, compat=self.compat)
