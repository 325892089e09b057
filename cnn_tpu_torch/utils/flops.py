"""Analytic FLOP counts from layer shapes (for MFU reporting), counterpart
of ``cnn_tpu/utils/flops.py`` with its conventions.

Per conv: forward = 2 * Ho * Wo * k^2 * Cin * Cout (MACs as two FLOPs);
the training step adds dW (the same count) and dx (the same, skipped for
the model's first parameterized layer, whose input gradient is never
needed). Dense layers likewise, the depthwise conv as its grouped MACs
(2 * Ho * Wo * k^2 * Cout). Elementwise layers (ReLU, BN, pools, the loss)
are not counted, and neither is ``MoEBlock``, as in ``cnn_tpu``. The walk
enters ``ResidualBlock`` (its body, then its projection on the block's
input shape) and ``StackedBlocks`` (its block, once per block).
"""

from __future__ import annotations

from cnn_tpu_torch.nn.module import (AvgPool2D, Conv2D, DepthwiseConv2D,
                                     Flatten, GlobalAvgPool, Linear,
                                     MaxPool2D, ResidualBlock, StackedBlocks)
from cnn_tpu_torch.ops.conv import conv_out_size


def _out_shape(layer, shape: tuple) -> tuple:
    """The (H, W, C) or (features,) shape after ``layer``."""
    if isinstance(layer, (Conv2D, DepthwiseConv2D)):
        h, w, _ = shape
        k, s, p = layer.kernel_size, layer.stride, layer.padding
        return (conv_out_size(h, k, s, p), conv_out_size(w, k, s, p),
                layer.out_channels)
    if isinstance(layer, (MaxPool2D, AvgPool2D)):
        h, w, c = shape
        k, s = layer.kernel_size, layer.stride
        return (conv_out_size(h, k, s), conv_out_size(w, k, s), c)
    if isinstance(layer, GlobalAvgPool):
        return (shape[-1],)
    if isinstance(layer, Flatten):
        n = 1
        for d in shape:
            n *= d
        return (n,)
    if isinstance(layer, Linear):
        return (layer.out_features,)
    if isinstance(layer, ResidualBlock):
        for sub in layer.body:
            shape = _out_shape(sub, shape)
        return shape
    return shape    # ReLU, BN, Dropout, StackedBlocks, MoEBlock


def _walk(layers, shape, total_fwd, total_train, first):
    for layer in layers:
        if isinstance(layer, (Conv2D, DepthwiseConv2D, Linear)):
            if isinstance(layer, Linear):
                f = 2.0 * layer.in_features * layer.out_features
            else:
                ho, wo, _ = _out_shape(layer, shape)
                cin = (1 if isinstance(layer, DepthwiseConv2D)
                       else layer.in_channels)
                f = 2.0 * ho * wo * layer.kernel_size ** 2 \
                    * cin * layer.out_channels
            total_fwd += f
            total_train += f * (2.0 if first else 3.0)
            first = False
        elif isinstance(layer, ResidualBlock):
            total_fwd, total_train, first, _ = _walk(
                layer.body, shape, total_fwd, total_train, first)
            if layer.proj is not None:  # on the block's input shape
                total_fwd, total_train, first, _ = _walk(
                    [layer.proj], shape, total_fwd, total_train, first)
        elif isinstance(layer, StackedBlocks):
            for _ in range(layer.n_blocks):
                total_fwd, total_train, first, _ = _walk(
                    [layer.block], shape, total_fwd, total_train, first)
        shape = _out_shape(layer, shape)
    return total_fwd, total_train, first, shape


def forward_flops_per_image(model) -> float:
    s = model.image_size
    fwd, _, _, _ = _walk(model.net, (s, s, 3), 0.0, 0.0, True)
    return fwd


def train_flops_per_image(model) -> float:
    s = model.image_size
    _, train, _, _ = _walk(model.net, (s, s, 3), 0.0, 0.0, True)
    return train
