"""AlexNet-style 4-conv classifier, counterpart of ``cnn_tpu/models/alexnet.py``.

    input  B x 224 x 224 x 3        (NHWC)
    conv1  3->16  k3 s2   -> 111    [+ BN] + ReLU
    maxpool k2 s2         -> 55
    conv2  16->32 k3 s2   -> 27     [+ BN] + ReLU
    conv3  32->64 k3 s2   -> 13     [+ BN] + ReLU
    conv4  64->128 k3 s2  -> 6      [+ BN] [+ Dropout] + ReLU
    linear 6*6*128=4608 -> num_classes

Layer names are ``cnn_tpu``'s, so its param trees and the reference ``.model``
files load as they are.
"""

from __future__ import annotations

import torch
from torch import nn

from cnn_tpu_torch import default_device
from cnn_tpu_torch.models.registry import register_model
from cnn_tpu_torch.nn import (BatchNorm2D, Conv2D, Dropout, Linear, MaxPool2D,
                              ReLU, Sequential)
from cnn_tpu_torch.nn.sequential import cut_rows


def build_alexnet(num_classes: int = 3, batch_norm: bool = False,
                  dropout: float = 0.0, image_size: int = 224,
                  compat_bn: bool = False, dropout_compat: str = "inverted",
                  space_to_depth: bool = False, *,
                  device=None, generator=None) -> Sequential:
    """The layer stack on ``device``. Conv and dense weights and biases are
    N(0, 1) / 10, ``cnn_tpu``'s init, drawn in layer order from
    ``generator`` (a CPU ``torch.Generator``; default: seed 0). BN starts at
    gamma 1, beta 0, moving mean 0 and variance 1 (0 with ``compat_bn``).
    ``dropout`` > 0 puts a channel Dropout in ``dropout_compat`` mode
    between conv4 (or its BN) and its ReLU. ``space_to_depth`` flags the
    convs with Cin < 32 (conv1 and conv2) ``Conv2D(s2d=True)``, which run
    as the stride-2 convs they are."""
    device = default_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    layers = []
    spatial = image_size
    channels = 3
    for i, (cin, cout) in enumerate([(3, 16), (16, 32), (32, 64), (64, 128)],
                                    start=1):
        layers.append(Conv2D(f"conv_layer_{i}", cin, cout, 3, 2,
                             s2d=space_to_depth and cin < 32,
                             device=device, generator=gen))
        spatial = (spatial - 3) // 2 + 1
        if spatial < 1:
            raise ValueError(
                f"image_size={image_size} collapses to zero spatial extent at "
                f"conv_layer_{i} (the stack needs >= 61 px)")
        channels = cout
        if batch_norm:
            layers.append(BatchNorm2D(f"bn_layer_{i}", cout,
                                      compat_zero_var_init=compat_bn,
                                      device=device))
        if i == 4 and dropout > 0.0:
            layers.append(Dropout("dropout_layer_1", p=dropout,
                                  compat=dropout_compat))
        layers.append(ReLU(f"relu_layer_{i}"))
        if i == 1:
            layers.append(MaxPool2D("max_pool_1"))
            spatial = (spatial - 2) // 2 + 1
    layers.append(Linear("linear_1", spatial * spatial * channels,
                         num_classes, device=device, generator=gen))
    return Sequential(layers)


class AlexNet(nn.Module):
    """``train()`` (the default of an ``nn.Module``) normalizes BN by batch
    statistics and updates the moving ones, and drops channels in a
    Dropout; ``eval()`` uses the moving statistics and, with no gradient
    asked for, runs the bare kernels."""

    def __init__(self, num_classes: int = 3, batch_norm: bool = False,
                 dropout: float = 0.0, image_size: int = 224,
                 compat_bn: bool = False, dropout_compat: str = "inverted",
                 space_to_depth: bool = False, *, device=None,
                 generator=None):
        super().__init__()
        self.num_classes = num_classes
        self.batch_norm = batch_norm
        self.image_size = image_size
        self.net = build_alexnet(num_classes, batch_norm, dropout, image_size,
                                 compat_bn, dropout_compat, space_to_depth,
                                 device=device, generator=generator)

    def forward(self, x, compute_dtype=None, generator=None, capture=None):
        """[B, S, S, 3] float -> logits [B, num_classes], in
        ``compute_dtype`` (e.g. ``torch.bfloat16``) when given; the
        parameters stay float32. ``generator`` feeds a training-mode
        Dropout; with ``capture`` (layer names) it returns ``(logits,
        {name: activation})`` (``Sequential.forward``)."""
        return self.net(cut_rows(self.net, x), compute_dtype=compute_dtype,
                        generator=generator, capture=capture)


@register_model("alexnet")
def _alexnet(**kwargs) -> AlexNet:
    return AlexNet(**kwargs)
