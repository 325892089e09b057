"""Sequential container, counterpart of ``cnn_tpu/nn/sequential.py``.

Layers are kept in order under the same names as in ``cnn_tpu`` (the keys of
its param and state trees). A Conv2D directly followed by a ReLU runs as one
fused ``relu=True`` conv launch, the fusion the conv kernel exists for; in
training its autograd Function keeps the output for the ReLU mask, as
``_vjp_bwd`` does. With BN in between, the conv runs ``relu=False`` and BN
and ReLU follow as plain tensor ops.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from cnn_tpu_torch.nn.module import Conv2D, Layer, ReLU


class Sequential(nn.Module):
    def __init__(self, layers: Sequence[Layer]):
        super().__init__()
        names = [l.name for l in layers]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate layer names: {names}")
        self.layers = nn.ModuleDict((l.name, l) for l in layers)

    def __iter__(self):
        return iter(self.layers.values())

    def __getitem__(self, name: str) -> Layer:
        return self.layers[name]

    def forward(self, x):
        layers = list(self.layers.values())
        i = 0
        while i < len(layers):
            layer = layers[i]
            fuse = (isinstance(layer, Conv2D) and i + 1 < len(layers)
                    and isinstance(layers[i + 1], ReLU))
            x = layer(x, relu=True) if fuse else layer(x)
            i += 2 if fuse else 1
        return x
