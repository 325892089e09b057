"""Sequential container, counterpart of ``cnn_tpu/nn/sequential.py``.

Layers are kept in order under the same names as in ``cnn_tpu`` (the keys of
its param and state trees). A Conv2D directly followed by a ReLU runs as one
fused ``relu=True`` conv launch, the fusion the conv kernel exists for; in
training its autograd Function keeps the output for the ReLU mask, as
``_vjp_bwd`` does. With BN in between, the conv runs ``relu=False`` and BN
and ReLU follow as plain tensor ops.

``forward(x, compute_dtype=)`` threads the compute dtype to the layers that
cast (Conv2D, Linear), as ``cnn_tpu``'s ``apply(compute_dtype=)`` threads it
to every layer.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from cnn_tpu_torch.nn.module import Conv2D, Layer, Linear, ReLU


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

    def forward(self, x, compute_dtype=None):
        layers = list(self.layers.values())
        i = 0
        while i < len(layers):
            layer = layers[i]
            fuse = (isinstance(layer, Conv2D) and i + 1 < len(layers)
                    and isinstance(layers[i + 1], ReLU))
            kw = {"relu": True} if fuse else {}
            if compute_dtype is not None and isinstance(layer, (Conv2D,
                                                                Linear)):
                kw["compute_dtype"] = compute_dtype
            x = layer(x, **kw)
            i += 2 if fuse else 1
        return x
