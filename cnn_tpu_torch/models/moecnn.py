"""MoECNN, counterpart of ``cnn_tpu/models/moecnn.py``: a stem of four
padded stride-2 3x3 convs (3 -> width, then width -> width), each with BN
and ReLU, a global average pool, a Switch-style MoE block on the [B,
width] features (``nn/moe.py``), and a linear head."""

from __future__ import annotations

from cnn_tpu_torch.models.base import SequentialModel, init_args
from cnn_tpu_torch.models.registry import register_model
from cnn_tpu_torch.nn import (BatchNorm2D, Conv2D, GlobalAvgPool, Linear,
                              MoEBlock, ReLU, Sequential)


class MoECNN(SequentialModel):
    def __init__(self, num_classes: int = 3, width: int = 64,
                 n_experts: int = 8, expert_hidden: int = 256,
                 image_size: int = 224, batch_norm: bool = True,
                 capacity_factor: float = 2.0, balance_coeff: float = 0.0,
                 *, device=None, generator=None):
        super().__init__(num_classes, image_size)
        device, gen = init_args(device, generator)
        layers = []
        cin = 3
        for i in range(1, 5):
            layers.append(Conv2D(f"stem_conv{i}", cin, width, 3, 2,
                                 padding=1, device=device, generator=gen))
            if batch_norm:
                layers.append(BatchNorm2D(f"stem_bn{i}", width,
                                          device=device))
            layers.append(ReLU(f"stem_relu{i}"))
            cin = width
        layers += [
            GlobalAvgPool("gap"),
            MoEBlock("moe", dim=width, hidden=expert_hidden,
                     n_experts=n_experts, capacity_factor=capacity_factor,
                     balance_coeff=balance_coeff, device=device,
                     generator=gen),
            Linear("linear_1", width, num_classes, device=device,
                   generator=gen),
        ]
        self.net = Sequential(layers)


@register_model("moecnn")
def _moecnn(**kwargs) -> MoECNN:
    kwargs.pop("dropout", None)
    return MoECNN(**kwargs)
