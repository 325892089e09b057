"""ResNet family (resnet10, resnet18), counterpart of
``cnn_tpu/models/resnet.py``: a padded stride-2 stem conv, residual blocks
of two padded 3x3 convs with BN (a 1x1 strided projection shortcut where
the shape changes), global average pool, linear. BN is intrinsic to the
family. Layer names are ``cnn_tpu``'s, so its param trees load as they
are (``block_2/body/block_2_conv1/w``, ``block_2/proj/w``)."""

from __future__ import annotations

from cnn_tpu_torch.models.base import SequentialModel, init_args
from cnn_tpu_torch.models.registry import register_model
from cnn_tpu_torch.nn import (BatchNorm2D, Conv2D, GlobalAvgPool, Linear, ReLU,
                              ResidualBlock, Sequential)

# (channels, stride) per block; stride-2 blocks halve the spatial extent
CONFIGS = {
    "resnet10": ((16, 1), (32, 2), (64, 2), (128, 2)),
    "resnet18": ((32, 1), (32, 1), (64, 2), (64, 1),
                 (128, 2), (128, 1), (256, 2), (256, 1)),
}


def _block(name, cin, cout, stride, device, gen) -> ResidualBlock:
    body = Sequential([
        Conv2D(f"{name}_conv1", cin, cout, 3, stride, padding=1,
               device=device, generator=gen),
        BatchNorm2D(f"{name}_bn1", cout, device=device),
        ReLU(f"{name}_relu"),
        Conv2D(f"{name}_conv2", cout, cout, 3, 1, padding=1,
               device=device, generator=gen),
        BatchNorm2D(f"{name}_bn2", cout, device=device),
    ])
    proj = None
    if stride != 1 or cin != cout:
        proj = Conv2D(f"{name}_proj", cin, cout, 1, stride, padding=0,
                      device=device, generator=gen)
    return ResidualBlock(name, body, proj)


class ResNet(SequentialModel):
    def __init__(self, depth: str = "resnet10", num_classes: int = 3,
                 batch_norm: bool = True, image_size: int = 224, *,
                 device=None, generator=None):
        del batch_norm  # BN is intrinsic to the family
        super().__init__(num_classes, image_size)
        device, gen = init_args(device, generator)
        cfg = CONFIGS[depth]
        cin = cfg[0][0]
        layers = [
            Conv2D("stem_conv", 3, cin, 3, 2, padding=1, device=device,
                   generator=gen),
            BatchNorm2D("stem_bn", cin, device=device),
            ReLU("stem_relu"),
        ]
        for i, (cout, stride) in enumerate(cfg, 1):
            layers.append(_block(f"block_{i}", cin, cout, stride, device, gen))
            cin = cout
        layers.append(GlobalAvgPool("gap"))
        layers.append(Linear("linear_1", cin, num_classes, device=device,
                             generator=gen))
        self.net = Sequential(layers)


@register_model("resnet10")
def _resnet10(**kwargs) -> ResNet:
    kwargs.pop("dropout", None)
    return ResNet("resnet10", **kwargs)


@register_model("resnet18")
def _resnet18(**kwargs) -> ResNet:
    kwargs.pop("dropout", None)
    return ResNet("resnet18", **kwargs)
