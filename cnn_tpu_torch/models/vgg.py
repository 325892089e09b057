"""VGG family (vgg8, vgg11), counterpart of ``cnn_tpu/models/vgg.py``:
padded stride-1 3x3 convs (each with BN when ``batch_norm``, then ReLU:
without BN the conv and its ReLU run as one fused launch), 2x2 max pools,
global average pool, linear."""

from __future__ import annotations

from cnn_tpu_torch.models.base import SequentialModel, init_args
from cnn_tpu_torch.models.registry import register_model
from cnn_tpu_torch.nn import (BatchNorm2D, Conv2D, GlobalAvgPool, Linear,
                              MaxPool2D, ReLU, Sequential)

# channels per stage; 'M' = 2x2 maxpool
CONFIGS = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg8": (32, "M", 64, "M", 128, 128, "M", 256, 256, "M"),
}


class VGG(SequentialModel):
    def __init__(self, depth: str = "vgg8", num_classes: int = 3,
                 batch_norm: bool = True, image_size: int = 224, *,
                 device=None, generator=None):
        super().__init__(num_classes, image_size)
        device, gen = init_args(device, generator)
        layers = []
        cin, conv_i = 3, 0
        for item in CONFIGS[depth]:
            if item == "M":
                layers.append(MaxPool2D(f"pool_{conv_i}"))
                continue
            conv_i += 1
            layers.append(Conv2D(f"conv_{conv_i}", cin, item, 3, 1,
                                 padding=1, device=device, generator=gen))
            if batch_norm:
                layers.append(BatchNorm2D(f"bn_{conv_i}", item,
                                          device=device))
            layers.append(ReLU(f"relu_{conv_i}"))
            cin = item
        layers.append(GlobalAvgPool("gap"))
        layers.append(Linear("linear_1", cin, num_classes, device=device,
                             generator=gen))
        self.net = Sequential(layers)


@register_model("vgg8")
def _vgg8(**kwargs) -> VGG:
    kwargs.pop("dropout", None)
    return VGG("vgg8", **kwargs)


@register_model("vgg11")
def _vgg11(**kwargs) -> VGG:
    kwargs.pop("dropout", None)
    return VGG("vgg11", **kwargs)
