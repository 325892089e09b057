"""MobileNet family, counterpart of ``cnn_tpu/models/mobilenet.py``: a
padded stride-2 stem conv, then depthwise-separable blocks (a depthwise
3x3, ``ops/conv.py:depthwise_conv2d``, and a pointwise 1x1 conv on the
kernels), each followed by BN when ``batch_norm`` and ReLU; global average
pool, linear. ``width`` scales every channel count (at least 8)."""

from __future__ import annotations

from cnn_tpu_torch.models.base import SequentialModel, init_args
from cnn_tpu_torch.models.registry import register_model
from cnn_tpu_torch.nn import (BatchNorm2D, Conv2D, DepthwiseConv2D,
                              GlobalAvgPool, Linear, ReLU, Sequential)

# (out_channels, stride of the depthwise conv) per separable block
CONFIGS = {
    "mobilenet": ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2)),
}


class MobileNet(SequentialModel):
    def __init__(self, depth: str = "mobilenet", num_classes: int = 3,
                 batch_norm: bool = True, image_size: int = 224,
                 width: float = 1.0, *, device=None, generator=None):
        super().__init__(num_classes, image_size)
        device, gen = init_args(device, generator)

        def c(ch: int) -> int:
            return max(8, int(ch * width))

        def bn(name, ch):
            return ([BatchNorm2D(name, ch, device=device)] if batch_norm
                    else [])

        stem = c(32)
        layers = [Conv2D("conv_stem", 3, stem, 3, 2, padding=1,
                         device=device, generator=gen),
                  *bn("bn_stem", stem), ReLU("relu_stem")]
        cin = stem
        for i, (cout, stride) in enumerate(CONFIGS[depth], start=1):
            cout = c(cout)
            layers += [DepthwiseConv2D(f"dw_{i}", cin, kernel_size=3,
                                       stride=stride, padding=1,
                                       device=device, generator=gen),
                       *bn(f"bn_dw_{i}", cin), ReLU(f"relu_dw_{i}"),
                       Conv2D(f"pw_{i}", cin, cout, 1, 1, device=device,
                              generator=gen),
                       *bn(f"bn_pw_{i}", cout), ReLU(f"relu_pw_{i}")]
            cin = cout
        layers.append(GlobalAvgPool("gap"))
        layers.append(Linear("linear_1", cin, num_classes, device=device,
                             generator=gen))
        self.net = Sequential(layers)


@register_model("mobilenet")
def _mobilenet(**kwargs) -> MobileNet:
    kwargs.pop("dropout", None)
    return MobileNet("mobilenet", **kwargs)
