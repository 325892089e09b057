"""PipeCNN, counterpart of ``cnn_tpu/models/pipecnn.py``: a stem of two
padded stride-2 convs, a trunk of ``n_blocks`` identical residual blocks
held as one ``StackedBlocks`` (params and BN state stacked with a leading
[L] axis: ``trunk/body/b_conv1/w`` [L,3,3,C,C]), global average pool,
linear. ``remat`` defaults to 'conv', ``cnn_tpu``'s default. Without BN
the block's last conv starts at zero (``init_scale`` 0: the trunk starts
as the identity, stable at any depth), and the block's first conv runs
fused with its ReLU."""

from __future__ import annotations

from cnn_tpu_torch.models.base import SequentialModel, init_args
from cnn_tpu_torch.models.registry import register_model
from cnn_tpu_torch.nn import (BatchNorm2D, Conv2D, Dropout, GlobalAvgPool,
                              Linear, ReLU, ResidualBlock, Sequential,
                              StackedBlocks)


def _trunk_block(width, batch_norm, dropout, device, gen) -> ResidualBlock:
    last_scale = 0.1 if batch_norm else 0.0
    layers = [Conv2D("b_conv1", width, width, 3, 1, padding=1,
                     device=device, generator=gen)]
    if batch_norm:
        layers.append(BatchNorm2D("b_bn1", width, device=device))
    layers.append(ReLU("b_relu"))
    if dropout > 0.0:
        layers.append(Dropout("b_dropout", p=dropout))
    layers.append(Conv2D("b_conv2", width, width, 3, 1, padding=1,
                         init_scale=last_scale, device=device,
                         generator=gen))
    if batch_norm:
        layers.append(BatchNorm2D("b_bn2", width, device=device))
    return ResidualBlock("block", Sequential(layers))


class PipeCNN(SequentialModel):
    def __init__(self, num_classes: int = 3, width: int = 64,
                 n_blocks: int = 8, image_size: int = 224,
                 batch_norm: bool = True, remat="conv",
                 dropout: float = 0.0, *, device=None, generator=None):
        super().__init__(num_classes, image_size)
        device, gen = init_args(device, generator)
        self.width, self.n_blocks = width, n_blocks

        def bn(name):
            return ([BatchNorm2D(name, width, device=device)] if batch_norm
                    else [])

        stem = [Conv2D("stem_conv1", 3, width, 3, 2, padding=1,
                       device=device, generator=gen),
                *bn("stem_bn1"), ReLU("stem_relu1"),
                Conv2D("stem_conv2", width, width, 3, 2, padding=1,
                       device=device, generator=gen),
                *bn("stem_bn2"), ReLU("stem_relu2")]
        trunk = StackedBlocks("trunk", [
            _trunk_block(width, batch_norm, dropout, device, gen)
            for _ in range(n_blocks)], remat=remat)
        head = [GlobalAvgPool("gap"),
                Linear("linear_1", width, num_classes, device=device,
                       generator=gen)]
        self.net = Sequential(stem + [trunk] + head)


@register_model("pipecnn")
def _pipecnn(**kwargs) -> PipeCNN:
    return PipeCNN(**kwargs)
