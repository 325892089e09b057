from cnn_tpu_torch.nn.module import (  # noqa: F401
    AvgPool2D,
    BatchNorm2D,
    Conv2D,
    DepthwiseConv2D,
    Dropout,
    Flatten,
    GlobalAvgPool,
    Layer,
    Linear,
    MaxPool2D,
    ReLU,
    ResidualBlock,
    StackedBlocks,
)
from cnn_tpu_torch.nn.sequential import Sequential  # noqa: F401
from cnn_tpu_torch.nn.moe import MoEBlock  # noqa: F401
