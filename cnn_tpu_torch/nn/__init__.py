from cnn_tpu_torch.nn.module import (  # noqa: F401
    BatchNorm2D,
    Conv2D,
    Dropout,
    Flatten,
    Layer,
    Linear,
    MaxPool2D,
    ReLU,
)
from cnn_tpu_torch.nn.sequential import Sequential  # noqa: F401
