from cnn_tpu_torch.models.alexnet import AlexNet, build_alexnet  # noqa: F401
from cnn_tpu_torch.models.registry import get_model, register_model  # noqa: F401
