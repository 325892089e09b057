from cnn_tpu_torch.core.config import DataConfig, ModelConfig, TrainConfig  # noqa: F401
from cnn_tpu_torch.core.rng import RngStream  # noqa: F401
