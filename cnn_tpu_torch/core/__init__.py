from cnn_tpu_torch.core.config import DataConfig, ModelConfig, TrainConfig  # noqa: F401
