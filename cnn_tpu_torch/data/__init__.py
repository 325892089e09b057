from cnn_tpu_torch.data.augment import ImageAugmentor  # noqa: F401
from cnn_tpu_torch.data.dataset import discover_dataset, split_dataset  # noqa: F401
from cnn_tpu_torch.data.device_dataset import (  # noqa: F401
    DeviceDataset,
    make_device_train_step,
)
from cnn_tpu_torch.data.loader import DataLoader  # noqa: F401
