from cnn_tpu_torch.data.device_dataset import (  # noqa: F401
    DeviceDataset,
    make_device_train_step,
)
