from cnn_tpu_torch.models.alexnet import AlexNet, build_alexnet  # noqa: F401
from cnn_tpu_torch.models.registry import get_model, register_model  # noqa: F401
from cnn_tpu_torch.models.vgg import VGG  # noqa: F401
from cnn_tpu_torch.models.resnet import ResNet  # noqa: F401
from cnn_tpu_torch.models.pipecnn import PipeCNN  # noqa: F401
from cnn_tpu_torch.models.mobilenet import MobileNet  # noqa: F401
from cnn_tpu_torch.models.moecnn import MoECNN  # noqa: F401
