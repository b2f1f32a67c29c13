"""Vision models (port of paddle_tpu/vision/models): LeNet, the ResNet
family, VGG and MobileNet V1/V2.  Each model's constructor takes
``device`` (None = the CUDA card, raising without one; the tests pass
"cpu"): its parameters are drawn on the CPU from the framework generator
and then moved there."""
from .lenet import LeNet  # noqa: F401
from .mobilenetv1 import MobileNetV1, mobilenet_v1  # noqa: F401
from .mobilenetv2 import MobileNetV2, mobilenet_v2  # noqa: F401
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     resnet18, resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, wide_resnet50_2)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
