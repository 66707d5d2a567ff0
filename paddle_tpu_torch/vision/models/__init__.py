"""Vision models: the ResNet family (counterpart of
``paddle_tpu/vision/models/resnet.py``). MobileNet, the small nets (LeNet,
AlexNet, VGG, SqueezeNet) and the big nets (DenseNet, GoogLeNet,
InceptionV3, ShuffleNetV2) are not ported yet (ROADMAP A11)."""
from .resnet import (
    BasicBlock,
    BottleneckBlock,
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
    wide_resnet50_2,
    wide_resnet101_2,
)

__all__ = [
    "ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
    "resnet152", "wide_resnet50_2", "wide_resnet101_2",
]
