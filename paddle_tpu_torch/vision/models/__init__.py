"""The vision zoo (counterpart of ``paddle_tpu/vision/models``): the
ResNets, MobileNet v1/v2/v3, the small nets (LeNet, AlexNet, VGG,
SqueezeNet) and the big nets (DenseNet, GoogLeNet, InceptionV3,
ShuffleNetV2). Every factory builds on the card unless ``device=`` names
another device, its weights drawn from ``seed=``."""
from .big_nets import (
    DenseNet,
    GoogLeNet,
    InceptionV3,
    ShuffleNetV2,
    densenet121,
    densenet161,
    densenet169,
    densenet201,
    densenet264,
    googlenet,
    inception_v3,
    shufflenet_v2_x0_5,
    shufflenet_v2_x0_25,
    shufflenet_v2_x1_0,
    shufflenet_v2_x1_5,
    shufflenet_v2_x2_0,
)
from .mobilenet import (
    MobileNetV1,
    MobileNetV2,
    MobileNetV3Large,
    MobileNetV3Small,
    mobilenet_v1,
    mobilenet_v2,
    mobilenet_v3_large,
    mobilenet_v3_small,
)
from .resnet import (
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
    wide_resnet50_2,
    wide_resnet101_2,
)
from .small_nets import (
    AlexNet,
    LeNet,
    SqueezeNet,
    VGG,
    alexnet,
    squeezenet1_0,
    squeezenet1_1,
    vgg11,
    vgg13,
    vgg16,
    vgg19,
)

__all__ = [
    "ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
    "resnet152", "wide_resnet50_2", "wide_resnet101_2",
    "MobileNetV1", "MobileNetV2", "MobileNetV3Small", "MobileNetV3Large",
    "mobilenet_v1", "mobilenet_v2", "mobilenet_v3_small",
    "mobilenet_v3_large",
    "LeNet", "AlexNet", "VGG", "SqueezeNet", "alexnet",
    "vgg11", "vgg13", "vgg16", "vgg19", "squeezenet1_0", "squeezenet1_1",
    "DenseNet", "densenet121", "densenet161", "densenet169",
    "densenet201", "densenet264", "GoogLeNet", "googlenet",
    "ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_5",
    "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
    "InceptionV3", "inception_v3",
]
