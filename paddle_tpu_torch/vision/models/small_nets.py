"""LeNet, AlexNet, VGG-11/13/16/19 (with and without batch norm) and
SqueezeNet 1.0/1.1 (counterpart of
``paddle_tpu/vision/models/small_nets.py``).

The classes, their layer tables and their state dicts' names are the JAX
package's, so a JAX state dict loads with ``set_state_dict``. Like every
port layer they are built on the CPU; the factories (``vgg16(...,
device=None, seed=0)``) draw the weights from a ``torch.Generator``
seeded with ``seed`` and move the model to ``device``, the card unless
it names another one. No pretrained weights ship: ``pretrained=True``
raises, as in the JAX package.
"""
from __future__ import annotations

import torch

from ... import nn
from ... import ops as F
from ._factory import _build

__all__ = [
    "LeNet", "AlexNet", "VGG", "SqueezeNet",
    "alexnet", "vgg11", "vgg13", "vgg16", "vgg19",
    "squeezenet1_0", "squeezenet1_1",
]


class LeNet(nn.Layer):
    """ref: vision/models/lenet.py — 1x28x28 MNIST topology."""

    def __init__(self, num_classes=10):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1), nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0), nn.ReLU(),
            nn.MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Linear(400, 120), nn.Linear(120, 84),
                nn.Linear(84, num_classes),
            )

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:

            x = self.fc(F.flatten(x, 1))
        return x


class AlexNet(nn.Layer):
    """ref: vision/models/alexnet.py."""

    def __init__(self, num_classes=1000, dropout=0.5):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, 2),
        )
        self.pool = nn.AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(dropout), nn.Linear(256 * 36, 4096), nn.ReLU(),
                nn.Dropout(dropout), nn.Linear(4096, 4096), nn.ReLU(),
                nn.Linear(4096, num_classes),
            )

    def forward(self, x):
        x = self.pool(self.features(x))
        if self.num_classes > 0:

            x = self.classifier(F.flatten(x, 1))
        return x


_VGG_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGG(nn.Layer):
    """ref: vision/models/vgg.py — VGG(features, num_classes)."""

    def __init__(self, features, num_classes=1000, batch_norm=False,
                 dropout=0.5):
        super().__init__()
        if isinstance(features, str):
            features = make_vgg_features(_VGG_CFGS[features], batch_norm)
        self.features = features
        self.num_classes = num_classes
        self.pool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 49, 4096), nn.ReLU(), nn.Dropout(dropout),
                nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(dropout),
                nn.Linear(4096, num_classes),
            )

    def forward(self, x):
        x = self.pool(self.features(x))
        if self.num_classes > 0:

            x = self.classifier(F.flatten(x, 1))
        return x


def make_vgg_features(cfg, batch_norm=False):
    from ...nn import initializer as I
    from ...nn.parameter import ParamAttr

    layers, cin = [], 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
            continue
        # Kaiming fan-out: 13 stacked ReLU convs vanish under the
        # default Xavier scaling (activations decay ~15x by the last
        # block; measured r5) — the reference/torchvision VGG recipe
        layers.append(nn.Conv2D(
            cin, v, 3, padding=1,
            weight_attr=ParamAttr(initializer=I.KaimingNormal(
                nonlinearity="relu")),
        ))
        if batch_norm:
            layers.append(nn.BatchNorm2D(v))
        layers.append(nn.ReLU())
        cin = v
    return nn.Sequential(*layers)


class _Fire(nn.Layer):
    def __init__(self, cin, squeeze, e1, e3):
        super().__init__()
        self.squeeze = nn.Sequential(nn.Conv2D(cin, squeeze, 1), nn.ReLU())
        self.expand1 = nn.Sequential(nn.Conv2D(squeeze, e1, 1), nn.ReLU())
        self.expand3 = nn.Sequential(
            nn.Conv2D(squeeze, e3, 3, padding=1), nn.ReLU()
        )

    def forward(self, x):

        s = self.squeeze(x)
        return torch.cat([self.expand1(s), self.expand3(s)], dim=1)


class SqueezeNet(nn.Layer):
    """ref: vision/models/squeezenet.py — version '1.0'/'1.1'."""

    def __init__(self, version="1.0", num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, 2),
                _Fire(96, 16, 64, 64), _Fire(128, 16, 64, 64),
                _Fire(128, 32, 128, 128), nn.MaxPool2D(3, 2),
                _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
                _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256),
                nn.MaxPool2D(3, 2), _Fire(512, 64, 256, 256),
            )
        else:
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, 2),
                _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64),
                nn.MaxPool2D(3, 2),
                _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128),
                nn.MaxPool2D(3, 2),
                _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
                _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256),
            )
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.5), nn.Conv2D(512, num_classes, 1), nn.ReLU(),
            )
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)

    def forward(self, x):

        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.pool(x)
        return F.flatten(x, 1)



def alexnet(pretrained=False, **kwargs):
    return _build(AlexNet, pretrained, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _build(VGG, pretrained, "A", batch_norm=batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _build(VGG, pretrained, "B", batch_norm=batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _build(VGG, pretrained, "D", batch_norm=batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _build(VGG, pretrained, "E", batch_norm=batch_norm, **kwargs)


def squeezenet1_0(pretrained=False, **kwargs):
    return _build(SqueezeNet, pretrained, "1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    return _build(SqueezeNet, pretrained, "1.1", **kwargs)
