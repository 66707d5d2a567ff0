"""MobileNet v1, v2 and v3 (small, large) (counterpart of
``paddle_tpu/vision/models/mobilenet.py``).

The classes, their layer tables and their state dicts' names are the JAX
package's, so a JAX state dict loads with ``set_state_dict``. Like every
port layer they are built on the CPU; the factories (``mobilenet_v2(...,
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
    "MobileNetV1", "MobileNetV2", "MobileNetV3Small", "MobileNetV3Large",
    "mobilenet_v1", "mobilenet_v2", "mobilenet_v3_small",
    "mobilenet_v3_large",
]


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNAct(nn.Sequential):
    def __init__(self, cin, cout, kernel=3, stride=1, groups=1,
                 act=nn.ReLU6, dilation=1):
        padding = (kernel - 1) // 2 * dilation
        layers = [
            nn.Conv2D(cin, cout, kernel, stride=stride, padding=padding,
                      groups=groups, dilation=dilation, bias_attr=False),
            nn.BatchNorm2D(cout),
        ]
        if act is not None:
            layers.append(act())
        super().__init__(*layers)


# ---- v1: plain depthwise-separable stacks (mobilenetv1.py) ---------------
class _DepthwiseSep(nn.Sequential):
    def __init__(self, cin, cout, stride):
        super().__init__(
            ConvBNAct(cin, cin, 3, stride, groups=cin, act=nn.ReLU),
            ConvBNAct(cin, cout, 1, 1, act=nn.ReLU),
        )


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(8, int(ch * scale))

        cfg = [  # (out, stride)
            (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
            (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
            (1024, 1),
        ]
        feats = [ConvBNAct(3, c(32), 3, 2, act=nn.ReLU)]
        cin = c(32)
        for cout, s in cfg:
            feats.append(_DepthwiseSep(cin, c(cout), s))
            cin = c(cout)
        self.features = nn.Sequential(*feats)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(cin, num_classes)
        self._out_ch = cin

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:

            x = self.fc(F.flatten(x, 1))
        return x


# ---- v2: inverted residual with linear bottleneck (mobilenetv2.py) -------
class InvertedResidual(nn.Layer):
    def __init__(self, cin, cout, stride, expand_ratio):
        super().__init__()
        hidden = int(round(cin * expand_ratio))
        self.use_res = stride == 1 and cin == cout
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNAct(cin, hidden, 1))
        layers += [
            ConvBNAct(hidden, hidden, 3, stride, groups=hidden),
            # linear bottleneck: no activation after projection
            nn.Conv2D(hidden, cout, 1, bias_attr=False),
            nn.BatchNorm2D(cout),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [  # t, c, n, s
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
        ]
        cin = _make_divisible(32 * scale)
        feats = [ConvBNAct(3, cin, 3, 2)]
        for t, c, n, s in cfg:
            cout = _make_divisible(c * scale)
            for i in range(n):
                feats.append(
                    InvertedResidual(cin, cout, s if i == 0 else 1, t)
                )
                cin = cout
        last = _make_divisible(1280 * max(1.0, scale))
        feats.append(ConvBNAct(cin, last, 1))
        self.features = nn.Sequential(*feats)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(last, num_classes)
            )
        self._out_ch = last

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:

            x = self.classifier(F.flatten(x, 1))
        return x


# ---- v3: SE + hardswish search cells (mobilenetv3.py) --------------------
class SqueezeExcite(nn.Layer):
    def __init__(self, ch, squeeze=4):
        super().__init__()
        mid = _make_divisible(ch // squeeze)
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(ch, mid, 1)
        self.relu = nn.ReLU()
        self.fc2 = nn.Conv2D(mid, ch, 1)
        self.hsig = nn.Hardsigmoid()

    def forward(self, x):
        s = self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))
        return x * s


class _V3Block(nn.Layer):
    def __init__(self, cin, mid, cout, kernel, stride, use_se, act):
        super().__init__()
        self.use_res = stride == 1 and cin == cout
        layers = []
        if mid != cin:
            layers.append(ConvBNAct(cin, mid, 1, act=act))
        layers.append(ConvBNAct(mid, mid, kernel, stride, groups=mid,
                                act=act))
        if use_se:
            layers.append(SqueezeExcite(mid))
        layers += [
            nn.Conv2D(mid, cout, 1, bias_attr=False),
            nn.BatchNorm2D(cout),
        ]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


_V3_LARGE = [  # kernel, mid, out, se, act, stride
    (3, 16, 16, False, nn.ReLU, 1),
    (3, 64, 24, False, nn.ReLU, 2),
    (3, 72, 24, False, nn.ReLU, 1),
    (5, 72, 40, True, nn.ReLU, 2),
    (5, 120, 40, True, nn.ReLU, 1),
    (5, 120, 40, True, nn.ReLU, 1),
    (3, 240, 80, False, nn.Hardswish, 2),
    (3, 200, 80, False, nn.Hardswish, 1),
    (3, 184, 80, False, nn.Hardswish, 1),
    (3, 184, 80, False, nn.Hardswish, 1),
    (3, 480, 112, True, nn.Hardswish, 1),
    (3, 672, 112, True, nn.Hardswish, 1),
    (5, 672, 160, True, nn.Hardswish, 2),
    (5, 960, 160, True, nn.Hardswish, 1),
    (5, 960, 160, True, nn.Hardswish, 1),
]
_V3_SMALL = [
    (3, 16, 16, True, nn.ReLU, 2),
    (3, 72, 24, False, nn.ReLU, 2),
    (3, 88, 24, False, nn.ReLU, 1),
    (5, 96, 40, True, nn.Hardswish, 2),
    (5, 240, 40, True, nn.Hardswish, 1),
    (5, 240, 40, True, nn.Hardswish, 1),
    (5, 120, 48, True, nn.Hardswish, 1),
    (5, 144, 48, True, nn.Hardswish, 1),
    (5, 288, 96, True, nn.Hardswish, 2),
    (5, 576, 96, True, nn.Hardswish, 1),
    (5, 576, 96, True, nn.Hardswish, 1),
]


class _MobileNetV3(nn.Layer):
    def __init__(self, cfg, last_conv, last_fc, scale=1.0,
                 num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return _make_divisible(ch * scale)

        cin = c(16)
        feats = [ConvBNAct(3, cin, 3, 2, act=nn.Hardswish)]
        for k, mid, cout, se, act, s in cfg:
            feats.append(_V3Block(cin, c(mid), c(cout), k, s, se, act))
            cin = c(cout)
        feats.append(ConvBNAct(cin, c(last_conv), 1, act=nn.Hardswish))
        self.features = nn.Sequential(*feats)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(c(last_conv), last_fc),
                nn.Hardswish(),
                nn.Dropout(0.2),
                nn.Linear(last_fc, num_classes),
            )
        self._out_ch = c(last_conv)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:

            x = self.classifier(F.flatten(x, 1))
        return x


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_V3_SMALL, 576, 1024, scale, num_classes,
                         with_pool)


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_V3_LARGE, 960, 1280, scale, num_classes,
                         with_pool)



def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return _build(MobileNetV1, pretrained, scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return _build(MobileNetV2, pretrained, scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    return _build(MobileNetV3Small, pretrained, scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    return _build(MobileNetV3Large, pretrained, scale=scale, **kwargs)
