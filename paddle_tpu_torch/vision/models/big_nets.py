"""DenseNet, GoogLeNet, ShuffleNetV2 and InceptionV3 (counterpart of
``paddle_tpu/vision/models/big_nets.py``).

The classes, their layer tables and their state dicts' names are the JAX
package's, so a JAX state dict loads with ``set_state_dict``. Like every
port layer they are built on the CPU; the factories (``densenet121(...,
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
    "DenseNet", "GoogLeNet", "ShuffleNetV2", "InceptionV3",
    "densenet121", "densenet161", "densenet169", "densenet201",
    "densenet264", "googlenet", "shufflenet_v2_x0_25",
    "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
    "shufflenet_v2_x2_0", "inception_v3",
]


def _flatten(x):
    return F.flatten(x, 1)


# ---- DenseNet -------------------------------------------------------------
class _DenseLayer(nn.Layer):
    def __init__(self, cin, growth, bn_size, dropout):
        super().__init__()
        self.norm1 = nn.BatchNorm2D(cin)
        self.relu = nn.ReLU()
        self.conv1 = nn.Conv2D(cin, bn_size * growth, 1, bias_attr=False)
        self.norm2 = nn.BatchNorm2D(bn_size * growth)
        self.conv2 = nn.Conv2D(bn_size * growth, growth, 3, padding=1,
                               bias_attr=False)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):

        out = self.conv1(self.relu(self.norm1(x)))
        out = self.conv2(self.relu(self.norm2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return torch.cat([x, out], dim=1)


class _Transition(nn.Sequential):
    def __init__(self, cin, cout):
        super().__init__(
            nn.BatchNorm2D(cin), nn.ReLU(),
            nn.Conv2D(cin, cout, 1, bias_attr=False),
            nn.AvgPool2D(2, 2),
        )


_DENSE_CFG = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
    264: (64, 32, [6, 12, 64, 48]),
}


class DenseNet(nn.Layer):
    """ref: vision/models/densenet.py DenseNet(layers=121, ...)."""

    def __init__(self, layers=121, bn_size=4, dropout=0.0,
                 num_classes=1000, with_pool=True):
        super().__init__()
        num_init, growth, block_cfg = _DENSE_CFG[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        feats = [
            nn.Conv2D(3, num_init, 7, stride=2, padding=3,
                      bias_attr=False),
            nn.BatchNorm2D(num_init), nn.ReLU(),
            nn.MaxPool2D(3, 2, padding=1),
        ]
        ch = num_init
        for bi, n in enumerate(block_cfg):
            for _ in range(n):
                feats.append(_DenseLayer(ch, growth, bn_size, dropout))
                ch += growth
            if bi != len(block_cfg) - 1:
                feats.append(_Transition(ch, ch // 2))
                ch //= 2
        feats += [nn.BatchNorm2D(ch), nn.ReLU()]
        self.features = nn.Sequential(*feats)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Linear(ch, num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(_flatten(x))
        return x


# ---- GoogLeNet ------------------------------------------------------------
class _Inception(nn.Layer):
    def __init__(self, cin, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = nn.Sequential(nn.Conv2D(cin, c1, 1), nn.ReLU())
        self.b2 = nn.Sequential(
            nn.Conv2D(cin, c3r, 1), nn.ReLU(),
            nn.Conv2D(c3r, c3, 3, padding=1), nn.ReLU(),
        )
        self.b3 = nn.Sequential(
            nn.Conv2D(cin, c5r, 1), nn.ReLU(),
            nn.Conv2D(c5r, c5, 5, padding=2), nn.ReLU(),
        )
        self.b4 = nn.Sequential(
            nn.MaxPool2D(3, 1, padding=1),
            nn.Conv2D(cin, proj, 1), nn.ReLU(),
        )

    def forward(self, x):

        return torch.cat(
            [self.b1(x), self.b2(x), self.b3(x), self.b4(x)], dim=1
        )


class GoogLeNet(nn.Layer):
    """ref: vision/models/googlenet.py — returns (out, aux1, aux2) in
    train mode like the reference's GoogLeNet.forward."""

    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            nn.Conv2D(3, 64, 7, stride=2, padding=3), nn.ReLU(),
            nn.MaxPool2D(3, 2, padding=1),
            nn.Conv2D(64, 64, 1), nn.ReLU(),
            nn.Conv2D(64, 192, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, 2, padding=1),
        )
        self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32)
        self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2D(3, 2, padding=1)
        self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64)
        self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64)
        self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64)
        self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64)
        self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, 2, padding=1)
        self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128)
        self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self.pool5 = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.4)
            self.fc = nn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.i3b(self.i3a(x)))
        x = self.i4e(self.i4d(self.i4c(self.i4b(self.i4a(x)))))
        x = self.pool4(x)
        x = self.i5b(self.i5a(x))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(_flatten(x)))
        return x


# ---- ShuffleNetV2 ---------------------------------------------------------
def _channel_shuffle(x, groups):

    n, c, h, w = x.shape
    x = x.reshape(n, groups, c // groups, h, w).transpose(1, 2)
    return x.reshape(n, c, h, w)


class _ShuffleUnit(nn.Layer):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.stride = stride
        branch = cout // 2
        if stride == 2:
            self.b1 = nn.Sequential(
                nn.Conv2D(cin, cin, 3, stride=2, padding=1, groups=cin,
                          bias_attr=False),
                nn.BatchNorm2D(cin),
                nn.Conv2D(cin, branch, 1, bias_attr=False),
                nn.BatchNorm2D(branch), nn.ReLU(),
            )
            c2in = cin
        else:
            self.b1 = None
            c2in = cin // 2
        self.b2 = nn.Sequential(
            nn.Conv2D(c2in, branch, 1, bias_attr=False),
            nn.BatchNorm2D(branch), nn.ReLU(),
            nn.Conv2D(branch, branch, 3, stride=stride, padding=1,
                      groups=branch, bias_attr=False),
            nn.BatchNorm2D(branch),
            nn.Conv2D(branch, branch, 1, bias_attr=False),
            nn.BatchNorm2D(branch), nn.ReLU(),
        )

    def forward(self, x):

        if self.stride == 2:
            out = torch.cat([self.b1(x), self.b2(x)], dim=1)
        else:
            half = x.shape[1] // 2
            x1, x2 = x[:, :half], x[:, half:]
            out = torch.cat([x1, self.b2(x2)], dim=1)
        return _channel_shuffle(out, 2)


_SHUFFLE_CH = {
    0.25: [24, 24, 48, 96, 512],
    0.5: [24, 48, 96, 192, 1024],
    1.0: [24, 116, 232, 464, 1024],
    1.5: [24, 176, 352, 704, 1024],
    2.0: [24, 244, 488, 976, 2048],
}


class ShuffleNetV2(nn.Layer):
    """ref: vision/models/shufflenetv2.py ShuffleNetV2(scale, ...)."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        ch = _SHUFFLE_CH[scale]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            nn.Conv2D(3, ch[0], 3, stride=2, padding=1, bias_attr=False),
            nn.BatchNorm2D(ch[0]), nn.ReLU(),
            nn.MaxPool2D(3, 2, padding=1),
        )
        stages = []
        cin = ch[0]
        for si, repeat in enumerate([4, 8, 4]):
            cout = ch[si + 1]
            stages.append(_ShuffleUnit(cin, cout, 2))
            for _ in range(repeat - 1):
                stages.append(_ShuffleUnit(cout, cout, 1))
            cin = cout
        self.stages = nn.Sequential(*stages)
        self.final = nn.Sequential(
            nn.Conv2D(cin, ch[4], 1, bias_attr=False),
            nn.BatchNorm2D(ch[4]), nn.ReLU(),
        )
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(ch[4], num_classes)

    def forward(self, x):
        x = self.final(self.stages(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(_flatten(x))
        return x


# ---- InceptionV3 ----------------------------------------------------------
class _BasicConv(nn.Sequential):
    def __init__(self, cin, cout, kernel, **kw):
        super().__init__(
            nn.Conv2D(cin, cout, kernel, bias_attr=False, **kw),
            nn.BatchNorm2D(cout), nn.ReLU(),
        )


class _InceptionA(nn.Layer):
    def __init__(self, cin, pool_ch):
        super().__init__()
        self.b1 = _BasicConv(cin, 64, 1)
        self.b2 = nn.Sequential(_BasicConv(cin, 48, 1),
                                _BasicConv(48, 64, 5, padding=2))
        self.b3 = nn.Sequential(_BasicConv(cin, 64, 1),
                                _BasicConv(64, 96, 3, padding=1),
                                _BasicConv(96, 96, 3, padding=1))
        self.b4 = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _BasicConv(cin, pool_ch, 1))

    def forward(self, x):

        return torch.cat(
            [self.b1(x), self.b2(x), self.b3(x), self.b4(x)], dim=1
        )


class _InceptionB(nn.Layer):
    def __init__(self, cin):
        super().__init__()
        self.b1 = _BasicConv(cin, 384, 3, stride=2)
        self.b2 = nn.Sequential(_BasicConv(cin, 64, 1),
                                _BasicConv(64, 96, 3, padding=1),
                                _BasicConv(96, 96, 3, stride=2))
        self.pool = nn.MaxPool2D(3, 2)

    def forward(self, x):

        return torch.cat([self.b1(x), self.b2(x), self.pool(x)], dim=1)


class _InceptionC(nn.Layer):
    def __init__(self, cin, c7):
        super().__init__()
        self.b1 = _BasicConv(cin, 192, 1)
        self.b2 = nn.Sequential(
            _BasicConv(cin, c7, 1),
            _BasicConv(c7, c7, (1, 7), padding=(0, 3)),
            _BasicConv(c7, 192, (7, 1), padding=(3, 0)),
        )
        self.b3 = nn.Sequential(
            _BasicConv(cin, c7, 1),
            _BasicConv(c7, c7, (7, 1), padding=(3, 0)),
            _BasicConv(c7, c7, (1, 7), padding=(0, 3)),
            _BasicConv(c7, c7, (7, 1), padding=(3, 0)),
            _BasicConv(c7, 192, (1, 7), padding=(0, 3)),
        )
        self.b4 = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _BasicConv(cin, 192, 1))

    def forward(self, x):

        return torch.cat(
            [self.b1(x), self.b2(x), self.b3(x), self.b4(x)], dim=1
        )


class _InceptionD(nn.Layer):
    def __init__(self, cin):
        super().__init__()
        self.b1 = nn.Sequential(_BasicConv(cin, 192, 1),
                                _BasicConv(192, 320, 3, stride=2))
        self.b2 = nn.Sequential(
            _BasicConv(cin, 192, 1),
            _BasicConv(192, 192, (1, 7), padding=(0, 3)),
            _BasicConv(192, 192, (7, 1), padding=(3, 0)),
            _BasicConv(192, 192, 3, stride=2),
        )
        self.pool = nn.MaxPool2D(3, 2)

    def forward(self, x):

        return torch.cat([self.b1(x), self.b2(x), self.pool(x)], dim=1)


class _InceptionE(nn.Layer):
    def __init__(self, cin):
        super().__init__()
        self.b1 = _BasicConv(cin, 320, 1)
        self.b2_stem = _BasicConv(cin, 384, 1)
        self.b2a = _BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.b2b = _BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.b3_stem = nn.Sequential(_BasicConv(cin, 448, 1),
                                     _BasicConv(448, 384, 3, padding=1))
        self.b3a = _BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.b3b = _BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.b4 = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _BasicConv(cin, 192, 1))

    def forward(self, x):

        b2 = self.b2_stem(x)
        b3 = self.b3_stem(x)
        return torch.cat(
            [self.b1(x),
             torch.cat([self.b2a(b2), self.b2b(b2)], dim=1),
             torch.cat([self.b3a(b3), self.b3b(b3)], dim=1),
             self.b4(x)],
            dim=1,
        )


class InceptionV3(nn.Layer):
    """ref: vision/models/inceptionv3.py InceptionV3(num_classes, ...)."""

    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _BasicConv(3, 32, 3, stride=2),
            _BasicConv(32, 32, 3),
            _BasicConv(32, 64, 3, padding=1),
            nn.MaxPool2D(3, 2),
            _BasicConv(64, 80, 1),
            _BasicConv(80, 192, 3),
            nn.MaxPool2D(3, 2),
        )
        self.blocks = nn.Sequential(
            _InceptionA(192, 32), _InceptionA(256, 64),
            _InceptionA(288, 64),
            _InceptionB(288),
            _InceptionC(768, 128), _InceptionC(768, 160),
            _InceptionC(768, 160), _InceptionC(768, 192),
            _InceptionD(768),
            _InceptionE(1280), _InceptionE(2048),
        )
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.5)
            self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(_flatten(x)))
        return x



def _densenet(layers):
    def build(pretrained=False, **kwargs):
        return _build(DenseNet, pretrained, layers=layers, **kwargs)

    build.__name__ = f"densenet{layers}"
    return build


densenet121 = _densenet(121)
densenet161 = _densenet(161)
densenet169 = _densenet(169)
densenet201 = _densenet(201)
densenet264 = _densenet(264)


def googlenet(pretrained=False, **kwargs):
    return _build(GoogLeNet, pretrained, **kwargs)


def _shufflenet(scale):
    def build(pretrained=False, **kwargs):
        return _build(ShuffleNetV2, pretrained, scale=scale, **kwargs)

    build.__name__ = f"shufflenet_v2_x{str(scale).replace('.', '_')}"
    return build


shufflenet_v2_x0_25 = _shufflenet(0.25)
shufflenet_v2_x0_5 = _shufflenet(0.5)
shufflenet_v2_x1_0 = _shufflenet(1.0)
shufflenet_v2_x1_5 = _shufflenet(1.5)
shufflenet_v2_x2_0 = _shufflenet(2.0)


def inception_v3(pretrained=False, **kwargs):
    return _build(InceptionV3, pretrained, **kwargs)
