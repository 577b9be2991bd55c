"""Inception v3 (counterpart of
``paddle_tpu/vision/models/inceptionv3.py``).  299x299 is the canonical
input; any size of 75 or more works (adaptive pooling)."""

from __future__ import annotations

import torch

from ... import nn
from ...nn.layer import Layer
from ...ops import manipulation
from ._utils import ConvNormAct, layer_kw, refuse_pretrained


class ConvBN(ConvNormAct):
    def __init__(self, in_c, out_c, k, stride=1, padding=0, **kw):
        super().__init__(in_c, out_c, k, stride=stride, padding=padding,
                         act="relu", **kw)


def _cat(xs):
    return torch.cat(xs, 1)


class InceptionA(Layer):
    def __init__(self, in_c, pool_c, **kw):
        super().__init__()
        self.b1 = ConvBN(in_c, 64, 1, **kw)
        self.b5 = nn.Sequential(ConvBN(in_c, 48, 1, **kw),
                                ConvBN(48, 64, 5, padding=2, **kw))
        self.b3 = nn.Sequential(ConvBN(in_c, 64, 1, **kw),
                                ConvBN(64, 96, 3, padding=1, **kw),
                                ConvBN(96, 96, 3, padding=1, **kw))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                ConvBN(in_c, pool_c, 1, **kw))

    def forward(self, x):
        return _cat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)])


class InceptionB(Layer):
    def __init__(self, in_c, **kw):
        super().__init__()
        self.b3 = ConvBN(in_c, 384, 3, stride=2, **kw)
        self.b3d = nn.Sequential(ConvBN(in_c, 64, 1, **kw),
                                 ConvBN(64, 96, 3, padding=1, **kw),
                                 ConvBN(96, 96, 3, stride=2, **kw))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return _cat([self.b3(x), self.b3d(x), self.pool(x)])


class InceptionC(Layer):
    def __init__(self, in_c, c7, **kw):
        super().__init__()
        self.b1 = ConvBN(in_c, 192, 1, **kw)
        self.b7 = nn.Sequential(
            ConvBN(in_c, c7, 1, **kw),
            ConvBN(c7, c7, (1, 7), padding=(0, 3), **kw),
            ConvBN(c7, 192, (7, 1), padding=(3, 0), **kw))
        self.b7d = nn.Sequential(
            ConvBN(in_c, c7, 1, **kw),
            ConvBN(c7, c7, (7, 1), padding=(3, 0), **kw),
            ConvBN(c7, c7, (1, 7), padding=(0, 3), **kw),
            ConvBN(c7, c7, (7, 1), padding=(3, 0), **kw),
            ConvBN(c7, 192, (1, 7), padding=(0, 3), **kw))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                ConvBN(in_c, 192, 1, **kw))

    def forward(self, x):
        return _cat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)])


class InceptionD(Layer):
    def __init__(self, in_c, **kw):
        super().__init__()
        self.b3 = nn.Sequential(ConvBN(in_c, 192, 1, **kw),
                                ConvBN(192, 320, 3, stride=2, **kw))
        self.b7 = nn.Sequential(
            ConvBN(in_c, 192, 1, **kw),
            ConvBN(192, 192, (1, 7), padding=(0, 3), **kw),
            ConvBN(192, 192, (7, 1), padding=(3, 0), **kw),
            ConvBN(192, 192, 3, stride=2, **kw))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return _cat([self.b3(x), self.b7(x), self.pool(x)])


class InceptionE(Layer):
    def __init__(self, in_c, **kw):
        super().__init__()
        self.b1 = ConvBN(in_c, 320, 1, **kw)
        self.b3_stem = ConvBN(in_c, 384, 1, **kw)
        self.b3_a = ConvBN(384, 384, (1, 3), padding=(0, 1), **kw)
        self.b3_b = ConvBN(384, 384, (3, 1), padding=(1, 0), **kw)
        self.b3d_stem = nn.Sequential(ConvBN(in_c, 448, 1, **kw),
                                      ConvBN(448, 384, 3, padding=1, **kw))
        self.b3d_a = ConvBN(384, 384, (1, 3), padding=(0, 1), **kw)
        self.b3d_b = ConvBN(384, 384, (3, 1), padding=(1, 0), **kw)
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                ConvBN(in_c, 192, 1, **kw))

    def forward(self, x):
        s = self.b3_stem(x)
        d = self.b3d_stem(x)
        return _cat([self.b1(x),
                     _cat([self.b3_a(s), self.b3_b(s)]),
                     _cat([self.b3d_a(d), self.b3d_b(d)]),
                     self.bp(x)])


class InceptionV3(Layer):
    def __init__(self, num_classes=1000, with_pool=True, *, device=None,
                 generator=None):
        super().__init__()
        kw = layer_kw(device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            ConvBN(3, 32, 3, stride=2, **kw), ConvBN(32, 32, 3, **kw),
            ConvBN(32, 64, 3, padding=1, **kw),
            nn.MaxPool2D(3, stride=2),
            ConvBN(64, 80, 1, **kw), ConvBN(80, 192, 3, **kw),
            nn.MaxPool2D(3, stride=2))
        self.blocks = nn.Sequential(
            InceptionA(192, 32, **kw), InceptionA(256, 64, **kw),
            InceptionA(288, 64, **kw),
            InceptionB(288, **kw),
            InceptionC(768, 128, **kw), InceptionC(768, 160, **kw),
            InceptionC(768, 160, **kw), InceptionC(768, 192, **kw),
            InceptionD(768, **kw),
            InceptionE(1280, **kw), InceptionE(2048, **kw))
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.5)
            self.fc = nn.Linear(2048, num_classes, **kw)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(manipulation.flatten(x, 1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return InceptionV3(**kwargs)
