"""SqueezeNet 1.0/1.1 (counterpart of
``paddle_tpu/vision/models/squeezenet.py``): fire modules (squeeze 1x1,
then expand 1x1 and 3x3)."""

from __future__ import annotations

import torch

from ... import nn
from ...nn.layer import Layer
from ...ops import manipulation
from ._utils import layer_kw, refuse_pretrained


class Fire(Layer):
    def __init__(self, in_c, squeeze, e1, e3, **kw):
        super().__init__()
        self.squeeze = nn.Conv2D(in_c, squeeze, 1, **kw)
        self.relu = nn.ReLU()
        self.expand1 = nn.Conv2D(squeeze, e1, 1, **kw)
        self.expand3 = nn.Conv2D(squeeze, e3, 3, padding=1, **kw)

    def forward(self, x):
        s = self.relu(self.squeeze(x))
        return torch.cat([self.relu(self.expand1(s)),
                          self.relu(self.expand3(s))], 1)


class SqueezeNet(Layer):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True, *,
                 device=None, generator=None):
        super().__init__()
        kw = layer_kw(device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2, **kw), nn.ReLU(),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(96, 16, 64, 64, **kw), Fire(128, 16, 64, 64, **kw),
                Fire(128, 32, 128, 128, **kw),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(256, 32, 128, 128, **kw), Fire(256, 48, 192, 192, **kw),
                Fire(384, 48, 192, 192, **kw), Fire(384, 64, 256, 256, **kw),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(512, 64, 256, 256, **kw))
        elif version == "1.1":
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2, **kw), nn.ReLU(),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(64, 16, 64, 64, **kw), Fire(128, 16, 64, 64, **kw),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(128, 32, 128, 128, **kw), Fire(256, 32, 128, 128, **kw),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(256, 48, 192, 192, **kw), Fire(384, 48, 192, 192, **kw),
                Fire(384, 64, 256, 256, **kw), Fire(512, 64, 256, 256, **kw))
        else:
            raise ValueError(f"unknown version {version!r}")
        if num_classes > 0:
            self.classifier_conv = nn.Conv2D(512, num_classes, 1, **kw)
            self.dropout = nn.Dropout(0.5)
            self.relu = nn.ReLU()
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.relu(self.classifier_conv(self.dropout(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = manipulation.flatten(x, 1)
        return x


def squeezenet1_0(pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return SqueezeNet("1.1", **kwargs)
