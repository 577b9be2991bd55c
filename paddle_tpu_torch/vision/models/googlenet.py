"""GoogLeNet / Inception v1 (counterpart of
``paddle_tpu/vision/models/googlenet.py``): returns ``(out, aux1,
aux2)`` in train and eval alike, as upstream does."""

from __future__ import annotations

import torch

from ... import nn
from ...nn.layer import Layer
from ...ops import manipulation
from ._utils import layer_kw, refuse_pretrained


class Inception(Layer):
    def __init__(self, in_c, c1, c3r, c3, c5r, c5, proj, **kw):
        super().__init__()
        self.b1 = nn.Sequential(nn.Conv2D(in_c, c1, 1, **kw), nn.ReLU())
        self.b2 = nn.Sequential(nn.Conv2D(in_c, c3r, 1, **kw), nn.ReLU(),
                                nn.Conv2D(c3r, c3, 3, padding=1, **kw),
                                nn.ReLU())
        self.b3 = nn.Sequential(nn.Conv2D(in_c, c5r, 1, **kw), nn.ReLU(),
                                nn.Conv2D(c5r, c5, 5, padding=2, **kw),
                                nn.ReLU())
        self.b4 = nn.Sequential(nn.MaxPool2D(3, stride=1, padding=1),
                                nn.Conv2D(in_c, proj, 1, **kw), nn.ReLU())

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)],
                         1)


class AuxHead(Layer):
    def __init__(self, in_c, num_classes, **kw):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D(4)
        self.conv = nn.Conv2D(in_c, 128, 1, **kw)
        self.relu = nn.ReLU()
        self.fc1 = nn.Linear(128 * 16, 1024, **kw)
        self.dropout = nn.Dropout(0.7)
        self.fc2 = nn.Linear(1024, num_classes, **kw)

    def forward(self, x):
        x = self.relu(self.conv(self.pool(x)))
        x = self.relu(self.fc1(manipulation.flatten(x, 1)))
        return self.fc2(self.dropout(x))


class GoogLeNet(Layer):
    def __init__(self, num_classes=1000, with_pool=True, *, device=None,
                 generator=None):
        super().__init__()
        kw = layer_kw(device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            nn.Conv2D(3, 64, 7, stride=2, padding=3, **kw), nn.ReLU(),
            nn.MaxPool2D(3, stride=2, ceil_mode=True),
            nn.Conv2D(64, 64, 1, **kw), nn.ReLU(),
            nn.Conv2D(64, 192, 3, padding=1, **kw), nn.ReLU(),
            nn.MaxPool2D(3, stride=2, ceil_mode=True))
        self.i3a = Inception(192, 64, 96, 128, 16, 32, 32, **kw)
        self.i3b = Inception(256, 128, 128, 192, 32, 96, 64, **kw)
        self.pool3 = nn.MaxPool2D(3, stride=2, ceil_mode=True)
        self.i4a = Inception(480, 192, 96, 208, 16, 48, 64, **kw)
        self.i4b = Inception(512, 160, 112, 224, 24, 64, 64, **kw)
        self.i4c = Inception(512, 128, 128, 256, 24, 64, 64, **kw)
        self.i4d = Inception(512, 112, 144, 288, 32, 64, 64, **kw)
        self.i4e = Inception(528, 256, 160, 320, 32, 128, 128, **kw)
        self.pool4 = nn.MaxPool2D(3, stride=2, ceil_mode=True)
        self.i5a = Inception(832, 256, 160, 320, 32, 128, 128, **kw)
        self.i5b = Inception(832, 384, 192, 384, 48, 128, 128, **kw)
        if with_pool:
            self.pool5 = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.4)
            self.fc = nn.Linear(1024, num_classes, **kw)
            self.aux1 = AuxHead(512, num_classes, **kw)
            self.aux2 = AuxHead(528, num_classes, **kw)

    def forward(self, x):
        x = self.pool3(self.i3b(self.i3a(self.stem(x))))
        x = self.i4a(x)
        aux1 = self.aux1(x) if self.num_classes > 0 else None
        x = self.i4d(self.i4c(self.i4b(x)))
        aux2 = self.aux2(x) if self.num_classes > 0 else None
        x = self.pool4(self.i4e(x))
        x = self.i5b(self.i5a(x))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(manipulation.flatten(x, 1)))
            # upstream returns (out, aux1, aux2) in both modes
            return x, aux1, aux2
        return x


def googlenet(pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return GoogLeNet(**kwargs)
