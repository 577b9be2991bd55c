"""DenseNet (counterpart of ``paddle_tpu/vision/models/densenet.py``):
dense blocks with concatenative feature reuse and transition
layers."""

from __future__ import annotations

import torch

from ... import nn
from ...nn.layer import Layer
from ...ops import manipulation
from ._utils import layer_kw, refuse_pretrained

_CFG = {121: (6, 12, 24, 16), 161: (6, 12, 36, 24),
        169: (6, 12, 32, 32), 201: (6, 12, 48, 32),
        264: (6, 12, 64, 48)}


class DenseLayer(Layer):
    def __init__(self, in_c, growth, bn_size, dropout, **kw):
        super().__init__()
        self.bn1 = nn.BatchNorm2D(in_c, **kw)
        self.relu = nn.ReLU()
        self.conv1 = nn.Conv2D(in_c, bn_size * growth, 1,
                               bias_attr=False, **kw)
        self.bn2 = nn.BatchNorm2D(bn_size * growth, **kw)
        self.conv2 = nn.Conv2D(bn_size * growth, growth, 3, padding=1,
                               bias_attr=False, **kw)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.bn1(x)))
        out = self.conv2(self.relu(self.bn2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return torch.cat([x, out], 1)


class Transition(Layer):
    def __init__(self, in_c, out_c, **kw):
        super().__init__()
        self.bn = nn.BatchNorm2D(in_c, **kw)
        self.relu = nn.ReLU()
        self.conv = nn.Conv2D(in_c, out_c, 1, bias_attr=False, **kw)
        self.pool = nn.AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.bn(x))))


class DenseNet(Layer):
    def __init__(self, layers=121, growth_rate=None, bn_size=4,
                 dropout=0.0, num_classes=1000, with_pool=True, *,
                 device=None, generator=None):
        super().__init__()
        kw = layer_kw(device, generator)
        if layers == 161:
            # densenet161's canonical config; an explicit growth_rate wins
            growth_rate = 48 if growth_rate is None else growth_rate
            init_c = 96
        else:
            growth_rate = 32 if growth_rate is None else growth_rate
            init_c = 64
        block_cfg = _CFG[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = nn.Conv2D(3, init_c, 7, stride=2, padding=3,
                               bias_attr=False, **kw)
        self.bn1 = nn.BatchNorm2D(init_c, **kw)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        blocks = []
        c = init_c
        for i, reps in enumerate(block_cfg):
            for _ in range(reps):
                blocks.append(DenseLayer(c, growth_rate, bn_size, dropout,
                                         **kw))
                c += growth_rate
            if i != len(block_cfg) - 1:
                blocks.append(Transition(c, c // 2, **kw))
                c = c // 2
        self.blocks = nn.Sequential(*blocks)
        self.bn_final = nn.BatchNorm2D(c, **kw)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(c, num_classes, **kw)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.relu(self.bn_final(self.blocks(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(manipulation.flatten(x, 1))
        return x


def _densenet(layers, pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _densenet(121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _densenet(161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _densenet(169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _densenet(201, pretrained, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return _densenet(264, pretrained, **kwargs)
