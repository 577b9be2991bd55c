"""ShuffleNetV2 (counterpart of
``paddle_tpu/vision/models/shufflenetv2.py``): channel-split units with
the channel shuffle (``ops.nn_ops.channel_shuffle``)."""

from __future__ import annotations

import torch

from ... import nn
from ...nn.layer import Layer
from ...ops import manipulation, nn_ops
from ._utils import ConvNormAct as ConvBN
from ._utils import layer_kw, refuse_pretrained


class InvertedResidual(Layer):
    def __init__(self, in_c, out_c, stride, act="relu", **kw):
        super().__init__()
        self.stride = stride
        branch = out_c // 2
        if stride == 1:
            self.branch2 = nn.Sequential(
                ConvBN(branch, branch, 1, act=act, **kw),
                ConvBN(branch, branch, 3, stride=1, groups=branch,
                       act=None, **kw),
                ConvBN(branch, branch, 1, act=act, **kw))
        else:
            self.branch1 = nn.Sequential(
                ConvBN(in_c, in_c, 3, stride=stride, groups=in_c,
                       act=None, **kw),
                ConvBN(in_c, branch, 1, act=act, **kw))
            self.branch2 = nn.Sequential(
                ConvBN(in_c, branch, 1, act=act, **kw),
                ConvBN(branch, branch, 3, stride=stride, groups=branch,
                       act=None, **kw),
                ConvBN(branch, branch, 1, act=act, **kw))

    def forward(self, x):
        if self.stride == 1:
            half = x.shape[1] // 2
            x1, x2 = manipulation.split(x, [half, half], axis=1)
            out = torch.cat([x1, self.branch2(x2)], 1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], 1)
        return nn_ops.channel_shuffle(out, 2)


_STAGE_OUT = {
    0.25: (24, 24, 48, 96, 512), 0.33: (24, 32, 64, 128, 512),
    0.5: (24, 48, 96, 192, 1024), 1.0: (24, 116, 232, 464, 1024),
    1.5: (24, 176, 352, 704, 1024), 2.0: (24, 244, 488, 976, 2048)}
_REPEATS = (4, 8, 4)


class ShuffleNetV2(Layer):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, *, device=None, generator=None):
        super().__init__()
        kw = layer_kw(device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        if float(scale) not in _STAGE_OUT:
            raise NotImplementedError(
                f"ShuffleNetV2 scale {scale} unsupported; choose from "
                f"{sorted(_STAGE_OUT)}")
        c0, c1, c2, c3, c_last = _STAGE_OUT[float(scale)]
        self.conv1 = ConvBN(3, c0, 3, stride=2, act=act, **kw)
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        stages = []
        in_c = c0
        for out_c, reps in zip((c1, c2, c3), _REPEATS):
            units = [InvertedResidual(in_c, out_c, 2, act, **kw)]
            for _ in range(reps - 1):
                units.append(InvertedResidual(out_c, out_c, 1, act, **kw))
            stages.append(nn.Sequential(*units))
            in_c = out_c
        self.stage2, self.stage3, self.stage4 = stages
        self.conv5 = ConvBN(in_c, c_last, 1, act=act, **kw)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(c_last, num_classes, **kw)

    def forward(self, x):
        x = self.maxpool(self.conv1(x))
        x = self.stage4(self.stage3(self.stage2(x)))
        x = self.conv5(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(manipulation.flatten(x, 1))
        return x


def _shufflenet(scale, act="relu", pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return ShuffleNetV2(scale=scale, act=act, **kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return _shufflenet(0.25, pretrained=pretrained, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return _shufflenet(0.33, pretrained=pretrained, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return _shufflenet(0.5, pretrained=pretrained, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return _shufflenet(1.0, pretrained=pretrained, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return _shufflenet(1.5, pretrained=pretrained, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return _shufflenet(2.0, pretrained=pretrained, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return _shufflenet(1.0, act="swish", pretrained=pretrained, **kwargs)
