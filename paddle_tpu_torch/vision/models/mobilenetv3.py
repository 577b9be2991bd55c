"""MobileNetV3 small/large (counterpart of
``paddle_tpu/vision/models/mobilenetv3.py``): inverted residuals with
squeeze-excite and hardswish."""

from __future__ import annotations

from ... import nn
from ...nn.layer import Layer
from ...ops import manipulation
from ._utils import ConvNormAct as ConvBNAct
from ._utils import layer_kw, refuse_pretrained
from ._utils import make_divisible as _make_divisible


class SqueezeExcite(Layer):
    def __init__(self, channels, reduction=4, **kw):
        super().__init__()
        mid = _make_divisible(channels // reduction)
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(channels, mid, 1, **kw)
        self.relu = nn.ReLU()
        self.fc2 = nn.Conv2D(mid, channels, 1, **kw)
        self.hsig = nn.Hardsigmoid()

    def forward(self, x):
        s = self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))
        return x * s


class InvertedResidual(Layer):
    def __init__(self, in_c, mid_c, out_c, k, stride, use_se, act, **kw):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if mid_c != in_c:
            layers.append(ConvBNAct(in_c, mid_c, 1, act=act, **kw))
        layers.append(ConvBNAct(mid_c, mid_c, k, stride=stride,
                                groups=mid_c, act=act, **kw))
        if use_se:
            layers.append(SqueezeExcite(mid_c, **kw))
        layers.append(ConvBNAct(mid_c, out_c, 1, act=None, **kw))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


# (kernel, exp, out, use_se, act, stride)
_LARGE = [
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2),
    (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1),
    (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2),
    (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1)]
_SMALL = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1),
    (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1),
    (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2),
    (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1)]


class MobileNetV3(Layer):
    def __init__(self, config, last_channel, scale=1.0,
                 num_classes=1000, with_pool=True, *, device=None,
                 generator=None):
        super().__init__()
        kw = layer_kw(device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        in_c = _make_divisible(16 * scale)
        self.conv1 = ConvBNAct(3, in_c, 3, stride=2, act="hardswish", **kw)
        blocks = []
        for k, exp, out, se, act, s in config:
            mid = _make_divisible(exp * scale)
            out_c = _make_divisible(out * scale)
            blocks.append(InvertedResidual(in_c, mid, out_c, k, s, se,
                                           act, **kw))
            in_c = out_c
        self.blocks = nn.Sequential(*blocks)
        last_conv = _make_divisible(6 * in_c)
        # the classifier's hidden width scales with the model (upstream:
        # make_divisible(last_channel * scale))
        last_channel = _make_divisible(last_channel * scale)
        self.conv2 = ConvBNAct(in_c, last_conv, 1, act="hardswish", **kw)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(last_conv, last_channel, **kw), nn.Hardswish(),
                nn.Dropout(0.2), nn.Linear(last_channel, num_classes, **kw))

    def forward(self, x):
        x = self.conv2(self.blocks(self.conv1(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(manipulation.flatten(x, 1))
        return x


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__(_LARGE, 1280, scale, num_classes, with_pool, **kw)


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__(_SMALL, 1024, scale, num_classes, with_pool, **kw)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    refuse_pretrained(pretrained)
    return MobileNetV3Large(scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    refuse_pretrained(pretrained)
    return MobileNetV3Small(scale=scale, **kwargs)
