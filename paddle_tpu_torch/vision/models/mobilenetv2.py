"""MobileNetV2 (counterpart of
``paddle_tpu/vision/models/mobilenetv2.py``)."""

from __future__ import annotations

from ... import nn
from ...nn.layer import Layer
from ...ops import manipulation
from ._utils import layer_kw, refuse_pretrained
from ._utils import make_divisible as _make_divisible


class ConvBNReLU(nn.Sequential):
    def __init__(self, in_c, out_c, kernel=3, stride=1, groups=1, **kw):
        super().__init__(
            nn.Conv2D(in_c, out_c, kernel, stride=stride,
                      padding=(kernel - 1) // 2, groups=groups,
                      bias_attr=False, **kw),
            nn.BatchNorm2D(out_c, **kw),
            nn.ReLU6())


class InvertedResidual(Layer):
    def __init__(self, inp, oup, stride, expand_ratio, **kw):
        super().__init__()
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(inp, hidden, kernel=1, **kw))
        layers.extend([
            ConvBNReLU(hidden, hidden, stride=stride, groups=hidden, **kw),
            nn.Conv2D(hidden, oup, 1, bias_attr=False, **kw),
            nn.BatchNorm2D(oup, **kw)])
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv(x) if self.use_res else self.conv(x)


class MobileNetV2(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, generator=None):
        super().__init__()
        kw = layer_kw(device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [[1, 16, 1, 1], [6, 24, 2, 2], [6, 32, 3, 2],
               [6, 64, 4, 2], [6, 96, 3, 1], [6, 160, 3, 2],
               [6, 320, 1, 1]]
        input_channel = _make_divisible(32 * scale)
        last_channel = _make_divisible(1280 * max(1.0, scale))
        features = [ConvBNReLU(3, input_channel, stride=2, **kw)]
        for t, c, n, s in cfg:
            out_c = _make_divisible(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, out_c, s if i == 0 else 1, t, **kw))
                input_channel = out_c
        features.append(ConvBNReLU(input_channel, last_channel, kernel=1,
                                   **kw))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool2d_avg = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(last_channel, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = manipulation.flatten(x, 1)
            x = self.classifier(x)
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    refuse_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)
