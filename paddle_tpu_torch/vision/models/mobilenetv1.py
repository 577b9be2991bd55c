"""MobileNetV1 (counterpart of
``paddle_tpu/vision/models/mobilenetv1.py``): a depthwise-separable
conv stack (grouped convolutions with groups = channels)."""

from __future__ import annotations

from ... import nn
from ...nn.layer import Layer
from ...ops import manipulation
from ._utils import ConvNormAct, layer_kw, refuse_pretrained


class ConvBNLayer(ConvNormAct):
    def __init__(self, in_c, out_c, kernel, stride=1, padding=0,
                 groups=1, **kw):
        super().__init__(in_c, out_c, kernel, stride=stride,
                         padding=padding, groups=groups, act="relu", **kw)


class DepthwiseSeparable(Layer):
    def __init__(self, in_c, mid_c, out_c, stride, scale, **kw):
        super().__init__()
        self.dw = ConvBNLayer(int(in_c * scale), int(mid_c * scale), 3,
                              stride=stride, padding=1,
                              groups=int(in_c * scale), **kw)
        self.pw = ConvBNLayer(int(mid_c * scale), int(out_c * scale), 1,
                              **kw)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, generator=None):
        super().__init__()
        kw = layer_kw(device, generator)
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = ConvBNLayer(3, int(32 * scale), 3, stride=2,
                                 padding=1, **kw)
        cfg = [  # in, mid, out, stride
            (32, 32, 64, 1), (64, 64, 128, 2), (128, 128, 128, 1),
            (128, 128, 256, 2), (256, 256, 256, 1),
            (256, 256, 512, 2),
            (512, 512, 512, 1), (512, 512, 512, 1),
            (512, 512, 512, 1), (512, 512, 512, 1),
            (512, 512, 512, 1),
            (512, 512, 1024, 2), (1024, 1024, 1024, 1)]
        self.blocks = nn.Sequential(*[
            DepthwiseSeparable(i, m, o, s, scale, **kw)
            for i, m, o, s in cfg])
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(int(1024 * scale), num_classes, **kw)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(manipulation.flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    refuse_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)
