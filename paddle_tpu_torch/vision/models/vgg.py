"""VGG (counterpart of ``paddle_tpu/vision/models/vgg.py``)."""

from __future__ import annotations

from ... import nn
from ...nn.layer import Layer
from ...ops import manipulation
from ._utils import layer_kw, refuse_pretrained

_CFGS = {
    "vgg11": [64, "M", 128, "M", 256, 256, "M",
              512, 512, "M", 512, 512, "M"],
    "vgg13": [64, 64, "M", 128, 128, "M", 256, 256, "M",
              512, 512, "M", 512, 512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"],
    "vgg19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_features(cfg, batch_norm=False, device=None, generator=None):
    kw = layer_kw(device, generator)
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(in_c, v, 3, padding=1, **kw))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v, **kw))
            layers.append(nn.ReLU())
            in_c = v
    return nn.Sequential(*layers)


class VGG(Layer):
    def __init__(self, features, num_classes=1000, with_pool=True, *,
                 device=None, generator=None):
        super().__init__()
        kw = layer_kw(device, generator)
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096, **kw), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, 4096, **kw), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = manipulation.flatten(x, 1)
            x = self.classifier(x)
        return x


def _vgg(name, pretrained, batch_norm, device=None, generator=None,
         **kwargs):
    refuse_pretrained(pretrained)
    return VGG(_make_features(_CFGS[name], batch_norm, device, generator),
               device=device, generator=generator, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg11", pretrained, batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg13", pretrained, batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg16", pretrained, batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg19", pretrained, batch_norm, **kwargs)
