"""AlexNet (counterpart of ``paddle_tpu/vision/models/alexnet.py``;
224x224 input: the classifier takes the 6x6 feature map)."""

from __future__ import annotations

from ... import nn
from ...nn.layer import Layer
from ...ops import manipulation
from ._utils import layer_kw, refuse_pretrained


class AlexNet(Layer):
    def __init__(self, num_classes=1000, *, device=None, generator=None):
        super().__init__()
        kw = layer_kw(device, generator)
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2, **kw), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(64, 192, 5, padding=2, **kw), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(192, 384, 3, padding=1, **kw), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1, **kw), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1, **kw), nn.ReLU(),
            nn.MaxPool2D(3, 2))
        self.classifier = nn.Sequential(
            nn.Dropout(), nn.Linear(256 * 6 * 6, 4096, **kw), nn.ReLU(),
            nn.Dropout(), nn.Linear(4096, 4096, **kw), nn.ReLU(),
            nn.Linear(4096, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        x = manipulation.flatten(x, 1)
        return self.classifier(x)


def alexnet(pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return AlexNet(**kwargs)
