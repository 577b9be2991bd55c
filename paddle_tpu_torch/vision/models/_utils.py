"""Shared building blocks of the port's vision zoo (counterpart of
``paddle_tpu/vision/models/_utils.py``), and the construction keywords
every zoo layer takes."""

from __future__ import annotations

from ... import nn, resolve_device
from ...nn.layer import Layer


def layer_kw(device, generator):
    """``device`` (None: the card) resolved once, and the generator the
    initializers draw from (None: the port's generator of the
    device)."""
    return {"device": resolve_device(device), "generator": generator}


def refuse_pretrained(pretrained):
    if pretrained:
        raise RuntimeError("pretrained weights unavailable offline — load "
                           "a checkpoint with load_state_dict")


def make_divisible(v, divisor=8, min_value=None):
    """Round channel counts to hardware-friendly multiples (the
    MobileNet paper rule, shared by v2/v3/shufflenet)."""
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


_ACTS = {
    None: nn.Identity,
    "relu": nn.ReLU,
    "relu6": nn.ReLU6,
    "hardswish": nn.Hardswish,
    "swish": nn.Swish,
}


class ConvNormAct(Layer):
    """Conv2D + BatchNorm + activation."""

    def __init__(self, in_c, out_c, k, stride=1, padding=None, groups=1,
                 act="relu", *, device=None, generator=None):
        super().__init__()
        kw = layer_kw(device, generator)
        if padding is None:
            padding = (k - 1) // 2 if isinstance(k, int) else \
                tuple((kk - 1) // 2 for kk in k)
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride,
                              padding=padding, groups=groups,
                              bias_attr=False, **kw)
        self.bn = nn.BatchNorm2D(out_c, **kw)
        self.act = _ACTS[act]()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))
