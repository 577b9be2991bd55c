"""The vision zoo of the PyTorch port against the JAX package, part C:
GoogLeNet (with its aux heads), InceptionV3, AlexNet, LeNet and the
ResNeXt / wide ResNet variants (``test_torch_vision_zoo_a.py`` states the
method and the tolerance)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.vision import models as TM
from test_torch_vision_zoo_a import _close, _forward_both, check_family
from torch_parity_helpers import torch_one_thread  # noqa: F401


@pytest.mark.parametrize("name,size,channels", [
    ("inception_v3", 96, 3),
    ("alexnet", 224, 3),
    ("resnext50_32x4d", 64, 3),
    ("wide_resnet50_2", 64, 3),
])
def test_family_forward_matches_jax(name, size, channels):
    check_family(name, size, channels)


def test_lenet_forward_matches_jax():
    jout, out, _ = _forward_both("LeNet", 28, channels=1)
    assert tuple(out.shape) == (1, 10)
    _close(out.numpy(), np.asarray(jout.numpy()), "LeNet")


def test_googlenet_returns_its_aux_heads_in_both_modes():
    """Upstream returns ``(out, aux1, aux2)`` in train and eval alike;
    in eval mode all three match the JAX model's."""
    jouts, outs, net = _forward_both("googlenet", 96)
    assert isinstance(outs, tuple) and len(outs) == 3
    for jo, o in zip(jouts, outs):
        assert tuple(o.shape) == (1, 10)
        _close(o.numpy(), np.asarray(jo.numpy()), "googlenet")
    net.train()
    x = torch.rand(2, 3, 96, 96, generator=torch.Generator().manual_seed(1))
    train_outs = net(x)
    assert isinstance(train_outs, tuple) and len(train_outs) == 3
    assert all(tuple(o.shape) == (2, 10) for o in train_outs)


def test_zoo_trains_one_bf16_o2_step_with_finite_gradients():
    """One bf16 O2 Momentum step of a small family on the CPU (the
    card's ``[vision zoo]`` phase does it for every family at its
    published size): finite loss and gradients, fp32 BatchNorm."""
    import paddle_tpu_torch as tpaddle
    net = TM.shufflenet_v2_x0_25(num_classes=10, device="cpu")
    opt = tpaddle.optimizer.Momentum(0.1, 0.9, parameters=net.parameters(),
                                     multi_precision=True)
    tpaddle.amp.decorate(net, opt, level="O2", dtype="bfloat16")
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(2))
    with tpaddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        out = net(x)
    assert out.dtype == torch.bfloat16
    loss = tpaddle.nn.CrossEntropyLoss()(out, torch.tensor([1, 7]))
    loss.backward()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in net.parameters())
    opt.step()
    assert net.conv1.bn._mean.dtype == torch.float32
