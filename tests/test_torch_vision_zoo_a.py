"""The vision zoo of the PyTorch port against the JAX package, part A:
VGG and MobileNet v1-v3 (parts B and C: ``test_torch_vision_zoo_b.py``,
``test_torch_vision_zoo_c.py``), with the checks of
``tests/test_vision_model_zoo.py`` that need no JAX model.

Each model is built in the JAX package (``paddle.seed(0)``, 10 classes)
and its weights and BatchNorm buffers carried to the port through
``vision_state_dict_from_jax``; one numpy image goes through both in
eval mode (the JAX test's forward) at 64x64 (32x32 for VGG, whose
classifier is as wide at any size).  Tolerance: 1e-5 x max(|ref|, 1)
on the logits (fp32, the same sums in another order).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.tensor import Tensor as JTensor
from paddle_tpu.vision import models as JM

from paddle_tpu_torch.vision import models as TM
from torch_parity_helpers import torch_one_thread  # noqa: F401

FWD_TOL = 1e-5


def _forward_both(name, size, channels=3, **kw):
    """Logits of ``name`` in both packages on one image, eval mode."""
    jpaddle.seed(0)
    jnet = getattr(JM, name)(num_classes=10, **kw)
    net = getattr(TM, name)(num_classes=10, device="cpu", **kw)
    net.load_state_dict(TM.vision_state_dict_from_jax(jnet, net))
    x = np.random.default_rng(0).random((1, channels, size, size)).astype(
        np.float32)
    jnet.eval()
    net.eval()
    jout = jnet(JTensor(x))
    with torch.no_grad():
        out = net(torch.from_numpy(x))
    return jout, out, net


def _close(got, ref, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=FWD_TOL * scale,
                               err_msg=what)


def check_family(name, size, channels=3, **kw):
    jout, out, net = _forward_both(name, size, channels, **kw)
    assert tuple(out.shape) == (1, 10)
    _close(out.numpy(), np.asarray(jout.numpy()), name)
    assert len(list(net.parameters())) > 4


@pytest.mark.parametrize("name,size,kw", [
    ("vgg11", 32, {"batch_norm": True}),
    ("mobilenet_v1", 64, {}),
    ("mobilenet_v2", 64, {}),
    ("mobilenet_v3_small", 64, {}),
    ("mobilenet_v3_large", 64, {}),
])
def test_family_forward_matches_jax(name, size, kw):
    check_family(name, size, **kw)


def test_vgg11_13_and_resnext101_32x8d_torchvision_param_counts():
    """The structural-identity oracle of the JAX test: torchvision's
    parameter counts, exactly."""
    feats = TM.vgg11(num_classes=0, with_pool=False, device="cpu")
    assert sum(p.numel() for p in feats.parameters()) == 9_220_480
    feats = TM.vgg13(num_classes=0, with_pool=False, device="cpu")
    assert sum(p.numel() for p in feats.parameters()) == 9_404_992
    net = TM.resnext101_32x8d(num_classes=1000, device="cpu")
    assert sum(p.numel() for p in net.parameters()) == 88_791_336


def test_refusals_and_every_constructor():
    with pytest.raises(ValueError, match="BasicBlock"):
        TM.resnet18(groups=32, width=4, device="cpu")
    for ctor in (TM.densenet121, TM.resnet50, TM.mobilenet_v3_small,
                 TM.googlenet, TM.vgg16):
        with pytest.raises(RuntimeError, match="pretrained"):
            ctor(pretrained=True, device="cpu")
    with pytest.raises(NotImplementedError, match="scale"):
        TM.ShuffleNetV2(scale=0.7, device="cpu")
    # every public constructor of the JAX zoo is here
    jax_names = {n for n in dir(JM) if not n.startswith("_")
                 and callable(getattr(JM, n))}
    assert jax_names <= set(TM.__all__), sorted(jax_names - set(TM.__all__))
    assert callable(TM.resnext152_64x4d)


def test_without_a_device_the_zoo_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.mobilenet_v3_small()
    net = TM.mobilenet_v3_small(device="cpu")
    assert {p.device.type for p in net.parameters()} == {"cpu"}


@pytest.mark.cuda
def test_cuda_family_forward_matches_cpu():
    """MobileNetV3-large (depthwise convolutions, hardswish, SE) in fp32
    on the card (cuDNN, TF32 off) against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: cuDNN's convolutions have no CPU "
                    "mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = TM.mobilenet_v3_large(num_classes=10, device="cpu").eval()
    card = TM.mobilenet_v3_large(num_classes=10, device="cuda").eval()
    card.load_state_dict(net.state_dict())
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref, got = net(x), card(x.cuda()).cpu()
    _close(got.numpy(), ref.numpy(), "mobilenet_v3_large card vs cpu")
