"""R(2+1)D (``chip_smoke.slice20_models``: torchvision's ``r2plus1d_18``
layout, Conv3D with (1, 3, 3) and (3, 1, 1) kernels, BatchNorm3D,
AdaptiveAvgPool3D) built on the port's layers against the same code on
the JAX package's layers, on the CPU: a small model (one block a stage,
widths 8-64, 4x16x16 clips, B=16) through three ``Model.fit`` steps of
``Momentum(1e-3, 0.9, L2Decay(1e-4))`` in fp32 and in bf16 O2, and the
full-width R(2+1)D-18 (31.5 M parameters, 400 classes) forward in eval
mode at one small clip.

Tolerances: fp32 losses, every parameter and BatchNorm statistic 1e-4
x max(|ref|, 1); bf16 O2 5e-2 x max(|ref|, 1)
(``tests/test_torch_vision_resnet.py``'s bound: O2's Python adds round
otherwise, ROADMAP C).  At 4x16x16 the last stage is 1x1x1, so its
BatchNorm sees B values a channel: at B=4 three steps turned rounding
into 2% of a loss in fp32, and at the paper's rate 0.01 into 17% in
bf16 O2 (at B=16), so the steps run at B=16 and lr 1e-3.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import regularizer as jreg

import chip_smoke
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.vision.models import state_dict_from_jax
from torch_parity_helpers import (BF16_TOL, CPU, GRAD_TOL, close, jax_twin,
                                  jit_forward, rand)
from torch_parity_helpers import torch_one_thread  # noqa: F401 (autouse)

SMALL = dict(num_classes=10, layers=(1, 1, 1, 1), widths=(8, 16, 32, 64),
             stem_mid=6)
B, T, SIZE = 16, 4, 16
LR = 1e-3
O2 = {"level": "O2", "dtype": "bfloat16"}


def _pair(**cfg):
    tnet = chip_smoke.slice20_models(tnn)["R2Plus1D"](kw=dict(
        device=CPU, generator=torch.Generator().manual_seed(0)), **cfg)
    jnet = jax_twin(lambda: chip_smoke.slice20_models(jnn)["R2Plus1D"](
        **cfg), tnet)
    assert set(state_dict_from_jax(jnet, tnet)) == set(tnet.state_dict())
    return jnet, tnet


def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [(rand(rng, B, 3, T, SIZE, SIZE),
             rng.integers(0, SMALL["num_classes"], (B,)).astype(np.int64))
            for _ in range(n)]


def _fit(paddle, nn, reg, net, batches, amp, device=None):
    opt = paddle.optimizer.Momentum(
        LR, 0.9, parameters=net.parameters(),
        weight_decay=reg.L2Decay(chip_smoke.VIDEO_DECAY),
        multi_precision=amp is not None)
    if amp is not None:
        (jamp if paddle is jpaddle else paddle.amp).decorate(net, opt, **amp)
    model = paddle.Model(net, **({} if device is None else
                                 {"device": device}))
    model.prepare(opt, nn.CrossEntropyLoss(), amp_configs=amp)
    losses = []

    class Keep(paddle.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(float(np.asarray(logs["loss"][0])))

    model.fit(batches, epochs=1, verbose=0, callbacks=[Keep()])
    return losses


@pytest.mark.parametrize("amp", [None, O2], ids=["fp32", "bf16 O2"])
def test_three_fit_steps_match_jax(amp):
    jnet, tnet = _pair(**SMALL)
    batches = _batches(3)
    jl = _fit(jpaddle, jnn, jreg, jnet, [
        (jpaddle.to_tensor(x), jpaddle.to_tensor(y)) for x, y in batches],
        amp)
    tl = _fit(tpaddle, tnn, treg, tnet, [
        (torch.from_numpy(x), torch.from_numpy(y)) for x, y in batches],
        amp, CPU)
    tol = GRAD_TOL if amp is None else BF16_TOL
    close(tl, jl, tol, "losses")
    jstate = jnet.state_dict()
    for k, v in tnet.state_dict().items():
        ref = np.asarray(jstate[k].astype("float32").numpy())
        close(v.float().numpy(), ref, tol, k)
    if amp is not None:
        dtypes = {p.dtype for p in tnet.parameters()}
        assert dtypes == {torch.bfloat16, torch.float32}
        assert tnet.stem[1]._mean.dtype == torch.float32
    assert float(tnet.stem[1]._mean.abs().max()) > 0


def test_full_width_r2plus1d_18_forward_like_jax():
    jnet, tnet = _pair()
    assert sum(p.numel() for p in tnet.parameters()) == 31505325
    assert tnet.layer2[0].conv1[0].weight.shape[0] == 230   # eq. 1's mid
    jnet.eval()
    tnet.eval()
    x = rand(np.random.default_rng(2), 1, 3, 4, 16, 16)
    with torch.no_grad():
        out = tnet(torch.from_numpy(x))
    assert tuple(out.shape) == (1, chip_smoke.VIDEO_CLASSES)
    close(out.numpy(), jit_forward(jnet, x), 1e-4, "logits")
