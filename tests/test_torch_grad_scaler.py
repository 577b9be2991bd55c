"""``GradScaler`` of the port (``paddle_tpu_torch/amp/grad_scaler.py``)
against the JAX package's on the same weights and inputs.

Mirrors ``tests/test_nn_coverage.py::test_grad_scaler_skips_step_on_inf``,
``::test_grad_scaler_growth_after_good_steps`` and
``::test_grad_scaler_double_step_raises``; a skipped step must leave
every parameter, master, moment, beta power and step count bit for bit
as it was (exact equality), and a finite step must match the JAX
scaler's within 1e-6 (fp32 AdamW on unscaled gradients; the unscale
multiplies by a power of two, exactly).
"""

import copy

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.tensor import Tensor as JTensor

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from torch_parity_helpers import torch_one_thread  # noqa: F401


def _fc_pair(n=4, seed=0):
    jpaddle.seed(seed)
    jfc = jnn.Linear(n, n)
    tfc = tnn.Linear(n, n, device="cpu")
    with torch.no_grad():
        tfc.weight.copy_(torch.from_numpy(np.asarray(jfc.weight.numpy())))
        tfc.bias.copy_(torch.from_numpy(np.asarray(jfc.bias.numpy())))
    return jfc, tfc


def _state(opt, net):
    out = {n: p.detach().clone() for n, p in net.named_parameters()}
    for i, st in opt._state.items():
        for k, v in st.items():
            out[f"{i}.{k}"] = v.clone() if isinstance(v, torch.Tensor) else v
    out["global_step"] = opt._global_step
    return out


def _equal(a, b):
    return set(a) == set(b) and all(
        torch.equal(v, b[k]) if isinstance(v, torch.Tensor) else v == b[k]
        for k, v in a.items())


def test_grad_scaler_skips_step_on_inf():
    jfc, tfc = _fc_pair()
    jopt = joptimizer.SGD(learning_rate=0.1, parameters=jfc.parameters())
    topt = tpaddle.optimizer.SGD(learning_rate=0.1,
                                 parameters=tfc.parameters())
    kw = dict(init_loss_scaling=1024.0, decr_every_n_nan_or_inf=1,
              decr_ratio=0.5)
    js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    w0 = tfc.weight.detach().clone()
    x = np.full((2, 4), 1e30, np.float32)
    js.scale(jpaddle.mean(jfc(JTensor(x)) ** 2)).backward()
    js.step(jopt)
    js.update()
    ts.scale((tfc(torch.from_numpy(x)) ** 2).mean()).backward()
    ts.step(topt)
    assert topt._global_step == 0          # optimizer.step() not called
    ts.update()
    topt.clear_grad()
    assert torch.equal(tfc.weight.detach(), w0)
    assert ts.get_loss_scaling().item() == 512.0 == \
        float(js.get_loss_scaling().numpy())
    # a finite step then proceeds, as the JAX scaler's does
    x = np.ones((2, 4), np.float32)
    jopt.clear_grad()
    js.scale(jpaddle.mean(jfc(JTensor(x)) ** 2)).backward()
    js.step(jopt)
    js.update()
    ts.scale((tfc(torch.from_numpy(x)) ** 2).mean()).backward()
    ts.step(topt)
    ts.update()
    assert topt._global_step == 1
    assert not torch.equal(tfc.weight.detach(), w0)
    np.testing.assert_allclose(tfc.weight.detach().numpy(),
                               np.asarray(jfc.weight.numpy()), rtol=1e-6,
                               atol=1e-6)


def test_grad_scaler_growth_after_good_steps():
    _, fc = _fc_pair(2)
    opt = tpaddle.optimizer.SGD(learning_rate=0.0, parameters=fc.parameters())
    scaler = tamp.GradScaler(init_loss_scaling=8.0, incr_every_n_steps=2,
                             incr_ratio=2.0)
    x = torch.ones((1, 2))
    for _ in range(4):
        scaler.scale(fc(x).mean()).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
    assert scaler.get_loss_scaling().item() == 32.0
    assert scaler.state_dict() == {"scale": 32.0, "incr_ratio": 2.0,
                                   "decr_ratio": 0.5, "incr_count": 0,
                                   "decr_count": 0}
    other = tamp.AmpScaler()
    other.load_state_dict(scaler.state_dict())
    assert other.get_loss_scaling().item() == 32.0


def test_grad_scaler_double_step_raises():
    _, fc = _fc_pair(2)
    opt = tpaddle.optimizer.SGD(learning_rate=0.1, parameters=fc.parameters())
    scaler = tamp.GradScaler(init_loss_scaling=8.0)
    scaler.scale(fc(torch.ones((1, 2))).mean()).backward()
    scaler.step(opt)
    with pytest.raises(RuntimeError, match="already been called"):
        scaler.step(opt)
    scaler.update()
    scaler.scale(fc(torch.ones((1, 2))).mean()).backward()
    scaler.step(opt)


@pytest.mark.parametrize("bad", ["inf", "nan"])
def test_skipped_step_leaves_the_whole_optimizer_state_unchanged(bad):
    """AdamW with fp32 masters of bf16 weights, the global-norm clip
    and a scheduler: after two good steps, a gradient with one inf (or
    NaN) skips the step and leaves parameters, masters, moments, beta
    powers, step counts and ``_global_step`` bit for bit; the scale
    halves; the next finite step trains on."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(tnn.Linear(8, 8, device="cpu"),
                              tnn.LayerNorm(8, device="cpu"),
                              tnn.Linear(8, 2, device="cpu"))
    sched = tpaddle.optimizer.lr.LinearWarmup(0.01, 2, 0.0, 0.01)
    opt = tpaddle.optimizer.AdamW(
        learning_rate=sched, parameters=net.parameters(),
        grad_clip=tnn.ClipGradByGlobalNorm(1.0), multi_precision=True)
    tamp.decorate(net, opt, level="O2", dtype="bfloat16")
    scaler = tamp.GradScaler(init_loss_scaling=2.0 ** 10)
    x = torch.randn(4, 8)

    def step(poison=None):
        loss = net(x.bfloat16()).float().square().mean()
        scaler.scale(loss).backward()
        if poison is not None:
            net[0].weight.grad[0, 0] = float(poison)
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        sched.step()

    step()
    step()
    before = _state(opt, net)
    masters = sum("master_weight" in st for st in opt._state.values())
    assert masters == 4
    step(poison=bad)
    assert _equal(before, _state(opt, net))     # global_step included
    assert scaler.get_loss_scaling().item() == 2.0 ** 9
    step()
    after = _state(opt, net)
    assert after["global_step"] == 3 and not _equal(before, after)


def test_disabled_scaler_is_a_plain_step():
    _, fc = _fc_pair(2)
    opt = tpaddle.optimizer.SGD(learning_rate=0.1, parameters=fc.parameters())
    ref = copy.deepcopy(fc)
    ropt = tpaddle.optimizer.SGD(learning_rate=0.1,
                                 parameters=ref.parameters())
    scaler = tamp.GradScaler(enable=False)
    x = torch.ones((1, 2))
    loss = scaler.scale(fc(x).mean())
    scaler.minimize(opt, loss)
    ref(x).mean().backward()
    ropt.step()
    assert torch.equal(fc.weight, ref.weight)
    assert not scaler.is_enable() and scaler.is_use_dynamic_loss_scaling()
