"""CycleGAN (``chip_smoke.slice20_models``: PaddleGAN's ResNet generator
and 70x70 PatchGAN, LSGAN, cycle and identity L1, image pools, the
eager G-then-D loop) built on the port's layers against the same code
on the JAX package's layers, fp32 on the CPU: a small model (ngf 8, 2
residual blocks, ndf 8, 32x32, B=1) through three G+D steps from the
same weights (the port's ``train_step`` against the JAX model's
``g_loss`` / ``d_loss``, pools and optimizers, each phase compiled),
and the full-width generator forward.

Tolerances: losses 1e-4 relative; step 1's gradients 1e-4 x the leaf's
largest, except the biases that feed an InstanceNorm without affine,
whose gradients are rounding noise (held within 1e-4 x the largest
gradient of the network); parameters after three steps 1e-4 x
max(|ref|, 1).  The steps run at Adam lr 1e-5: Adam turns a noise
gradient into a step of up to a few lr whose sign the noise sets
(ROADMAP C, "Adam on noise"; three steps at 2e-5 parted a noise bias by
1.06e-4), which at 1e-5 stays under the tolerance.  The zero-padding
control must part from the step-1 gradients by more than
``CONTROL_MIN``.
"""

import numpy as np
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn

import chip_smoke
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.vision.models import state_dict_from_jax
from torch_parity_helpers import (CPU, FWD_TOL, GRAD_TOL, close, jax_twin,
                                  jit_forward, rand)
from torch_parity_helpers import torch_one_thread  # noqa: F401 (autouse)

SMALL = dict(ngf=8, n_blocks=2, ndf=8, lr=1e-5, pool_size=2)
CONTROL_MIN = 1e-3        # the control's step-1 gradient error exceeds it
SIZE = 32


def _gans(pad_mode="reflect"):
    tgan = chip_smoke.slice20_models(tnn)["CycleGAN"](
        tpaddle.optimizer, pad_mode=pad_mode, kw=dict(
            device=CPU, generator=torch.Generator().manual_seed(0)), **SMALL)
    jgan = jax_twin(lambda: chip_smoke.slice20_models(jnn)["CycleGAN"](
        jpaddle.optimizer, **SMALL), tgan)
    return jgan, tgan


def _images(n, seed=1):
    rng = np.random.default_rng(seed)
    return [(np.tanh(rand(rng, 1, 3, SIZE, SIZE)),
             np.tanh(rand(rng, 1, 3, SIZE, SIZE))) for _ in range(n)]


def _grads(net):
    return {k: (None if p.grad is None else np.asarray(p.grad.numpy()))
            for k, p in net.named_parameters()}


def _grad_errors(tgan, jg):
    """Each leaf's |diff| over its own largest JAX gradient ``jg``, and
    for the noise leaves over the networks' largest gradient."""
    tg = _grads(tgan)
    noise = set()
    for name in ("netG_A", "netG_B", "netD_A", "netD_B"):
        noise |= {f"{name}.{k}" for k in chip_smoke.in_noise_leaves(
            getattr(tgan, name), tnn)}
    top = max(float(np.abs(v).max()) for v in jg.values() if v is not None)
    errs = {}
    for k, ref in jg.items():
        assert (tg[k] is None) == (ref is None), k
        if ref is not None:
            scale = top if k in noise else float(np.abs(ref).max()) or 1.0
            errs[k] = float(np.abs(tg[k] - ref).max()) / scale
    return errs, noise


def _jax_stepper(jgan):
    """``CycleGAN.train_step`` on the JAX package's layers with each
    phase's forward and backward as one compiled program (the layers'
    own code under ``functional_call.bind``, the discriminators frozen in
    the G phase by differentiating the generators' parameters only), the
    pools and the optimizers eager as in ``train_step``.  Returns the
    step function: the losses, and each parameter's gradient (by name)."""
    import jax
    from paddle_tpu.nn.functional_call import bind
    from paddle_tpu.tensor import Tensor as JTensor
    named = dict(jgan.named_parameters())

    def split(prefix):
        return {n: p._value for n, p in named.items()
                if n.startswith(prefix)}

    def g_fn(gp, dp, a, b):
        with bind(jgan, {**gp, **dp}):
            total, losses, fa, fb = jgan.g_loss(JTensor(a), JTensor(b))
        return total._value, ({k: v._value for k, v in losses.items()},
                              fa._value, fb._value)

    def d_fn(dp, a, b, fa, fb):
        with bind(jgan, dp):
            la = jgan.d_loss(jgan.netD_A, JTensor(b), JTensor(fb))
            lb = jgan.d_loss(jgan.netD_B, JTensor(a), JTensor(fa))
        return la._value + lb._value, (la._value, lb._value)

    g_grad = jax.jit(jax.value_and_grad(g_fn, has_aux=True))
    d_grad = jax.jit(jax.value_and_grad(d_fn, has_aux=True))

    def step(a, b):
        (total, (losses, fa, fb)), gg = g_grad(split("netG"), split("netD"),
                                               a, b)
        for n, g in gg.items():
            named[n].grad = JTensor(g)
        jgan.optG.step()
        fb = jgan.pool_B.query(JTensor(fb))._value
        fa = jgan.pool_A.query(JTensor(fa))._value
        (_, (la, lb)), dg = d_grad(split("netD"), a, b, fa, fb)
        for n, g in dg.items():
            named[n].grad = JTensor(g)
        jgan.optD.step()
        out = dict(losses, G=total, D_A=la, D_B=lb)
        return ({k: float(v) for k, v in out.items()},
                {n: np.asarray(g) for n, g in {**gg, **dg}.items()})

    return step


def test_cyclegan_three_steps_match_jax():
    """Three G+D steps from the same weights: step 1's gradients (the G
    and D leaves hold them after the step), the losses of every step,
    the parameters after the third; the port's model with zero padding
    in place of reflection (the parity phases' control) must part from
    the step-1 gradients."""
    jgan, tgan = _gans()
    _, control = _gans(pad_mode="constant")
    assert set(tgan.state_dict()) == set(jgan.state_dict())
    init = {k: v.clone() for k, v in tgan.state_dict().items()}
    data = _images(3)
    jl, tl = [], []
    jstep = _jax_stepper(jgan)
    for step, (a, b) in enumerate(data):
        losses, grads = jstep(a, b)
        jl.append(losses)
        tl.append({k: float(v) for k, v in tgan.train_step(
            torch.from_numpy(a), torch.from_numpy(b)).items()})
        if step == 0:
            jg = grads
            errs, noise = _grad_errors(tgan, jg)
            assert len(noise) == 2 * (3 + SMALL["n_blocks"] * 2 + 2) + 2 * 3
            worst = max(errs, key=errs.get)
            assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
            control.train_step(torch.from_numpy(a), torch.from_numpy(b))
            assert max(_grad_errors(control, jg)[0].values()) > CONTROL_MIN
    for t, j in zip(tl, jl):
        for k in j:
            assert abs(t[k] - j[k]) <= 1e-4 * abs(j[k]), (k, t[k], j[k])
    jstate = jgan.state_dict()
    for k, v in tgan.state_dict().items():
        close(v.numpy(), np.asarray(jstate[k].numpy()), GRAD_TOL, k)
        assert not torch.equal(v, init[k]), f"{k} did not move"


def test_generators_train_with_the_discriminators_frozen():
    """The G step leaves the discriminators without gradients
    (``trainable`` off), the D step reaches no generator leaf."""
    tgan = chip_smoke.slice20_models(tnn)["CycleGAN"](
        tpaddle.optimizer, kw=dict(device=CPU), **SMALL)
    (a, b), = _images(1, seed=3)
    tgan.set_requires_grad([tgan.netD_A, tgan.netD_B], False)
    total, _, _, _ = tgan.g_loss(torch.from_numpy(a), torch.from_numpy(b))
    total.backward()
    assert all(p.grad is None for p in tgan.netD_A.parameters())
    assert all(p.grad is not None for p in tgan.netG_A.parameters())
    tgan.set_requires_grad([tgan.netD_A, tgan.netD_B], True)
    tgan.optG.clear_grad()
    fake = tgan.netG_A(torch.from_numpy(a))
    tgan.d_loss(tgan.netD_A, torch.from_numpy(b), fake).backward()
    assert all(p.grad is None for p in tgan.netG_A.parameters())
    assert all(p.grad is not None for p in tgan.netD_A.parameters())


def test_image_pool_follows_the_paper():
    pool = chip_smoke.slice20_models(tnn)["ImagePool"](
        2, np.random.default_rng(0))
    imgs = [torch.full((1,), float(i)) for i in range(40)]
    outs = [float(pool.query(x)) for x in imgs]
    assert outs[:2] == [0.0, 1.0]
    held_back = sum(o != i for i, o in enumerate(outs))
    assert 10 < held_back < 30
    assert len(pool.images) == 2


def test_full_width_generator_forwards_like_jax():
    """ngf 64, 9 residual blocks (11.4 M parameters; the PatchGAN 2.8 M)
    at one 32x32 image."""
    tnet = chip_smoke.slice20_models(tnn)["ResnetGenerator"](
        kw=dict(device=CPU))
    jnet = jax_twin(chip_smoke.slice20_models(jnn)["ResnetGenerator"], tnet)
    assert set(state_dict_from_jax(jnet, tnet)) == set(tnet.state_dict())
    assert sum(p.numel() for p in tnet.parameters()) == 11378179
    disc = chip_smoke.slice20_models(tnn)["NLayerDiscriminator"](
        kw=dict(device=CPU))
    assert sum(p.numel() for p in disc.parameters()) == 2764737
    x = np.tanh(rand(np.random.default_rng(2), 1, 3, 32, 32))
    with torch.no_grad():
        out = tnet(torch.from_numpy(x))
    close(out.numpy(), jit_forward(jnet, x), FWD_TOL * 10, "generator")
