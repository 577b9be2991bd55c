"""The normalisation family of the port against the JAX package:
``layer_norm``, ``rms_norm``, ``instance_norm``, ``group_norm``,
``local_response_norm`` and their layers, BatchNorm3D (three training
steps of running statistics), SyncBatchNorm (the JAX package's alias)
and SpectralNorm (its ``u`` / ``v`` buffers carried across, since each
package draws its own).

Functions against the JAX ``.raw`` bodies under ``jax.vjp``, layers
against the JAX layers with their weights carried across (forward 1e-5,
gradients 1e-4 x max(|ref|, 1)); under ``auto_cast`` O2 in bf16 (5e-2).
Also LayerNorm's Paddle signature (``weight_attr`` / ``bias_attr``) and
the channel-first check that now takes ``NCDHW``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu.ops import nn_ops as jops
from paddle_tpu.tensor import Tensor as JTensor

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
from torch_parity_helpers import (BF16_TOL, CPU, FWD_TOL, GRAD_TOL, check_fn,
                                  check_layer, close, copy_weights,
                                  positional_names, rand)
from torch_parity_helpers import torch_one_thread  # noqa: F401 (autouse)

FN_CASES = {
    "layer_norm [2, 5, 6] over (5, 6)": (
        "layer_norm", [(2, 5, 6), (5, 6), (5, 6)],
        lambda f: lambda x, w, b: f(x, (5, 6), w, b, 1e-5)),
    "rms_norm with bias, begin_norm_axis 1": (
        "rms_norm", [(3, 4, 5), (4, 5), (4, 5)],
        lambda f: lambda x, w, b: f(x, w, b, 1e-6, 1)),
    "instance_norm NCL affine": (
        "instance_norm", [(2, 3, 7), (3,), (3,)],
        lambda f: lambda x, w, b: f(x, w, b, 1e-5)),
    "instance_norm NCHW no affine": (
        "instance_norm", [(2, 3, 5, 6)], lambda f: lambda x: f(x)),
    "instance_norm NCDHW affine": (
        "instance_norm", [(2, 3, 3, 4, 5), (3,), (3,)],
        lambda f: lambda x, w, b: f(x, w, b, 1e-3)),
    "group_norm 6 channels in 3 groups": (
        "group_norm", [(2, 6, 4, 5), (6,), (6,)],
        lambda f: lambda x, w, b: f(x, 3, w, b, 1e-5)),
    "group_norm 3-D one group": (
        "group_norm", [(2, 4, 3, 3, 3), (4,), (4,)],
        lambda f: lambda x, w, b: f(x, 1, w, b)),
    "local_response_norm size 3": (
        "local_response_norm", [(2, 7, 4, 5)],
        lambda f: lambda x: f(x, 3, 1e-2, 0.75, 1.0)),
    "local_response_norm size 4 (even)": (
        "local_response_norm", [(2, 6, 5)],
        lambda f: lambda x: f(x, 4, 0.5, 0.6, 2.0)),
}


@pytest.mark.parametrize("case", list(FN_CASES))
def test_norm_function_matches_jax(case):
    op, shapes, bind = FN_CASES[case]
    rng = np.random.default_rng(0)
    inputs = [rand(rng, *s) for s in shapes]
    check_fn(bind(getattr(jops, op).raw), bind(getattr(TF, op)), inputs)


LAYERS = {
    # name: (positional args, input shape)
    "LayerNorm": ((6, 1e-5), (2, 3, 6)),
    "RMSNorm": ((6, 1e-6), (2, 3, 6)),
    "GroupNorm": ((2, 6, 1e-5), (2, 6, 3, 4)),
    "InstanceNorm1D": ((4, 1e-5, 0.9), (2, 4, 7)),
    "InstanceNorm2D": ((4,), (2, 4, 5, 3)),
    "InstanceNorm3D": ((4,), (2, 4, 3, 3, 2)),
    "LocalResponseNorm": ((5, 1e-3, 0.75, 2.0), (2, 6, 3, 3)),
    "BatchNorm3D": ((4, 0.8), (3, 4, 2, 3, 3)),
    "SyncBatchNorm": ((4,), (3, 4, 5, 5)),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_norm_layer_matches_jax_positionally(name):
    args, xs = LAYERS[name]
    assert positional_names(getattr(tnn, name)) == \
        positional_names(getattr(jnn, name))
    jl = getattr(jnn, name)(*args)
    tl = getattr(tnn, name)(*args, **({} if name == "LocalResponseNorm"
                                      else {"device": CPU}))
    rng = np.random.default_rng(1)
    with torch.no_grad():     # a non-trivial affine in both packages
        for p in tl.parameters():
            p.copy_(torch.from_numpy(rand(rng, *p.shape)))
    jl.set_state_dict({k: v.numpy() for k, v in tl.state_dict().items()})
    check_layer(jl, tl, [rand(rng, *xs)])


@pytest.mark.parametrize("name", ["BatchNorm3D", "SyncBatchNorm"])
def test_batch_norm_3d_running_statistics_match_jax_over_three_steps(name):
    rng = np.random.default_rng(2)
    jl, tl = getattr(jnn, name)(4), getattr(tnn, name)(4, device=CPU)
    for step in range(3):
        x = rand(rng, 3, 4, 2, 3, 3, scale=1.0 + step)
        close(tl(torch.from_numpy(x)).detach().numpy(),
              np.asarray(jl(JTensor(x)).numpy()), FWD_TOL, f"step {step}")
    for key in ("_mean", "_variance"):
        close(tl.state_dict()[key].numpy(),
              np.asarray(jl.state_dict()[key].numpy()), FWD_TOL, key)
    tl.eval()
    jl.eval()
    x = rand(rng, 2, 4, 2, 2, 2)
    close(tl(torch.from_numpy(x)).detach().numpy(),
          np.asarray(jl(JTensor(x)).numpy()), FWD_TOL, "eval")
    if name == "SyncBatchNorm":
        assert tnn.SyncBatchNorm.convert_sync_batchnorm(tl) is tl


def test_layer_norm_takes_paddles_signature():
    """``LayerNorm(normalized_shape, epsilon, weight_attr, bias_attr,
    name)`` positionally, as the JAX layer: False leaves the weight or
    the bias out, an initializer sets it."""
    assert positional_names(tnn.LayerNorm) == positional_names(jnn.LayerNorm)
    ln = tnn.LayerNorm([3, 4], 1e-3, False, False, "ln", device=CPU)
    assert ln.weight is None and ln.bias is None
    assert not list(ln.parameters())
    jln = jnn.LayerNorm([3, 4], 1e-3, False, False)
    x = rand(np.random.default_rng(3), 2, 3, 4)
    close(ln(torch.from_numpy(x)).detach().numpy(),
          np.asarray(jln(JTensor(x)).numpy()), FWD_TOL)
    half = tnn.LayerNorm(4, 1e-5, tnn.initializer.Constant(0.5), False,
                         device=CPU)
    assert float(half.weight.detach().sum()) == 2.0 and half.bias is None


def test_instance_norm_without_affine_is_cyclegans():
    """``InstanceNorm2D(weight_attr=False, bias_attr=False)`` has no
    parameters and no running statistics, in both packages."""
    tl = tnn.InstanceNorm2D(8, weight_attr=False, bias_attr=False,
                            device=CPU)
    jl = jnn.InstanceNorm2D(8, weight_attr=False, bias_attr=False)
    assert not tl.state_dict() and not jl.state_dict()
    x = rand(np.random.default_rng(4), 1, 8, 6, 6, scale=3.0)
    check_fn(lambda x: jl(JTensor(x))._value,
             lambda x: tl(x), [x])


def test_spectral_norm_layer_matches_jax_with_its_buffers_carried():
    """The JAX layer draws ``weight_u`` / ``weight_v`` from its own
    generator: they are carried across by name.  Training mode advances
    them (both packages alike), eval mode does not; the output and the
    gradient through the power iteration match."""
    shape = (6, 4, 3)
    jpaddle.seed(0)
    jl = jnn.SpectralNorm(shape, dim=1, power_iters=2)
    tl = tnn.SpectralNorm(shape, 1, 2, device=CPU)
    assert positional_names(tnn.SpectralNorm) == \
        positional_names(jnn.SpectralNorm)
    copy_weights(jl, tl)
    w = rand(np.random.default_rng(5), *shape)
    for step in range(2):
        close(tl(torch.from_numpy(w)).detach().numpy(),
              np.asarray(jl(JTensor(w)).numpy()), FWD_TOL, f"step {step}")
        for k in ("weight_u", "weight_v"):
            close(tl.state_dict()[k].numpy(),
                  np.asarray(jl.state_dict()[k].numpy()), FWD_TOL, k)
    before = tl.weight_u.clone()
    tl.eval()
    jl.eval()
    tl(torch.from_numpy(w))
    assert torch.equal(before, tl.weight_u)
    check_fn(lambda w: jl(JTensor(w))._value, lambda w: tl(w), [w])


@pytest.mark.parametrize("op", ["instance_norm", "group_norm", "rms_norm",
                                "local_response_norm", "batch_norm"])
def test_norm_family_bf16_under_o2_matches_jax(op):
    """Under O2 the black list's norms take fp32 inputs in both packages;
    ``local_response_norm`` is not on it: bf16 in, bf16 out."""
    rng = np.random.default_rng(6)
    x = rand(rng, 2, 4, 3, 5, 5)
    w, b = rand(rng, 4), rand(rng, 4)
    J, T = jpaddle.to_tensor, torch.from_numpy
    calls = {
        "instance_norm": (lambda: jops.instance_norm(J(x), J(w), J(b)),
                          lambda: TF.instance_norm(T(x), T(w), T(b))),
        "group_norm": (lambda: jops.group_norm(J(x), 2, J(w), J(b)),
                       lambda: TF.group_norm(T(x), 2, T(w), T(b))),
        "rms_norm": (lambda: jops.rms_norm(J(x), J(x[0, 0, 0, 0]), None),
                     lambda: TF.rms_norm(T(x), T(x[0, 0, 0, 0]), None)),
        "local_response_norm": (
            lambda: jops.local_response_norm(J(x), 3),
            lambda: TF.local_response_norm(T(x), 3)),
        "batch_norm": (
            lambda: jops.batch_norm_train(J(x), J(np.zeros(4, np.float32)),
                                          J(np.ones(4, np.float32)), J(w),
                                          J(b))[0],
            lambda: TF.batch_norm(T(x), torch.zeros(4), torch.ones(4), T(w),
                                  T(b), True, 0.9, 1e-5, "NCDHW")),
    }
    jcall, tcall = calls[op]
    with jamp.auto_cast(level="O2", dtype="bfloat16"):
        jout = jcall()
    with tamp.auto_cast(level="O2", dtype="bfloat16"):
        tout = tcall()
    assert str(tout.dtype).split(".")[-1] == \
        str(jout.dtype).split(".")[-1], (tout.dtype, jout.dtype)
    close(tout.float().numpy(), np.asarray(jout.numpy(), np.float32),
          BF16_TOL, op)


def test_channel_first_check_takes_ncdhw_and_refuses_channel_last():
    """``NCDHW`` (every 3-D layer's layout) passes the channel-first
    check; channel-last layouts stay refused (ROADMAP item 2)."""
    x = torch.from_numpy(rand(np.random.default_rng(7), 2, 3, 2, 2, 2))
    out = TF.batch_norm(x, torch.zeros(3), torch.ones(3), training=True,
                        data_format="NCDHW")
    assert out.shape == x.shape
    for make in (lambda: tnn.InstanceNorm2D(3, data_format="NHWC",
                                            device=CPU),
                 lambda: tnn.GroupNorm(1, 3, data_format="NHWC", device=CPU),
                 lambda: TF.group_norm(x, 1, data_format="NDHWC")):
        with pytest.raises(NotImplementedError, match="channels_last"):
            make()


def test_norm_layers_without_a_device_mean_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **k: tnn.GroupNorm(2, 4, **k),
                 lambda **k: tnn.RMSNorm(4, **k),
                 lambda **k: tnn.SpectralNorm((3, 4), **k),
                 lambda **k: tnn.LayerNorm(4, **k)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        make(device=CPU)


def test_spectral_norm_functional_gradient_is_jaxs_raw_one():
    """The layer's arithmetic under ``jax.vjp`` of the JAX layer in eval
    mode, at another dim and one power iteration."""
    jl = jnn.SpectralNorm((3, 5), dim=0)
    tl = tnn.SpectralNorm((3, 5), device=CPU)
    copy_weights(jl, tl)
    jl.eval()
    tl.eval()
    w = rand(np.random.default_rng(8), 3, 5)
    jout, vjp = jax.vjp(lambda w: jl(JTensor(w))._value, jnp.asarray(w))
    t = torch.tensor(w, requires_grad=True)
    out = tl(t)
    close(out.detach().numpy(), np.asarray(jout), FWD_TOL)
    g = np.ones_like(w)
    out.backward(torch.from_numpy(g))
    close(t.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), GRAD_TOL)
