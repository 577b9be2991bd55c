"""``nn.utils.weight_norm``, ``remove_weight_norm`` and ``spectral_norm``
of the port against the JAX package: the reparametrised parameters by
the JAX names (``weight_g`` / ``weight_v``; ``weight_orig`` with the
buffers ``weight_u`` / ``weight_v``), the weight the forward pre-hook
sets, the gradients of the new parameters, folding back, the power
iteration's buffers in training and eval mode, and three SGD steps of a
weight-normed network through ``Model.fit`` in both packages.  Weights
cross by ``state_dict_from_jax`` (names and shapes checked); the JAX
spectral norm draws its own ``u`` / ``v``, so they are carried across
too.  Tolerances: forward 1e-5, gradients 1e-4 x max(|ref|, 1).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import utils as jutils

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import utils as tutils
from paddle_tpu_torch.vision.models import state_dict_from_jax
from torch_parity_helpers import (CPU, FWD_TOL, GRAD_TOL, check_layer_eager,
                                  close, rand)
from torch_parity_helpers import torch_one_thread  # noqa: F401 (autouse)


def _pair(kind):
    jpaddle.seed(0)
    if kind == "conv":
        return jnn.Conv2D(3, 4, 3, padding=1), tnn.Conv2D(3, 4, 3, padding=1,
                                                          device=CPU)
    return jnn.Linear(5, 6), tnn.Linear(5, 6, device=CPU)


def _input(kind, seed=1):
    rng = np.random.default_rng(seed)
    return rand(rng, 2, 3, 5, 5) if kind == "conv" else rand(rng, 4, 5)


@pytest.mark.parametrize("kind, dim", [("conv", 0), ("conv", 1),
                                       ("conv", None), ("linear", 1),
                                       ("linear", -2)])
def test_weight_norm_matches_jax(kind, dim):
    jl, tl = _pair(kind)
    jutils.weight_norm(jl, "weight", dim)
    tutils.weight_norm(tl, "weight", dim)
    assert list(dict(tl.named_parameters())) == \
        list(dict(jl.named_parameters()))
    state = state_dict_from_jax(jl, tl)
    assert tuple(state["weight_g"].shape) == tuple(tl.weight_g.shape)
    check_layer_eager(jl, tl, [_input(kind)])
    close(tl.weight.detach().numpy(), np.asarray(jl.weight.numpy()),
          FWD_TOL, "the hook's weight")


def test_weight_norm_recomputes_after_a_step_and_folds_back():
    jl, tl = _pair("conv")
    jutils.weight_norm(jl)
    tutils.weight_norm(tl)
    tl.set_state_dict(state_dict_from_jax(jl, tl))
    g = rand(np.random.default_rng(2), *tl.weight_g.shape)
    with torch.no_grad():
        tl.weight_g.copy_(torch.from_numpy(g))
    jl.set_state_dict({"weight_g": g})
    x = _input("conv", 3)
    close(tl(torch.from_numpy(x)).detach().numpy(),
          np.asarray(jl(jpaddle.to_tensor(x)).numpy()), FWD_TOL, "after g")
    jutils.remove_weight_norm(jl)
    tutils.remove_weight_norm(tl)
    assert sorted(dict(tl.named_parameters())) == ["bias", "weight"]
    close(tl.weight.detach().numpy(), np.asarray(jl.weight.numpy()), FWD_TOL)
    assert isinstance(tl.weight, torch.nn.Parameter)
    with pytest.raises(AttributeError):
        tutils.remove_weight_norm(tl)


@pytest.mark.parametrize("dim, iters", [(0, 1), (1, 3)])
def test_spectral_norm_matches_jax_with_its_buffers_carried(dim, iters):
    jl, tl = _pair("conv")
    jutils.spectral_norm(jl, "weight", iters, 1e-12, dim)
    tutils.spectral_norm(tl, "weight", iters, 1e-12, dim,
                         generator=torch.Generator().manual_seed(0))
    assert sorted(dict(tl.named_parameters())) == ["bias", "weight_orig"]
    assert sorted(dict(tl.named_buffers())) == ["weight_u", "weight_v"]
    tl.set_state_dict(state_dict_from_jax(jl, tl))
    x = _input("conv", 4)
    for step in range(2):     # training mode: the buffers advance alike
        check_layer_eager(jl, tl, [x], seed=step)
        for k in ("weight_u", "weight_v"):
            close(tl.state_dict()[k].numpy(),
                  np.asarray(jl.state_dict()[k].numpy()), FWD_TOL, k)
        jl.clear_gradients()
        tl.clear_gradients()
    tl.eval()
    before = tl.weight_u.clone()
    tl(torch.from_numpy(x))
    assert torch.equal(before, tl.weight_u)


def test_spectral_norm_sigma_is_the_leading_singular_value():
    """Many power iterations from any start: the weight over its largest
    singular value (the port's own draws)."""
    tl = tnn.Linear(7, 5, device=CPU)
    w = tl.weight.detach().clone()
    tutils.spectral_norm(tl, n_power_iterations=50, dim=1)
    sigma = torch.linalg.svdvals(w.t())[0]
    close(tl.weight.detach().numpy(), (w / sigma).numpy(), 1e-5)


def test_weight_normed_network_trains_through_fit_like_jax():
    """Three SGD steps of ``Linear(weight_norm) -> tanh -> Linear`` through
    ``Model.fit`` in both packages: the g, v and bias after them."""
    rng = np.random.default_rng(5)
    batches = [(rand(rng, 8, 5), rand(rng, 8, 3)) for _ in range(3)]

    def build(nn, utils, **kw):
        net = nn.Sequential(nn.Linear(5, 6, **kw), nn.Tanh(),
                            nn.Linear(6, 3, **kw))
        utils.weight_norm(net[0])
        return net

    jpaddle.seed(0)
    jnet = build(jnn, jutils)
    tnet = build(tnn, tutils, device=CPU)
    tnet.set_state_dict(state_dict_from_jax(jnet, tnet))
    jm = jpaddle.Model(jnet)
    jm.prepare(jpaddle.optimizer.SGD(0.1, parameters=jnet.parameters()),
               jnn.MSELoss())
    jm.fit([(jpaddle.to_tensor(a), jpaddle.to_tensor(b))
            for a, b in batches], epochs=1, verbose=0)
    tm = tpaddle.Model(tnet, device=CPU)
    tm.prepare(tpaddle.optimizer.SGD(0.1, parameters=tnet.parameters()),
               tnn.MSELoss())
    tm.fit([(torch.from_numpy(a), torch.from_numpy(b)) for a, b in batches],
           epochs=1, verbose=0)
    jstate = jnet.state_dict()
    for k, v in tnet.state_dict().items():
        close(v.numpy(), np.asarray(jstate[k].numpy()), GRAD_TOL, k)
