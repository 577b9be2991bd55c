"""Every loss of ``nn/loss.py`` in the PyTorch port against the JAX
package, on the CPU.

The same numpy inputs (from a seed) go through each JAX loss layer and
the port's, with autograd on both sides: the loss, and the gradient of
each floating input for one random cotangent.  ``cross_entropy`` runs
over weight x ignore_index x soft_label x label_smoothing x axis x
use_softmax, and CTC over ragged input and label lengths with each
reduction and ``norm_by_times``.

Tolerances (fp32): 1e-5 x max(|ref|, 1) for the losses and their
gradients: the two compute the same sums in another order.
"""

import numpy as np
import pytest
import scipy.special as sp
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
from torch_parity_helpers import torch_one_thread  # noqa: F401

TOL = 1e-5


def _close(got, ref, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * scale,
                               err_msg=what)


def _run_both(jcall, tcall, floats, others=(), seed=0):
    """``jcall(*jax tensors)`` and ``tcall(*torch tensors)`` on the same
    ``floats`` (differentiated) and ``others`` (integer or fixed
    inputs): the loss, and each float input's gradient of ``sum(loss
    * g)`` for a random ``g``."""
    jf = [jpaddle.to_tensor(a, stop_gradient=False) for a in floats]
    jo = [jpaddle.to_tensor(a) for a in others]
    tf = [torch.tensor(a, requires_grad=True) for a in floats]
    to = [torch.tensor(a) for a in others]
    jout = jcall(*jf, *jo)
    tout = tcall(*tf, *to)
    _close(tout.detach().numpy(), jout.numpy(), "loss")
    rng = np.random.default_rng(seed + 1)
    g = rng.standard_normal(tuple(jout.shape)).astype(np.float32)
    (jout * jpaddle.to_tensor(g)).sum().backward()
    (tout * torch.from_numpy(g)).sum().backward()
    for i, (j, t) in enumerate(zip(jf, tf)):
        _close(t.grad.numpy(), j.grad.numpy(), f"grad {i}")


def _r(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _case(name, rng):
    """(layer kwargs, float inputs, other inputs) of one loss."""
    x, y = _r(rng, 4, 6), _r(rng, 4, 6)
    pm1 = np.where(rng.random(4) > 0.5, 1.0, -1.0).astype(np.float32)
    probs = sp.expit(x).astype(np.float32)
    bits = (rng.random((4, 6)) > 0.5).astype(np.float32)
    labels = rng.integers(0, 6, 4)
    if name == "CrossEntropyLoss":
        return {}, [x], [labels]
    if name in ("MSELoss", "L1Loss"):
        return {"reduction": "sum"}, [x, y], []
    if name == "NLLLoss":
        logp = sp.log_softmax(x, -1).astype(np.float32)
        w = rng.random(6).astype(np.float32)
        labels = np.array([0, 3, 2, 3])
        return {"weight": w, "ignore_index": 2}, [logp], [labels]
    if name == "BCELoss":
        return {}, [probs], [bits]
    if name == "BCEWithLogitsLoss":
        return {"reduction": "none"}, [x], [bits]
    if name in ("SmoothL1Loss", "HuberLoss"):
        return {"delta": 0.7}, [x, y], []
    if name == "KLDivLoss":
        logp = sp.log_softmax(x, -1).astype(np.float32)
        return {"reduction": "batchmean"}, [logp], [
            sp.softmax(y, -1).astype(np.float32)]
    if name == "MarginRankingLoss":
        return {"margin": 0.1}, [x[:, 0], y[:, 0]], [pm1]
    if name == "CosineEmbeddingLoss":
        return {"margin": 0.2}, [x, y], [pm1.astype(np.int64)]
    if name in ("SoftMarginLoss", "HingeEmbeddingLoss"):
        sign = np.where(bits > 0, 1.0, -1.0).astype(np.float32)
        return {}, [x], [sign]
    if name == "PoissonNLLLoss":
        counts = rng.integers(0, 5, (4, 6)).astype(np.float32)
        return {"full": True}, [x], [counts]
    if name == "GaussianNLLLoss":
        var = (rng.random((4, 6)) + 0.1).astype(np.float32)
        return {"full": True}, [x, y, var], []
    if name == "TripletMarginLoss":
        return {"swap": True}, [x, y, _r(rng, 4, 6)], []
    if name == "MultiLabelSoftMarginLoss":
        return {}, [x], [bits]
    if name == "CTCLoss":
        lp = _r(rng, 9, 3, 5)
        lab = np.array([[1, 2, 2], [3, 4, 0], [1, 0, 0]])
        return {}, [lp], [lab, np.array([9, 7, 5]), np.array([3, 2, 1])]
    if name == "PairwiseDistance":
        return {"p": 3.0}, [x, y], []
    raise KeyError(name)


LOSSES = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
          "BCEWithLogitsLoss", "SmoothL1Loss", "KLDivLoss",
          "MarginRankingLoss", "CosineEmbeddingLoss", "HuberLoss",
          "SoftMarginLoss", "HingeEmbeddingLoss", "PoissonNLLLoss",
          "GaussianNLLLoss", "TripletMarginLoss", "MultiLabelSoftMarginLoss",
          "CTCLoss", "PairwiseDistance"]


@pytest.mark.parametrize("name", LOSSES)
def test_loss_layer_matches_jax(name):
    rng = np.random.default_rng(LOSSES.index(name))
    kw, floats, others = _case(name, rng)
    jl, tl = getattr(jnn, name)(**kw), getattr(tnn, name)(**kw)
    _run_both(lambda *a: jl(*a), lambda *a: tl(*a), floats, others)


def test_every_jax_loss_is_ported():
    want = {n for n in dir(jnn) if n.endswith("Loss")} | {"PairwiseDistance"}
    assert want == set(LOSSES)


@pytest.mark.parametrize("use_softmax", [True, False])
@pytest.mark.parametrize("axis", [-1, 1])
@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
@pytest.mark.parametrize("soft_label", [False, True])
@pytest.mark.parametrize("extras", ["plain", "weight+ignore"])
def test_cross_entropy_options(extras, soft_label, label_smoothing, axis,
                               use_softmax):
    rng = np.random.default_rng(7)
    c = 5
    shape = (3, 4, c) if axis == -1 else (3, c, 4)
    logits = _r(rng, *shape)
    if not use_softmax:
        logits = sp.softmax(logits, axis=axis).astype(np.float32)
    if soft_label:
        label = sp.softmax(_r(rng, *shape), axis=axis).astype(np.float32)
    else:
        label = rng.integers(0, c, (3, 4))
        label[0, 1] = 2
    kw = dict(soft_label=soft_label, label_smoothing=label_smoothing,
              axis=axis, use_softmax=use_softmax)
    if extras == "weight+ignore":
        kw.update(weight=rng.random(c).astype(np.float32), ignore_index=2)
    jl, tl = jnn.CrossEntropyLoss(**kw), tnn.CrossEntropyLoss(**kw)
    _run_both(lambda x, lab: jl(x, lab), lambda x, lab: tl(x, lab),
              [logits], [label])


@pytest.mark.parametrize("norm_by_times", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_ctc_ragged(reduction, norm_by_times):
    rng = np.random.default_rng(11)
    T, B, C, L = 12, 4, 6, 5
    lp = _r(rng, T, B, C)
    in_len = np.array([12, 9, 7, 10])
    lab_len = np.array([5, 3, 1, 4])
    labels = rng.integers(1, C, (B, L))
    labels[1, 1] = labels[1, 0]          # a repeat needs a blank between
    jl = jnn.CTCLoss(blank=0, reduction=reduction)
    tl = tnn.CTCLoss(blank=0, reduction=reduction)
    _run_both(
        lambda x, lab, il, ll: jl(x, lab, il, ll, norm_by_times=norm_by_times),
        lambda x, lab, il, ll: tl(x, lab, il, ll, norm_by_times=norm_by_times),
        [lp], [labels, in_len, lab_len])


def test_losses():
    """Mirrors ``tests/test_nn.py::test_losses`` on the port."""
    rng = np.random.default_rng(0)
    logits = torch.tensor(rng.standard_normal((4, 5)).astype(np.float32))
    labels = torch.tensor([0, 1, 2, 3])
    loss = tnn.CrossEntropyLoss()(logits, labels)
    assert loss.shape == ()
    logp = sp.log_softmax(logits.numpy(), axis=-1)
    expect = -logp[np.arange(4), labels.numpy()].mean()
    np.testing.assert_allclose(loss.numpy(), expect, rtol=1e-5)
    a, b = (torch.tensor(rng.standard_normal((3, 3)).astype(np.float32))
            for _ in range(2))
    np.testing.assert_allclose(tnn.MSELoss()(a, b).numpy(),
                               ((a.numpy() - b.numpy()) ** 2).mean(),
                               rtol=1e-5)


def test_cross_entropy_with_2d_label():
    """Mirrors ``tests/test_nn.py::test_cross_entropy_with_2d_label``:
    labels ``[N, 1]`` give the loss of labels ``[N]``."""
    rng = np.random.default_rng(0)
    logits = torch.tensor(rng.standard_normal((4, 5)).astype(np.float32))
    loss = tnn.CrossEntropyLoss()(logits, torch.tensor([[0], [1], [2], [3]]))
    assert loss.shape == ()
    flat = tnn.CrossEntropyLoss()(logits, torch.tensor([0, 1, 2, 3]))
    assert torch.equal(loss, flat)


def test_softmax_with_cross_entropy_keeps_the_axis():
    rng = np.random.default_rng(3)
    x = _r(rng, 4, 5)
    lab = rng.integers(0, 5, (4, 1))
    from paddle_tpu.ops import nn_ops as jops
    jl, js = jops.softmax_with_cross_entropy(
        jpaddle.to_tensor(x), jpaddle.to_tensor(lab), return_softmax=True)
    tl, ts = TF.softmax_with_cross_entropy(torch.tensor(x), torch.tensor(lab),
                                           return_softmax=True)
    assert tuple(tl.shape) == (4, 1)
    _close(tl.numpy(), jl.numpy(), "loss")
    _close(ts.numpy(), js.numpy(), "softmax")
