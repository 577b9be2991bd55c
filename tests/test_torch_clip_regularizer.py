"""Gradient clips, ``nn.utils`` clipping, L1/L2 regularizers and
``ParamAttr`` coefficients of the port against the JAX package, on the
same numpy weights and gradients.

Tolerances: fp32 clips and updates within 1e-6 relative + 1e-7
absolute (the same reductions in another order: the port's global norm
is the norm of the per-tensor norms); a bf16 gradient clipped by the
global norm is ``(g.float() * scale).to(bf16)`` bit for bit with the
port's own scale, and within one bf16 ulp of the JAX ``pure_clip``'s
(the two scales may differ in their last fp32 bit).  Mirrors
``tests/test_optimizer.py::test_grad_clip_global_norm`` and
``::test_weight_decay_l2_vs_decoupled``, and
``tests/test_nn_coverage.py::test_nn_utils_clip_grad_norm_`` and
``::test_clip_grad_norm_accepts_generator``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptimizer
from paddle_tpu import regularizer as jreg
from paddle_tpu.nn import utils as jutils
from paddle_tpu.tensor import Parameter as JParameter

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.nn import utils as tutils
from torch_parity_helpers import torch_one_thread  # noqa: F401

RTOL, ATOL = 1e-6, 1e-7
SHAPES = [(4, 3), (3,), (2, 5, 2)]


def _grads(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in SHAPES]


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else t.numpy() if hasattr(t, "numpy") else t)


CLIPS = {
    "value": (lambda m: m.ClipGradByValue(0.3), 1.0),
    "value asymmetric": (lambda m: m.ClipGradByValue(0.5, min=-0.1), 1.0),
    "norm": (lambda m: m.ClipGradByNorm(0.7), 1.0),
    "global norm active": (lambda m: m.ClipGradByGlobalNorm(1.0), 1.0),
    "global norm inactive": (lambda m: m.ClipGradByGlobalNorm(1.0), 0.01),
}


@pytest.mark.parametrize("name", list(CLIPS))
def test_clips_match_jax_eager_and_pure(name):
    make, scale = CLIPS[name]
    gs = _grads(1, scale)
    jclip, tclip = make(jnn), make(tnn)
    jout = jclip([(None, jpaddle.to_tensor(g)) for g in gs])
    tout = tclip([(None, torch.from_numpy(g)) for g in gs] + [(None, None)])
    assert tout[-1] == (None, None)
    jpure = jclip.pure_clip({str(i): jnp.asarray(g) for i, g in enumerate(gs)})
    tpure = tclip.pure_clip({str(i): torch.from_numpy(g)
                             for i, g in enumerate(gs)})
    tlist = tclip.pure_clip([torch.from_numpy(g) for g in gs])
    for i in range(len(gs)):
        ref = _np(jout[i][1])
        np.testing.assert_allclose(_np(tout[i][1]), ref, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(_np(tpure[str(i)]), _np(jpure[str(i)]),
                                   rtol=RTOL, atol=ATOL)
        assert torch.equal(tlist[i], tpure[str(i)])
    if "inactive" in name:
        for i, g in enumerate(gs):
            np.testing.assert_array_equal(_np(tpure[str(i)]), g)


def test_bf16_global_norm_clip_rounds_as_pure_clip():
    gs = [g.astype(np.float32) for g in _grads(2, 3.0)]
    tg = [torch.from_numpy(g).bfloat16() for g in gs]
    clip = tnn.ClipGradByGlobalNorm(1.0)
    out = clip.pure_clip(tg)
    norm = clip.global_norm(tg)
    ref64 = np.sqrt(sum((t.double() ** 2).sum().item() for t in tg))
    assert abs(norm.item() - ref64) <= 1e-6 * ref64
    scale = 1.0 / torch.clamp(norm, min=1.0)
    for o, g in zip(out, tg):
        assert o.dtype == torch.bfloat16
        assert torch.equal(o, (g.float() * scale).bfloat16())
    jout = jnn.ClipGradByGlobalNorm(1.0).pure_clip(
        {str(i): jnp.asarray(g, jnp.bfloat16) for i, g in enumerate(gs)})
    for i, o in enumerate(out):
        ref = np.asarray(jout[str(i)].astype(jnp.float32))
        got = o.float().numpy()
        ulp = np.abs(ref) * 2.0 ** -7
        assert np.all(np.abs(got - ref) <= ulp + 1e-30)
        assert (got == ref).mean() >= 0.95


def test_global_norm_clip_runs_on_device_scalars_only(monkeypatch):
    """The clip inside the optimizer's step reads no device value on
    the host: ``Tensor.item``/``__bool__``/``__float__`` are never
    called."""
    p = torch.nn.Parameter(torch.ones(4, 3))
    opt = tpaddle.optimizer.AdamW(learning_rate=0.1, parameters=[p],
                                  grad_clip=tnn.ClipGradByGlobalNorm(0.5))
    p.grad = torch.full((4, 3), 2.0)
    calls = []
    for attr in ("item", "__bool__", "__float__"):
        orig = getattr(torch.Tensor, attr)

        def spy(self, *a, _orig=orig, _attr=attr, **k):
            calls.append(_attr)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, attr, spy)
    opt.step()
    monkeypatch.undo()
    assert calls == []


def test_grad_clip_global_norm():
    clip = tnn.ClipGradByGlobalNorm(1.0)
    p = torch.nn.Parameter(torch.tensor([1.0]))
    opt = tpaddle.optimizer.SGD(learning_rate=1.0, parameters=[p],
                                grad_clip=clip)
    p.grad = torch.tensor([10.0])
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), [0.0], atol=1e-5)


def test_weight_decay_l2_vs_decoupled():
    p1 = torch.nn.Parameter(torch.tensor([1.0]))
    opt1 = tpaddle.optimizer.SGD(learning_rate=0.1, parameters=[p1],
                                 weight_decay=0.1)
    p1.grad = torch.tensor([0.0])
    opt1.step()
    np.testing.assert_allclose(p1.detach().numpy(), [0.99], rtol=1e-6)
    # decoupled (AdamW): a zero gradient still decays by lr*decay*w
    p2 = torch.nn.Parameter(torch.tensor([1.0]))
    opt2 = tpaddle.optimizer.AdamW(learning_rate=0.1, parameters=[p2],
                                   weight_decay=0.1)
    p2.grad = torch.tensor([0.0])
    opt2.step()
    np.testing.assert_allclose(p2.detach().numpy(), [0.99], rtol=1e-6)


def _fc_pair(seed=0):
    jpaddle.seed(seed)
    jfc = jnn.Linear(4, 4)
    tfc = tnn.Linear(4, 4, device="cpu")
    with torch.no_grad():
        tfc.weight.copy_(torch.from_numpy(np.asarray(jfc.weight.numpy())))
        tfc.bias.copy_(torch.from_numpy(np.asarray(jfc.bias.numpy())))
    return jfc, tfc


def _fc_grads(jfc, tfc, scale=100.0):
    x = np.ones((2, 4), np.float32) * scale
    jloss = jpaddle.mean(jfc(jpaddle.to_tensor(x)) ** 2)
    jloss.backward()
    tloss = (tfc(torch.from_numpy(x)) ** 2).mean()
    tloss.backward()


def test_nn_utils_clip_grad_norm_():
    jfc, tfc = _fc_pair()
    _fc_grads(jfc, tfc)
    jtotal = jutils.clip_grad_norm_(list(jfc.parameters()), max_norm=1.0)
    total = tutils.clip_grad_norm_(list(tfc.parameters()), max_norm=1.0)
    np.testing.assert_allclose(total.item(), float(jtotal.numpy()),
                               rtol=RTOL)
    gn = np.sqrt(sum(float((p.grad.numpy() ** 2).sum())
                     for p in tfc.parameters()))
    assert gn < 1.0 + 1e-4, gn
    assert total.item() > 1.0
    for jp, tp in zip(jfc.parameters(), tfc.parameters()):
        np.testing.assert_allclose(tp.grad.numpy(), _np(jp.grad),
                                   rtol=1e-5, atol=ATOL)
    jutils.clip_grad_value_(list(jfc.parameters()), 0.01)
    tutils.clip_grad_value_(list(tfc.parameters()), 0.01)
    for jp, tp in zip(jfc.parameters(), tfc.parameters()):
        assert np.abs(tp.grad.numpy()).max() <= 0.01 + 1e-7
        np.testing.assert_allclose(tp.grad.numpy(), _np(jp.grad),
                                   rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("norm_type", [1.0, 3.0, float("inf")])
def test_clip_grad_norm_types_match_jax(norm_type):
    jfc, tfc = _fc_pair(1)
    _fc_grads(jfc, tfc, scale=3.0)
    jt = jutils.clip_grad_norm_(jfc.parameters(), 0.5, norm_type=norm_type)
    tt = tutils.clip_grad_norm_(tfc.parameters(), 0.5, norm_type=norm_type)
    np.testing.assert_allclose(tt.item(), float(jt.numpy()), rtol=1e-5)
    for jp, tp in zip(jfc.parameters(), tfc.parameters()):
        np.testing.assert_allclose(tp.grad.numpy(), _np(jp.grad),
                                   rtol=1e-5, atol=ATOL)


def test_clip_grad_norm_accepts_generator_and_refuses_nonfinite():
    _, tfc = _fc_pair()
    _fc_grads(_fc_pair()[0], tfc)
    tutils.clip_grad_norm_((p for p in tfc.parameters()), 1.0)
    gn = np.sqrt(sum(float((p.grad.numpy() ** 2).sum())
                     for p in tfc.parameters()))
    assert gn < 1.0 + 1e-4, gn
    tfc.bias.grad[0] = float("inf")
    with pytest.raises(RuntimeError, match="non-finite"):
        tutils.clip_grad_norm_(tfc.parameters(), 1.0, error_if_nonfinite=True)


def test_parameters_to_vector_and_back():
    jfc, tfc = _fc_pair(2)
    vec = tutils.parameters_to_vector(tfc.parameters())
    np.testing.assert_array_equal(
        vec.numpy(), _np(jutils.parameters_to_vector(jfc.parameters())))
    ptr = tfc.weight.data_ptr()
    tutils.vector_to_parameters(torch.arange(vec.numel(), dtype=torch.float32),
                                tfc.parameters())
    assert tfc.weight.data_ptr() == ptr
    assert tfc.bias.detach().numpy().tolist() == [16.0, 17.0, 18.0, 19.0]


# -- regularizers and ParamAttr ------------------------------------------------

REGS = {
    "SGD L2Decay": ("SGD", lambda m: dict(weight_decay=m.L2Decay(0.05))),
    "SGD L1Decay": ("SGD", lambda m: dict(weight_decay=m.L1Decay(0.05))),
    "Momentum L1Decay": ("Momentum",
                         lambda m: dict(weight_decay=m.L1Decay(0.02))),
    "Adam L2Decay": ("Adam", lambda m: dict(weight_decay=m.L2Decay(0.1),
                                            epsilon=1e-2)),
    "Adam L1Decay": ("Adam", lambda m: dict(weight_decay=m.L1Decay(0.1),
                                            epsilon=1e-2)),
}


def _params_pair(seed=3):
    rng = np.random.default_rng(seed)
    w0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    jps = [JParameter(jnp.asarray(w), name=f"w{i}") for i, w in enumerate(w0)]
    tps = [tnn.Parameter(torch.from_numpy(w.copy()), name=f"w{i}")
           for i, w in enumerate(w0)]
    return jps, tps


def _steps(jopt, topt, jps, tps, n=3, seed=4):
    for k in range(n):
        for jp, tp, g in zip(jps, tps, _grads(seed + k)):
            jp.grad = jpaddle.to_tensor(g)
            tp.grad = torch.from_numpy(g)
        jopt.step()
        topt.step()
        for jp, tp in zip(jps, tps):
            np.testing.assert_allclose(tp.detach().numpy(), _np(jp),
                                       rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("name", list(REGS))
def test_global_regularizers_match_jax(name):
    opt_name, kw = REGS[name]
    jps, tps = _params_pair()
    jopt = getattr(joptimizer, opt_name)(learning_rate=0.05, parameters=jps,
                                         **kw(jreg))
    topt = getattr(tpaddle.optimizer, opt_name)(learning_rate=0.05,
                                                parameters=tps, **kw(treg))
    _steps(jopt, topt, jps, tps)


@pytest.mark.parametrize("opt_name", ["SGD", "Momentum", "Adam", "AdamW"])
def test_param_attr_regularizer_and_learning_rate_match_jax(opt_name):
    """Per parameter: an L1Decay, an L2Decay and a learning-rate scale
    of 0.5 (``ParamAttr``), beside the optimizer's own float decay; the
    per-parameter regularizer wins.  The JAX parameters get the same
    attributes as its ``create_parameter`` sets them."""
    jps, tps = _params_pair(5)
    attrs = [tnn.ParamAttr(regularizer=treg.L1Decay(0.03)),
             tnn.ParamAttr(regularizer=treg.L2Decay(0.2), learning_rate=0.5),
             tnn.ParamAttr(learning_rate=0.5)]
    jregs = [jreg.L1Decay(0.03), jreg.L2Decay(0.2), None]
    for jp, tp, a, r in zip(jps, tps, attrs, jregs):
        jp.regularizer = r
        jp.optimize_attr["learning_rate"] = a.learning_rate
        tp.regularizer = a.regularizer
        tp.optimize_attr["learning_rate"] = a.learning_rate
    kw = dict(learning_rate=0.05, weight_decay=0.01)
    jopt = getattr(joptimizer, opt_name)(parameters=jps, **kw)
    topt = getattr(tpaddle.optimizer, opt_name)(parameters=tps, **kw)
    _steps(jopt, topt, jps, tps)


def test_param_attr_builds_parameters_as_create_parameter_does():
    attr = tnn.ParamAttr(name="fc_w", initializer=tnn.initializer.Constant(
        0.25), learning_rate=0.1, regularizer=treg.L1Decay(0.5),
        trainable=False)
    fc = tnn.Linear(3, 2, weight_attr=attr, bias_attr=tnn.ParamAttr(
        learning_rate=2.0), device="cpu")
    assert isinstance(fc.weight, tnn.Parameter) and fc.weight.name == "fc_w"
    assert np.all(fc.weight.detach().numpy() == 0.25)
    assert fc.weight.optimize_attr == {"learning_rate": 0.1}
    assert isinstance(fc.weight.regularizer, treg.L1Decay)
    assert not fc.weight.requires_grad and not fc.weight.trainable
    assert fc.bias.optimize_attr["learning_rate"] == 2.0
    assert fc.bias.name.startswith("param_") and fc.bias.requires_grad
    j = jnn.Linear(3, 2, weight_attr=jnn.ParamAttr(
        name="fc_w", learning_rate=0.1, regularizer=jreg.L1Decay(0.5),
        trainable=False))
    assert (j.weight.name, j.weight.optimize_attr, j.weight.stop_gradient) \
        == ("fc_w", {"learning_rate": 0.1}, True)
    # a frozen parameter takes no update
    opt = tpaddle.optimizer.SGD(0.1, parameters=fc.parameters())
    fc(torch.ones(1, 3)).sum().backward()
    opt.step()
    assert np.all(fc.weight.detach().numpy() == 0.25)
    # parameters a layer makes are named apart
    names = [p.name for p in tnn.Linear(2, 2, device="cpu").parameters()]
    assert len(set(names)) == 2 and all(n.startswith("param_") for n in names)


def test_apply_decay_param_fun_reads_the_parameter_names():
    """AdamW decays only the parameters whose ``name`` the function
    accepts (PaddleNLP's ``p.name in decay_params``), against JAX."""
    jps, tps = _params_pair(6)
    jdecay = [p.name for p in jps[:2]]
    tdecay = [p.name for p in tps[:2]]
    jopt = joptimizer.AdamW(learning_rate=0.05, weight_decay=0.3,
                            parameters=jps,
                            apply_decay_param_fun=lambda n: n in jdecay)
    topt = tpaddle.optimizer.AdamW(learning_rate=0.05, weight_decay=0.3,
                                   parameters=tps,
                                   apply_decay_param_fun=lambda n: n in tdecay)
    _steps(jopt, topt, jps, tps)
    assert [topt._param_decay(i, p) for i, p in enumerate(tps)] == \
        [0.3, 0.3, 0.0]
