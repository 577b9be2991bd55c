"""The port's optimizers against the JAX package's, three steps from the
same fp32 weights with the same gradients (one parametrised case per
update rule), and ``LBFGS``.

Tolerance: 1e-6 relative + 1e-6 absolute on every parameter after each
step (the same fp32 arithmetic, with sums and fused products that may
round in another order).  ``LBFGS`` without a line search matches the
JAX package to the same tolerance; with ``strong_wolfe`` the port
follows optax's zoom line search, and is held against optax's
``lbfgs`` driven directly on the same function (the JAX package's
closure plumbing evaluates its probes differently, see ROADMAP's
non-comparable areas).  Mirrors ``tests/test_utils.py::
test_lbfgs_respects_grad_clip_and_decay`` and ``tests/test_lbfgs.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.tensor import Parameter as JParameter

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import nn as tnn
from torch_parity_helpers import torch_one_thread  # noqa: F401

TOL = 1e-6
SHAPES = [(4, 3), (3,), (2, 5, 2)]

CASES = {
    "SGD": ("SGD", dict(learning_rate=0.1, weight_decay=0.01)),
    "Momentum nesterov": ("Momentum", dict(learning_rate=0.1, momentum=0.8,
                                           use_nesterov=True,
                                           weight_decay=0.01)),
    "Adam": ("Adam", dict(learning_rate=0.05, epsilon=1e-2,
                          weight_decay=0.01)),
    "Adam amsgrad": ("Adam", dict(learning_rate=0.05, epsilon=1e-3,
                                  amsgrad=True)),
    "AdamW amsgrad": ("AdamW", dict(learning_rate=0.05, weight_decay=0.1,
                                    amsgrad=True)),
    "Adagrad": ("Adagrad", dict(learning_rate=0.1, weight_decay=0.01,
                                initial_accumulator_value=0.1)),
    "RMSProp": ("RMSProp", dict(learning_rate=0.01, weight_decay=0.01)),
    "RMSProp centered momentum": ("RMSProp", dict(learning_rate=0.01,
                                                  centered=True,
                                                  momentum=0.9)),
    "Lamb": ("Lamb", dict(learning_rate=0.05, lamb_weight_decay=0.1)),
    "Adadelta": ("Adadelta", dict(learning_rate=1.0, weight_decay=0.01)),
    "Adamax": ("Adamax", dict(learning_rate=0.05, weight_decay=0.01)),
}


def _pair(seed=0):
    rng = np.random.default_rng(seed)
    w0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    jps = [JParameter(jnp.asarray(w), name=f"w{i}") for i, w in enumerate(w0)]
    tps = [tnn.Parameter(torch.from_numpy(w.copy()), name=f"w{i}")
           for i, w in enumerate(w0)]
    return w0, jps, tps


def _grads(k):
    rng = np.random.default_rng(100 + k)
    scale = (1.0, 1e-3, 0.3)[k % 3]
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in SHAPES]


def _three_steps(jopt, topt, jps, tps):
    for k in range(3):
        for jp, tp, g in zip(jps, tps, _grads(k)):
            jp.grad = jpaddle.to_tensor(g)
            tp.grad = torch.from_numpy(g)
        jopt.step()
        topt.step()
        for jp, tp in zip(jps, tps):
            np.testing.assert_allclose(tp.detach().numpy(),
                                       np.asarray(jp.numpy()), rtol=TOL,
                                       atol=TOL, err_msg=f"step {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_three_steps_match_jax(name):
    opt_name, kw = CASES[name]
    w0, jps, tps = _pair()
    jopt = getattr(joptimizer, opt_name)(parameters=jps, **kw)
    topt = getattr(tpaddle.optimizer, opt_name)(parameters=tps, **kw)
    _three_steps(jopt, topt, jps, tps)
    assert not np.allclose(tps[0].detach().numpy(), w0[0])
    assert topt._global_step == 3
    for i, st in topt._state.items():
        assert st["steps"] == 3
        jst = jopt._state[jps[i].name]
        for slot, v in st.items():
            if slot == "steps":
                continue
            np.testing.assert_allclose(v.numpy(), np.asarray(jst[slot]),
                                       rtol=1e-5, atol=TOL, err_msg=slot)


def test_amsgrad_keeps_the_largest_second_moment():
    _, _, tps = _pair(1)
    opt = tpaddle.optimizer.Adam(learning_rate=0.01, parameters=tps[:1],
                                 amsgrad=True)
    peaks = []
    for scale in (1.0, 0.01):
        tps[0].grad = torch.full_like(tps[0], scale)
        opt.step()
        st = opt._state[0]
        peaks.append(st["moment2_max"].clone())
        assert torch.all(st["moment2_max"] >= st["moment2"])
    assert torch.equal(peaks[0] * 0.999 < peaks[1], torch.ones_like(
        peaks[0], dtype=torch.bool))


def test_lamb_exclude_from_weight_decay_matches_jax():
    _, jps, tps = _pair(2)
    kw = dict(learning_rate=0.05, lamb_weight_decay=0.2)
    jopt = joptimizer.Lamb(parameters=jps, exclude_from_weight_decay_fn=(
        lambda n: n == jps[1].name), **kw)
    topt = tpaddle.optimizer.Lamb(
        parameters=tps, exclude_from_weight_decay_fn=lambda n: n == "w1",
        **kw)
    _three_steps(jopt, topt, jps, tps)
    assert [topt._param_decay(i, p) for i, p in enumerate(tps)] == \
        [0.2, 0.0, 0.2]


def test_lamb_trust_ratio_is_one_where_a_norm_is_zero():
    p = tnn.Parameter(torch.zeros(3))
    opt = tpaddle.optimizer.Lamb(learning_rate=0.1, lamb_weight_decay=0.0,
                                 parameters=[p])
    p.grad = torch.ones(3)
    opt.step()
    # |w| = 0: the trust ratio is 1 and the step is lr * r, r = m1hat /
    # (sqrt(m2hat) + eps) with the bias corrections rounded in fp32
    f = np.float32
    m1h = f(1 - 0.9) / (f(1) - f(0.9))
    m2h = f(1 - 0.999) / (f(1) - f(0.999))
    r = m1h / (np.sqrt(m2h) + f(1e-6))
    np.testing.assert_allclose(p.detach().numpy(), [-0.1 * r] * 3, rtol=1e-6)


# -- LBFGS --------------------------------------------------------------------

def _rosen(w):
    return (1.0 - w[0]) ** 2 + 100.0 * (w[1] - w[0] * w[0]) ** 2


def _lbfgs_pair(lr, ls, start=(-1.2, 1.0), **kw):
    jw = JParameter(jnp.asarray(np.array(start, np.float32)), name="w")
    tw = tnn.Parameter(torch.tensor(start, dtype=torch.float32), name="w")
    jopt = joptimizer.LBFGS(learning_rate=lr, line_search_fn=ls,
                            parameters=[jw], **kw)
    topt = tpaddle.optimizer.LBFGS(learning_rate=lr, line_search_fn=ls,
                                   parameters=[tw], **kw)

    def jc():
        jopt.clear_grad()
        loss = _rosen(jw)
        loss.backward()
        return loss

    def tc():
        topt.clear_grad()
        loss = _rosen(tw)
        loss.backward()
        return loss

    return (jw, jopt, jc), (tw, topt, tc)


def test_lbfgs_fixed_step_matches_jax():
    (jw, jopt, jc), (tw, topt, tc) = _lbfgs_pair(1e-3, None, max_iter=6)
    for _ in range(3):
        jl, tl = jopt.step(jc), topt.step(tc)
        np.testing.assert_allclose(float(tl), float(jl.numpy()), rtol=TOL)
        np.testing.assert_allclose(tw.detach().numpy(),
                                   np.asarray(jw.numpy()), rtol=TOL, atol=TOL)


def test_lbfgs_strong_wolfe_follows_optax():
    """One iteration per step, so the step sequence is optax's:
    ``optax.lbfgs(learning_rate=1, memory_size=100)`` (its zoom line
    search, initial guess 1) on the same function."""
    tw = tnn.Parameter(torch.tensor([-1.2, 1.0]), name="w")
    topt = tpaddle.optimizer.LBFGS(learning_rate=1.0, max_iter=1,
                                   max_eval=100, parameters=[tw],
                                   line_search_fn="strong_wolfe")

    def tc():
        topt.clear_grad()
        loss = _rosen(tw)
        loss.backward()
        return loss

    tx = optax.lbfgs(learning_rate=1.0, memory_size=100)
    w = jnp.array([-1.2, 1.0], jnp.float32)
    state = tx.init(w)
    vg = jax.value_and_grad(_rosen)
    for k in range(6):
        v, g = vg(w)
        u, state = tx.update(g, state, w, value=v, grad=g, value_fn=_rosen)
        w = optax.apply_updates(w, u)
        loss = topt.step(tc)
        np.testing.assert_allclose(float(loss), float(v), rtol=1e-5)
        np.testing.assert_allclose(tw.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6, err_msg=f"step {k}")


def test_rosenbrock_strong_wolfe():
    tw = tnn.Parameter(torch.tensor([-1.2, 1.0]), name="w")
    opt = tpaddle.optimizer.LBFGS(learning_rate=1.0, max_iter=20,
                                  line_search_fn="strong_wolfe",
                                  parameters=[tw])

    def closure():
        opt.clear_grad()
        loss = _rosen(tw)
        loss.backward()
        return loss

    for _ in range(6):
        loss = opt.step(closure)
    assert float(loss) < 1e-6
    np.testing.assert_allclose(tw.detach().numpy(), [1.0, 1.0], atol=1e-3)


def test_linear_regression_matches_closed_form():
    rng = np.random.RandomState(0)
    X = torch.from_numpy(rng.rand(64, 3).astype(np.float32))
    true_w = torch.tensor([[2.0], [-1.0], [0.5]])
    Y = X @ true_w
    lin = tnn.Linear(3, 1, bias_attr=False, device="cpu")
    opt = tpaddle.optimizer.LBFGS(max_iter=30, line_search_fn="strong_wolfe",
                                  parameters=lin.parameters())

    def closure():
        opt.clear_grad()
        loss = ((lin(X) - Y) ** 2).mean()
        loss.backward()
        return loss

    for _ in range(3):
        loss = opt.step(closure)
    assert float(loss) < 1e-9
    np.testing.assert_allclose(lin.weight.detach().numpy(), true_w.numpy(),
                               atol=1e-3)


def test_lbfgs_respects_grad_clip_and_decay():
    """The clip bounds the step; an L2 decay and an L1 term enter the
    direction as in the JAX package (held against it, fixed step)."""
    w = tnn.Parameter(torch.tensor([10.0]), name="w")
    opt = tpaddle.optimizer.LBFGS(learning_rate=1.0, max_iter=1,
                                  parameters=[w],
                                  grad_clip=tnn.ClipGradByValue(0.01))

    def closure():
        opt.clear_grad()
        loss = (w * w).sum()
        loss.backward()
        return loss

    opt.step(closure)
    assert abs(w.item() - 10.0) < 0.5
    from paddle_tpu import regularizer as jreg
    from paddle_tpu_torch import regularizer as treg
    for jr, tr in ((0.1, 0.1), (jreg.L1Decay(0.3), treg.L1Decay(0.3))):
        jw = JParameter(jnp.asarray(np.array([3.0, -2.0], np.float32)),
                        name="w")
        tw = tnn.Parameter(torch.tensor([3.0, -2.0]), name="w")
        jopt = joptimizer.LBFGS(learning_rate=0.05, max_iter=4,
                                parameters=[jw], weight_decay=jr,
                                grad_clip=jnn.ClipGradByGlobalNorm(2.0))
        topt = tpaddle.optimizer.LBFGS(learning_rate=0.05, max_iter=4,
                                       parameters=[tw], weight_decay=tr,
                                       grad_clip=tnn.ClipGradByGlobalNorm(2.0))

        def jc():
            jopt.clear_grad()
            loss = (jw * jw * jw * jw).sum()
            loss.backward()
            return loss

        def tc():
            topt.clear_grad()
            loss = (tw ** 4).sum()
            loss.backward()
            return loss

        jopt.step(jc)
        topt.step(tc)
        # four iterations of fp32 two-loop arithmetic in another order
        np.testing.assert_allclose(tw.detach().numpy(),
                                   np.asarray(jw.numpy()), rtol=1e-5,
                                   atol=1e-5)


def test_step_requires_closure_bad_linesearch_and_duplicate_names():
    w = tnn.Parameter(torch.zeros(2), name="w")
    opt = tpaddle.optimizer.LBFGS(parameters=[w])
    with pytest.raises(ValueError, match="closure"):
        opt.step()
    with pytest.raises(ValueError, match="strong_wolfe"):
        tpaddle.optimizer.LBFGS(parameters=[w], line_search_fn="backtracking")
    a, b = tnn.Parameter(torch.zeros(1), name="same"), \
        tnn.Parameter(torch.zeros(1), name="same")
    with pytest.raises(ValueError, match="duplicate parameter names"):
        tpaddle.optimizer.LBFGS(parameters=[a, b]).step(
            lambda: torch.zeros(()))


def test_set_lr_takes_effect():
    tw2 = tnn.Parameter(torch.tensor([4.0]), name="w")
    opt = tpaddle.optimizer.LBFGS(learning_rate=1e-6, max_iter=1,
                                  parameters=[tw2])

    def closure():
        opt.clear_grad()
        loss = (tw2 * tw2).sum()
        loss.backward()
        return loss

    opt.step(closure)
    assert abs(tw2.item() - 4.0) < 1e-4
    opt.set_lr(0.4)
    for _ in range(40):
        loss = opt.step(closure)
    assert float(loss) < 1e-5
