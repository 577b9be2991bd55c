"""Dygraph autograd of the port against the JAX package's
(``tests/test_autograd.py`` and ``tests/test_autograd_functional.py``'s
cases, each run in both packages on the same inputs): accumulation,
``retain_graph``, hooks, ``no_grad``, ``paddle.grad`` with
``create_graph`` (double and triple backward), ``PyLayer``, ``jvp`` /
``vjp`` / ``jacobian`` / ``hessian``; and the port's stated departures:
a second ``backward`` through a freed graph raises, ``create_graph``
runs hooks, and the kernels' Functions refuse a double backward."""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import autograd as jautograd

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import autograd as tautograd
from torch_parity_helpers import torch_one_thread  # noqa: F401

PKGS = [(jpaddle, jautograd), (tpaddle, tautograd)]
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tpaddle.get_device()
    tpaddle.set_device("cpu")
    yield
    tpaddle.set_device(prev)


def _t(P, v, sg=True):
    return P.to_tensor(np.asarray(v, np.float32), stop_gradient=sg)


def _g(t):
    return None if t is None else np.asarray(t.numpy())


def case_chain(P, A):
    x = _t(P, [2.0], False)
    (x * x * x).backward()
    return [_g(x.grad)]


def case_accumulate(P, A):
    x = _t(P, [1.0], False)
    (x * 2).backward()
    (x * 3).backward()
    g = _g(x.grad)
    x.clear_grad()
    return [g, x.grad is None]


def case_fan_in(P, A):
    x = _t(P, [3.0], False)
    (x * x + x * 2 + x).backward()
    return [_g(x.grad)]


def case_stop_gradient(P, A):
    x, y = _t(P, [1.0], False), _t(P, [2.0])
    (x * y).backward()
    return [_g(x.grad), y.grad is None]


def case_no_grad(P, A):
    x = _t(P, [1.0], False)
    with P.no_grad():
        y = x * 2
    P.set_grad_enabled(False)
    z = x * 3
    P.set_grad_enabled(True)
    return [y.stop_gradient, z.stop_gradient, P.is_grad_enabled()]


def case_grad_api(P, A):
    x = _t(P, [2.0], False)
    (gx,) = P.grad(x * x, x)
    return [_g(gx), x.grad is None]


def case_grad_tensor(P, A):
    x = _t(P, [1.0, 1.0], False)
    (x * 3).backward(_t(P, [1.0, 2.0]))
    return [_g(x.grad)]


def case_multi_output(P, A):
    x = _t(P, [[1.0, 5.0], [3.0, 2.0]], False)
    vals, idx = P.topk(x, k=1, axis=1)
    vals.sum().backward()
    return [_g(x.grad), idx.stop_gradient, _g(idx)]


def case_integer_output(P, A):
    x = _t(P, [1.0, 3.0, 2.0], False)
    return [P.argmax(x).stop_gradient]


def case_retain_graph(P, A):
    x = _t(P, [2.0], False)
    y = x * x
    y.backward(retain_graph=True)
    y.backward()
    return [_g(x.grad)]


def case_pylayer(P, A):
    class Square(A.PyLayer):
        @staticmethod
        def forward(ctx, x, k):
            ctx.save_for_backward(x)
            return x * x * k

        @staticmethod
        def backward(ctx, grad):
            (x,) = ctx.saved_tensor
            return grad * 2.0 * x * 4.0

    x = _t(P, [2.0], False)
    y = Square.apply(x * 3, 4.0)       # 4 (3x)^2 -> d/dx = 72 x = 144
    y.backward()
    return [_g(y), _g(x.grad)]


def case_hooks(P, A):
    x = _t(P, [1.0, 2.0], False)
    seen = []
    h1 = x.register_hook(lambda g: seen.append(_g(g)))
    h2 = x.register_hook(lambda g: g * 2)
    (x * x + x * 3).sum().backward()
    g1 = _g(x.grad)
    removed = h2.remove()
    x.clear_grad()
    (x * x).sum().backward()
    h = x * 2
    h.register_hook(lambda g: g * 10)
    x2 = _t(P, [3.0], False)
    hh = x2 * 2
    hh.register_hook(lambda g: g * 10)
    (hh * hh).sum().backward()
    with pytest.raises(RuntimeError, match="stop_gradient"):
        _t(P, [1.0]).register_hook(lambda g: g)
    return [g1, removed, _g(x.grad), _g(x2.grad), len(seen), seen[0],
            h1.remove()]


def case_hook_in_grad(P, A):
    x = _t(P, [2.0], False)
    h = x * 4
    h.register_hook(lambda g: g * 0 + 1.0)
    (gx,) = P.grad((h * h).sum(), [x])
    return [_g(gx)]


def case_double_triple_grad(P, A):
    x = _t(P, 2.0, False)
    y = x * x * x
    (g,) = P.grad([y], [x], create_graph=True)
    (gg,) = P.grad([g], [x], create_graph=True)
    (ggg,) = P.grad([gg], [x])
    return [_g(g), _g(gg), _g(ggg)]


def case_create_graph_contracts(P, A):
    x, z = _t(P, 2.0, False), _t(P, 3.0, False)
    y = x * x
    with pytest.raises(RuntimeError, match="unused"):
        P.grad([y], [x, z], create_graph=True)
    gx, gz = P.grad([y], [x, z], create_graph=True, allow_unused=True)
    g1, g2 = P.grad([y], [x, x], create_graph=True)
    w = _t(P, 5.0, False)
    (gv,) = P.grad([y], [x], grad_outputs=[w * 2.0], create_graph=True)
    (gw,) = P.grad([gv], [w])
    return [_g(gx), gz is None, _g(g1), _g(g2), _g(gv), _g(gw)]


def case_gradient_penalty(P, A):
    """d(grad-penalty)/dθ reaches the parameters: one SGD step on a
    penalty built from input gradients, from the same weights."""
    w = _t(P, np.linspace(-1, 1, 6).reshape(3, 2), False)
    xb = _t(P, np.linspace(0, 1, 12).reshape(4, 3), False)
    (gx,) = P.grad([P.tanh(P.matmul(xb, w)).sum()], [xb], create_graph=True)
    loss = ((gx ** 2).sum(1).sqrt() - 1.0) ** 2
    loss.mean().backward()
    return [_g(gx), _g(w.grad)]


def case_functional(P, A):
    x = _t(P, [1.0, 2.0, 3.0])
    v = _t(P, [0.5, -1.0, 2.0])

    def f3(t):
        return (t ** 3.0).sum()

    out, tangent = A.jvp(f3, x, v)
    _, gr = A.vjp(f3, x)
    a, b = _t(P, [1.0, 2.0]), _t(P, [3.0, 4.0])
    _, gab = A.vjp(lambda p, q: (p * q).sum(), [a, b])
    w = np.array([[1., 2.], [3., 4.], [5., 6.]], np.float32)
    jac = A.jacobian(lambda t: _t(P, w) @ t, _t(P, [1.0, 1.0]))
    jb = A.jacobian(lambda t: t ** 2.0, _t(P, [[1., 2.], [3., 4.]]),
                    batch_axis=0)
    am = np.array([[2.0, 1.0], [1.0, 4.0]], np.float32)
    h = A.hessian(lambda t: 0.5 * (t @ (_t(P, am) @ t)), _t(P, [1., -1.]))
    J = A.Jacobian(f3, _t(P, [1.0, 2.0]))
    H = A.Hessian(f3, _t(P, [1.0, 2.0]))
    return [_g(out), _g(tangent), _g(gr), _g(gab[0]), _g(gab[1]), _g(jac),
            _g(jb), _g(h), _g(J.tensors), _g(J[1]), _g(H.tensors)]


CASES = [case_chain, case_accumulate, case_fan_in, case_stop_gradient,
         case_no_grad, case_grad_api, case_grad_tensor, case_multi_output,
         case_integer_output, case_retain_graph, case_pylayer, case_hooks,
         case_hook_in_grad, case_double_triple_grad,
         case_create_graph_contracts, case_gradient_penalty,
         case_functional]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_matches_jax(case):
    (jp, ja), (tp, ta) = PKGS
    want, got = case(jp, ja), case(tp, ta)
    assert len(want) == len(got)
    for k, (w, g) in enumerate(zip(want, got)):
        if isinstance(w, np.ndarray):
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64), rtol=TOL,
                                       atol=TOL, err_msg=f"{case} [{k}]")
        else:
            assert g == w, (case.__name__, k, g, w)


def test_second_backward_through_a_freed_graph_raises():
    """Departure: torch frees the graph at the first ``backward()``; the
    JAX tape, reset by it, makes a second one a no-op."""
    x = _t(tpaddle, [2.0], False)
    y = x * x
    y.backward()
    with pytest.raises(RuntimeError):
        y.backward()


def test_create_graph_runs_hooks():
    """Departure: the JAX package refuses ``create_graph=True`` over a
    hooked tensor; torch runs the hook inside the differentiable graph,
    and again in each later backward that passes through the hooked
    tensor."""
    x = _t(tpaddle, 2.0, False)
    h = x * 2.0
    h.register_hook(lambda g: g * 2)
    (g,) = tpaddle.grad([h * h], [x], create_graph=True)
    assert float(g) == 32.0          # 2 * (2h) * 2 with h = 4
    (gg,) = tpaddle.grad([g], [x])
    assert float(gg) == 32.0         # d(16 x)/dx, doubled again at h


def test_kernel_functions_refuse_double_backward():
    """The flash-attention and fused lm-head Functions have no double
    backward: a second-order gradient through them raises (their plain
    versions run here, on the CPU)."""
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    from paddle_tpu_torch.ops import lmce_kernel as lk
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.standard_normal((1, 8, 2, 16)),
                            dtype=torch.float32, requires_grad=True)
               for _ in range(3))
    out = fk.FlashAttnFunc.apply(q, k, v, True, None, None)
    (gq,) = torch.autograd.grad(out.sum(), q, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gq.sum(), q)
    h = torch.tensor(rng.standard_normal((4, 16)), dtype=torch.float32,
                     requires_grad=True)
    w = torch.tensor(rng.standard_normal((32, 16)), dtype=torch.float32)
    loss = lk.FusedLinearCrossEntropy.apply(h, w, torch.arange(4))
    (gh,) = torch.autograd.grad(loss.sum(), h, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gh.sum(), h)


def test_sparse_grad_accumulates_until_clear_grad():
    """A ``sparse=True`` lookup's gradient is a SelectedRows that keeps
    every backward's rows until ``clear_grad``, as the JAX tape's."""
    from paddle_tpu_torch.framework.selected_rows import SelectedRows
    emb = tpaddle.nn.Embedding(10, 3, sparse=True)
    w = tpaddle.Tensor._from(emb.weight)
    for ids in ([1, 2], [2, 5]):
        emb(tpaddle.to_tensor(np.array(ids))).sum().backward()
    g = w.grad
    assert isinstance(g, SelectedRows)
    dense = np.asarray(g.to_dense().numpy() if hasattr(g.to_dense(), "numpy")
                       else g.to_dense())
    np.testing.assert_array_equal(dense[:, 0], [0, 1, 2, 0, 0, 1, 0, 0, 0, 0])
    w.clear_grad()
    assert w.grad is None
