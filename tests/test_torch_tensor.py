"""The port's Paddle ``Tensor`` against the JAX package's
(``tests/test_tensor.py``'s cases in both packages): meta, the methods
and dunders, places and dtypes, ``to_tensor``'s defaults, the in-place
semantics (a write never changes what a recorded op read), the boundary
rules of ``nn.Layer`` / ``nn.functional`` / the optimizers, and the
refusal to put a tensor on a missing card."""

import copy

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.ops import _METHOD_OPS as JAX_METHOD_OPS

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.tensor import Tensor
from torch_parity_helpers import torch_one_thread  # noqa: F401

PKGS = [jpaddle, tpaddle]


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tpaddle.get_device()
    tpaddle.set_device("cpu")
    yield
    tpaddle.set_device(prev)


def both(fn):
    """``fn(P)`` in both packages, as numpy (lists of them kept)."""
    out = []
    for P in PKGS:
        r = fn(P)
        out.append([np.asarray(v.numpy()) if hasattr(v, "numpy") else v
                    for v in r] if isinstance(r, (list, tuple))
                   else (np.asarray(r.numpy()) if hasattr(r, "numpy")
                         else r))
    return out


@pytest.mark.parametrize("data,want", [
    ([1.0, 2.0], "float32"), ([1, 2], "int64"), (3, "int64"),
    (2.5, "float32"), ([True, False], "bool"),
    (np.zeros((2, 3), np.float64), "float64"),
    (np.zeros(2, np.int32), "int32"), (np.float32(1.0), "float32")])
def test_to_tensor_dtypes(data, want):
    for P in PKGS:
        t = P.to_tensor(data)
        assert t.dtype == getattr(P, want) and t.dtype == want, (P, t.dtype)
        assert t.stop_gradient


def test_meta_matches():
    for P in PKGS:
        t = P.zeros([2, 3, 4])
        assert t.shape == [2, 3, 4] and isinstance(t.shape, list)
        assert t.ndim == 3 and t.size == 24 and len(t) == 2
        assert t.dtype == P.float32 and t.is_leaf
        assert t.T.shape == [4, 3, 2] and t.mT.shape == [2, 4, 3]
    assert tpaddle.zeros([2]).place == tpaddle.CPUPlace()
    assert str(tpaddle.to_tensor([1]).place) == "Place(cpu)"


def test_arithmetic_and_comparison_dunders_match():
    def f(P):
        a, b = P.to_tensor([1.0, 2.0]), P.to_tensor([3.0, 4.0])
        i = P.to_tensor([7, -7])
        return [a + b, a - b, a * b, b / a, a ** 2, 2.0 + a, 2.0 - a,
                2.0 * a, 1.0 / a, 2.0 ** a, -a, abs(P.to_tensor([-1.0])),
                a @ b, i // 2, i % 3, a > 1.5, a == 2.0, a != 2.0,
                a <= 1.0, (a > 1) & (b > 3), (a > 1) | (b > 3),
                (a > 1) ^ (b > 3), ~(a > 1), np.float32(2.0) * a]
    jres, tres = both(f)
    for k, (j, t) in enumerate(zip(jres, tres)):
        assert j.dtype == t.dtype, (k, j.dtype, t.dtype)
        np.testing.assert_allclose(t, j, rtol=1e-6, err_msg=str(k))


def test_indexing_and_setitem_match():
    def f(P):
        t = P.to_tensor(np.arange(12).reshape(3, 4).astype(np.float32))
        out = [t[0], t[1, 2], t[:, 1], t[0:2, 0:2], t[P.to_tensor([0, 2])],
               t[-1, ::2], t[t > 5]]
        z = P.zeros([3, 3])
        z[1, 1] = 5.0
        z[0] = P.ones([3])
        z[P.to_tensor([2])] = 7.0
        return out + [z, [float(v) for v in P.to_tensor([1., 2.])]]
    jres, tres = both(f)
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t, j)


def test_methods_match_and_every_jax_method_is_attached():
    for name in JAX_METHOD_OPS:
        assert callable(getattr(Tensor, name, None)), name
    # every public attribute of the JAX Tensor but the two that
    # paddle.sparse attaches (the sparse module is a later item)
    missing = [n for n in dir(jpaddle.Tensor) if not n.startswith("_")
               and not hasattr(Tensor, n)]
    assert missing == ["to_sparse_coo", "to_sparse_csr"], missing

    def f(P):
        t = P.to_tensor(np.array([[1.0, -2.0, 3.0], [0.5, 4.0, -1.0]],
                                 np.float32))
        return [t.sum(), t.sum(axis=1), t.mean(0), t.max(), t.argmax(1),
                t.reshape([3, 2]), t.transpose([1, 0]), t.flatten(),
                t.unsqueeze(0), t.expm1(), t.amax(), t.abs().sqrt(),
                t.clip(-1, 1), t.astype("int32"), t.cast(P.float64),
                t.tile([2, 1]), t.flip(0), t.cumsum(1), t.t(),
                t.matmul(t.T), t.topk(1)[0], t.sort(1), t.kron(t),
                t.outer(t), t.where(t, t * 0)]
    jres, tres = both(f)
    for k, (j, t) in enumerate(zip(jres, tres)):
        assert j.dtype == t.dtype, (k, j.dtype, t.dtype)
        np.testing.assert_allclose(t, j, rtol=1e-6, err_msg=str(k))


def test_item_conversion_numpy_and_bf16():
    for P in PKGS:
        t = P.to_tensor(3.5)
        assert t.item() == 3.5 and float(t) == 3.5
        assert P.to_tensor(2).item() == 2 and int(P.to_tensor(2)) == 2
        assert P.to_tensor([1, 2]).tolist() == [1, 2]
        arr = np.random.rand(4, 5).astype(np.float32)
        a = P.to_tensor(arr).numpy()
        np.testing.assert_array_equal(a, arr)
        a[0, 0] = -1.0                      # a writable copy
        assert arr[0, 0] != -1.0
    # bf16: the JAX package gives ml_dtypes.bfloat16, the port its exact
    # fp32 widening (the card's machine has no ml_dtypes)
    x = np.array([1.0, 1.00390625, -3.5], np.float32)
    jb = jpaddle.to_tensor(x).astype("bfloat16").numpy()
    tb = tpaddle.to_tensor(x).astype("bfloat16").numpy()
    assert tb.dtype == np.float32
    np.testing.assert_array_equal(tb, jb.astype(np.float32))


def test_detach_clone_and_casts():
    for P in PKGS:
        t = P.to_tensor([1.0], stop_gradient=False)
        assert t.detach().stop_gradient
        assert not t.clone().stop_gradient
        assert t.astype("int32").dtype == P.int32
        assert P.cast(t, "int64").dtype == P.int64
        d = copy.deepcopy(t)
        assert not d.stop_gradient and d.numpy()[0] == 1.0


@pytest.mark.parametrize("op", ["add_", "scale_", "zero_", "set_value",
                                "fill_", "setitem", "clip_"])
def test_inplace_ops_match(op):
    def f(P):
        t = P.to_tensor([1.0, 2.0])
        if op == "add_":
            t.add_(P.to_tensor([1.0, 1.0]))
        elif op == "scale_":
            t.scale_(2.0)
        elif op == "zero_":
            t.zero_()
        elif op == "set_value":
            t.set_value(np.array([5.0, 6.0], np.float32))
        elif op == "fill_":
            t.fill_(3.0)
        elif op == "setitem":
            t[0] = 9.0
        else:
            t.clip_(1.5, 1.8)
        return t
    j, t = both(f)
    np.testing.assert_array_equal(t, j)


def test_write_to_a_tensor_a_recorded_op_saved():
    """A write after an op read a tensor: the op's gradient uses the value
    it read (the JAX tape's snapshot), and torch's version counter never
    sees the write; for a leaf that requires grad, the gradients of ops
    before and after the write both land in its grad."""
    res = []
    for P in PKGS:
        x = P.to_tensor([2.0], stop_gradient=False)
        c = P.to_tensor([3.0])                # saved by the multiply
        y = x * x * c
        c.set_value(np.array([100.0], np.float32))
        x.set_value(np.array([100.0], np.float32))
        y.backward()
        g1 = x.grad.numpy().copy()
        z = x * 2.0                          # after the write
        z.backward()
        res.append((g1, x.grad.numpy().copy(), c.numpy().copy()))
    (jg1, jg2, jc), (tg1, tg2, tc) = res
    np.testing.assert_array_equal(tg1, [12.0])
    np.testing.assert_array_equal(tg1, jg1)
    np.testing.assert_array_equal(tg2, jg2)
    np.testing.assert_array_equal(tc, jc)


def test_inplace_on_a_produced_tensor_is_differentiated():
    """A departure, by design: ``h.scale_(3)`` on a tensor an op produced
    is an op in the port, so d(sum(h))/dx is 2 * 3; the JAX tape passes
    the gradient through the write unchanged (2)."""
    x = tpaddle.to_tensor([1.0], stop_gradient=False)
    h = x * 2.0
    h.scale_(3.0)
    h.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [6.0])
    jx = jpaddle.to_tensor([1.0], stop_gradient=False)
    jh = jx * 2.0
    jh.scale_(3.0)
    jh.sum().backward()
    np.testing.assert_array_equal(jx.grad.numpy(), [2.0])


def test_places_dtypes_and_devices():
    assert tpaddle.CPUPlace() == tpaddle.CPUPlace()
    assert tpaddle.CUDAPlace(0) != tpaddle.CPUPlace()
    assert tpaddle.CUDAPlace(0) == tpaddle.TPUPlace(0)
    assert tpaddle.get_device() == "cpu"
    for name in ("float32", "bfloat16", "int64", "bool", "complex64"):
        d = getattr(tpaddle, name if name != "bool" else "bool")
        assert d == name and d == tpaddle.framework.dtype.convert_dtype(
            getattr(torch, name))
    assert tpaddle.finfo("bfloat16").eps == jpaddle.finfo("bfloat16").eps
    assert tpaddle.iinfo("int32").max == jpaddle.iinfo("int32").max
    assert tpaddle.get_default_dtype() == "float32"
    t = tpaddle.to_tensor([1.0], place=tpaddle.CPUPlace())
    assert t.place.is_cpu_place()
    assert t.to("float64").dtype == "float64"
    assert tpaddle.is_tensor(t) and tpaddle.is_tensor(torch.zeros(1))
    assert not tpaddle.is_tensor(np.zeros(1))


def test_default_place_is_the_card_and_refuses_without_one():
    tpaddle.set_device("gpu")
    try:
        assert tpaddle.get_device() == "gpu:0"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="is_available"):
                tpaddle.to_tensor([1.0])
            with pytest.raises(RuntimeError, match="is_available"):
                tpaddle.zeros([2])
        t = tpaddle.to_tensor([1.0], place=tpaddle.CPUPlace())
        assert t.place.is_cpu_place()
    finally:
        tpaddle.set_device("cpu")


def test_layer_and_functional_boundary():
    """Tensors in, Tensors out; torch tensors in, torch tensors out; the
    optimizers take a layer's torch parameters and Tensor leaves."""
    lin = tpaddle.nn.Linear(3, 2)        # on the current place, the CPU
    assert lin.weight.device.type == "cpu"
    x = tpaddle.to_tensor(np.ones((4, 3), np.float32))
    out = lin(x)
    assert isinstance(out, Tensor) and out.shape == [4, 2]
    assert not out.stop_gradient
    raw = lin(torch.ones(4, 3))
    assert type(raw) is torch.Tensor
    np.testing.assert_array_equal(out.numpy(), raw.detach().numpy())
    F = tpaddle.nn.functional
    assert isinstance(F.relu(x), Tensor)
    assert type(F.relu(torch.ones(2))) is torch.Tensor
    # a layer's parameter: torch's, not a Paddle Tensor, yet is_tensor
    assert not isinstance(lin.weight, Tensor) and tpaddle.is_tensor(lin.weight)
    w = tpaddle.Parameter(np.ones((3, 2), np.float32), place="cpu")
    assert isinstance(w, Tensor) and not w.stop_gradient
    opt = tpaddle.optimizer.SGD(0.5, parameters=[w])
    (tpaddle.matmul(x, w)).sum().backward()
    opt.step()
    np.testing.assert_allclose(w.numpy(), np.ones((3, 2)) - 0.5 * 4.0)
    opt.clear_grad()
    assert w.grad is None


@pytest.mark.parametrize("opt_name", ["SGD", "AdamW"])
def test_optimizer_follows_a_leaf_written_in_place(opt_name):
    """A Parameter handed to an optimizer, then ``set_value`` (and a
    ``fill_`` between steps): ``step`` moves the written leaf and
    ``clear_grad`` clears its gradient, as in the JAX package, whose
    optimizer holds the Tensor handle."""
    rng = np.random.default_rng(3)
    w0, w1 = (rng.standard_normal((3, 2)).astype(np.float32)
              for _ in range(2))
    xs = rng.standard_normal((2, 4, 3)).astype(np.float32)
    res = []
    for P in PKGS:
        w = P.Parameter(w0) if P is jpaddle else \
            P.Parameter(w0, place="cpu")
        opt = getattr(P.optimizer, opt_name)(0.1, parameters=[w])
        w.set_value(w1)
        seen = []
        for i, x in enumerate(xs):
            (P.matmul(P.to_tensor(x), w) ** 2).sum().backward()
            seen.append(w.grad.numpy().copy())
            opt.step()
            opt.clear_grad()
            assert w.grad is None
            if i == 0:
                w.fill_(0.25)
        res.append((w.numpy().copy(), seen))
    (jw, jseen), (tw, tseen) = res
    for jg, tg in zip(jseen, tseen):
        np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=1e-6)
    assert not np.allclose(tw, 0.25)


def test_array_ops_and_tensor_array():
    for P in PKGS:
        arr = P.create_array("float32")
        P.array_write(P.to_tensor([1.0]), 0, arr)
        P.array_write(P.to_tensor([2.0]), 1, arr)
        assert int(P.array_length(arr).numpy()) == 2
        np.testing.assert_array_equal(P.array_read(arr, 1).numpy(), [2.0])
        np.testing.assert_array_equal(arr.stack().numpy(), [[1.0], [2.0]])
        with pytest.raises(IndexError):
            P.array_write(P.to_tensor([3.0]), 5, arr)


def test_random_creation_shapes_dtypes_and_seed():
    """The random ops draw from the port's generator (the packages'
    streams differ by design): shapes, dtypes and ranges as the JAX
    package's, and the same draws after the same ``seed``."""
    def f(P):
        x = P.to_tensor([0.2, 0.8])
        return [P.randn([2, 3]), P.rand([2]), P.uniform([4], min=2.0,
                                                        max=3.0),
                P.randint(0, 5, [4]), P.randperm(5), P.normal(0., 1., [2]),
                P.standard_normal([3]), P.bernoulli(x), P.rand_like(x),
                P.randn_like(x), P.multinomial(x, 1)]
    for j, t in zip(f(jpaddle), f(tpaddle)):
        assert t.shape == j.shape and t.dtype.name == j.dtype.name, (t, j)
    u = tpaddle.uniform([64], min=2.0, max=3.0).numpy()
    assert (u >= 2.0).all() and (u < 3.0).all()
    assert sorted(tpaddle.randperm(6).numpy().tolist()) == list(range(6))
    r = tpaddle.randint_like(tpaddle.to_tensor([0.2, 0.8]), 0, 3)
    assert r.dtype == tpaddle.float32 and set(r.numpy()) <= {0.0, 1.0, 2.0}
    tpaddle.seed(1)
    a = tpaddle.randn([3]).numpy()
    tpaddle.seed(1)
    np.testing.assert_array_equal(tpaddle.randn([3]).numpy(), a)


def test_check_nan_inf_flag_and_the_amp_hook():
    """``FLAGS_check_nan_inf`` makes an op that gives NaN raise, as the
    JAX package's flag does; under ``auto_cast`` O1 bf16 a white-listed
    op (``matmul``) computes in bf16, a black-listed one (``exp``) in
    fp32, in both packages."""
    for P in PKGS:
        P.set_flags({"FLAGS_check_nan_inf": True})
        try:
            with pytest.raises(FloatingPointError, match="log"):
                P.log(P.to_tensor([-1.0]))
            P.log(P.to_tensor([1.0]))
        finally:
            P.set_flags({"FLAGS_check_nan_inf": False})
        assert P.get_flags("FLAGS_check_nan_inf") == {
            "FLAGS_check_nan_inf": False}
        x = P.to_tensor(np.ones((2, 2), np.float32))
        with P.amp.auto_cast(level="O1", dtype="bfloat16"):
            assert P.matmul(x, x).dtype == P.bfloat16
            assert P.exp(x.astype("bfloat16")).dtype == P.float32
