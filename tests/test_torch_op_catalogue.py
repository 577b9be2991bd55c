"""The port's op catalogue against the JAX package, spec by spec.

``paddle_tpu/ops/op_spec.py::build_specs()`` describes each op once:
the Paddle-level callable, seeded sample inputs, its dtypes and its
tolerances; ``tests/test_op_suite.py`` holds the JAX package to numpy
with it.  Here every spec runs through both packages on the same numpy
inputs: a spec's ``fn`` is a JAX-package op (the port's op of the same
name stands in for it) or a lambda over ``P = paddle_tpu``, which is
rebuilt with its closure cell pointed at ``paddle_tpu_torch``.

- fp32 forward: the port's output against the JAX output at the spec's
  ``fw_rtol`` / ``fw_atol``, the same shape and the same dtype name;
- bf16 forward where the spec lists bf16, at the spec's bf16 bounds
  (both packages round to bf16, in other orders);
- where ``check_grad`` is set: the gradient of ``sum(op(x)[0])`` by
  ``backward()``, the port's against the JAX tape's, at the spec's
  gradient bounds.

The audit lists every op of the JAX package's six op modules
(creation, math, manipulation, logic, linalg, array_ops) that the port's
``OP_TABLE`` lacks; none of them may have a spec.
"""

import sys
import types

import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu.ops import _primitive as jprimitive
from paddle_tpu.ops import op_spec

import paddle_tpu_torch as tpaddle
from torch_parity_helpers import torch_one_thread  # noqa: F401

SPECS = op_spec.build_specs()
JAX_MODULES = ("creation", "math", "manipulation", "logic", "linalg",
               "array_ops")


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    """The port's tensors go to the CPU while this module runs."""
    prev = tpaddle.get_device()
    tpaddle.set_device("cpu")
    yield
    tpaddle.set_device(prev)


def port_fn(fn):
    """The spec's callable for the port."""
    if fn.__name__ != "<lambda>":
        return getattr(tpaddle, fn.__name__)
    cells = tuple(
        types.CellType(tpaddle if c.cell_contents is jpaddle
                       else c.cell_contents)
        for c in (fn.__closure__ or ()))
    return types.FunctionType(fn.__code__, fn.__globals__, fn.__name__,
                              fn.__defaults__, cells or None)


def _inputs(spec, seed=0):
    rng = np.random.RandomState(seed)
    return [g(rng) for g in spec.inputs]


def _outs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _dtype_name(t):
    return str(t.dtype).replace("paddle.", "")


def _compare(spec, dtype, jouts, touts):
    assert len(touts) == len(jouts), spec.name
    for j, t in zip(jouts, touts):
        assert _dtype_name(t) == _dtype_name(j), \
            f"{spec.name}[{dtype}]: dtype {t.dtype} vs JAX {j.dtype}"
        got, want = _np(t), _np(j)
        assert got.shape == want.shape, \
            f"{spec.name}[{dtype}]: shape {got.shape} vs JAX {want.shape}"
        if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=spec.name)
        else:
            np.testing.assert_allclose(
                got.astype(np.float64) if not np.iscomplexobj(got) else got,
                want.astype(np.float64) if not np.iscomplexobj(want)
                else want, rtol=spec.fw_rtol[dtype],
                atol=spec.fw_atol[dtype],
                err_msg=f"{spec.name} forward [{dtype}]")


def check_forward(spec, dtype):
    raw = _inputs(spec)
    jout = spec.fn(*[jpaddle.to_tensor(op_spec._cast_in(a, dtype))
                     for a in raw], **spec.kwargs)
    tout = port_fn(spec.fn)(*[tpaddle.to_tensor(op_spec._cast_in(a, dtype))
                              for a in raw], **spec.kwargs)
    for t in _outs(tout):
        assert isinstance(t, tpaddle.Tensor), (spec.name, type(t))
    _compare(spec, dtype, _outs(jout), _outs(tout))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_forward_fp32(spec):
    check_forward(spec, "float32")


@pytest.mark.parametrize("spec", [s for s in SPECS if "bfloat16" in s.dtypes],
                         ids=lambda s: s.name)
def test_forward_bf16(spec):
    check_forward(spec, "bfloat16")


def _grads(pkg, fn, raw, grad_idx, kwargs):
    ts = []
    for i, a in enumerate(raw):
        v = a.astype(np.float32) if np.issubdtype(a.dtype, np.floating) \
            else a
        ts.append(pkg.to_tensor(v, stop_gradient=i not in grad_idx))
    out = fn(*ts, **kwargs)
    out0 = out[0] if isinstance(out, (tuple, list)) else out
    out0.sum().backward()
    return [_np(ts[i].grad) for i in grad_idx]


@pytest.mark.parametrize("spec", [s for s in SPECS if s.check_grad],
                         ids=lambda s: s.name)
def test_grad(spec):
    raw = _inputs(spec)
    grad_idx = spec.grad_inputs
    if grad_idx is None:
        grad_idx = [i for i, a in enumerate(raw)
                    if np.issubdtype(a.dtype, np.floating)]
    want = _grads(jpaddle, spec.fn, raw, grad_idx, spec.kwargs)
    got = _grads(tpaddle, port_fn(spec.fn), raw, grad_idx, spec.kwargs)
    for i, g, w in zip(grad_idx, got, want):
        assert g.shape == w.shape, (spec.name, i)
        np.testing.assert_allclose(g, w, rtol=spec.grad_rtol,
                                   atol=spec.grad_atol,
                                   err_msg=f"{spec.name} grad of input {i}")


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_auto_cast_o2_dtypes(spec):
    """Under ``auto_cast`` O2 bf16 the fp32 inputs are cast by each op's
    rule once: every spec gives the JAX package's output dtypes and
    shapes, or raises where the JAX op raises (complex and some linalg
    ops have no bf16 form in either package)."""
    raw = _inputs(spec)
    res = []
    for P, fn in ((jpaddle, spec.fn), (tpaddle, port_fn(spec.fn))):
        try:
            with P.amp.auto_cast(level="O2", dtype="bfloat16"):
                out = fn(*[P.to_tensor(op_spec._cast_in(a, "float32"))
                           for a in raw], **spec.kwargs)
        except Exception:               # noqa: BLE001 - compared below
            res.append(None)
            continue
        res.append([(_dtype_name(t), tuple(t.shape)) for t in _outs(out)])
    assert res[1] == res[0], (spec.name, res)


def missing_ops():
    """The JAX package's ops of its six op modules that the port's
    OP_TABLE lacks, by module."""
    out = {}
    for name, op in jprimitive.OP_TABLE.items():
        mod = getattr(op.raw, "__module__", "").rsplit(".", 1)[-1]
        if mod in JAX_MODULES and name not in tpaddle.OP_TABLE:
            out.setdefault(mod, []).append(name)
    return out


def test_audit_no_specced_op_missing():
    missing = missing_ops()
    count = sum(len(v) for v in missing.values())
    assert count == 0, missing
    print(f"\n[audit] JAX OP_TABLE ops of {JAX_MODULES} missing in the "
          f"port: {count} {missing}", file=sys.stderr)
    names = {getattr(s.fn, "__name__", s.name) for s in SPECS} | \
        {s.covers for s in SPECS if s.covers}
    specced_missing = sorted(n for v in missing.values() for n in v
                             if n in names)
    assert not specced_missing, specced_missing
    for s in SPECS:
        port_fn(s.fn)            # every spec resolves against the port


def test_every_public_function_of_the_op_modules_is_exported():
    """Beyond OP_TABLE: the JAX modules' other public functions
    (``zeros``, ``arange``, ``concat``, ``unique``, ``einsum``, the
    TensorArray functions, ...) are top-level functions of the port."""
    missing = []
    for mod in JAX_MODULES:
        jmod = sys.modules[f"paddle_tpu.ops.{mod}"]
        for name, v in vars(jmod).items():
            if name.startswith("_") or not callable(v) or \
                    getattr(v, "__module__", None) != jmod.__name__:
                continue
            if not callable(getattr(tpaddle, name, None)):
                missing.append(f"{mod}.{name}")
    assert not missing, missing


# ---------------------------------------------------------------------------
# ops without a spec, where the two packages are likeliest to part: each
# case runs one function of the package P on the same numpy inputs in
# both packages; "exact" compares bit for bit (integers, indices, shapes
# and dtypes included), "close" within 1e-5 (fp32 sums in other orders).
# Decompositions defined up to sign or order are compared by what they
# reconstruct; scatter with overwrite on distinct indices only (with a
# repeated index either package keeps one update of its choice).
# ---------------------------------------------------------------------------
def _r(seed=0, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _spd(n=4, seed=1):
    a = np.random.RandomState(seed).randn(n, n)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


_INTS = np.array([[-7, 5, 3], [7, -5, -3]], np.int64)
_TIES = np.array([[3., 1., 3., 2., 1.], [0., 0., 5., 5., 5.]], np.float32)

EXTRA = [
    ("floor_divide_int", "exact",
     lambda P: [P.floor_divide(P.to_tensor(_INTS), P.to_tensor(
         np.array([2, -2, 2], np.int64)))]),
    ("remainder_int", "exact",
     lambda P: [P.remainder(P.to_tensor(_INTS), P.to_tensor(
         np.array([2, -2, 2], np.int64))),
         P.mod(P.to_tensor(_INTS), 3)]),
    ("arange_dtypes", "exact",
     lambda P: [P.arange(5), P.arange(0.0, 1.0, 0.25), P.arange(2, 9, 3),
                P.full([2], 3), P.full([2], 1.5), P.to_tensor(7),
                P.linspace(0, 1, 5), P.eye(3, 2)]),
    ("full_reductions_0d", "close",
     lambda P: [P.sum(P.to_tensor(_r(0, 3, 4))),
                P.mean(P.to_tensor(_r(0, 3, 4))),
                P.max(P.to_tensor(_r(0, 3, 4))),
                P.sum(P.to_tensor(_r(0, 3, 4)), axis=[0, 1], keepdim=True),
                P.prod(P.to_tensor(_r(0, 2, 3)), axis=[0, 1])]),
    ("argmax_argmin", "exact",
     lambda P: [P.argmax(P.to_tensor(_TIES)),
                P.argmax(P.to_tensor(_TIES), axis=1, keepdim=True),
                P.argmin(P.to_tensor(_TIES), axis=0)]),
    ("split_minus_one", "exact",
     lambda P: P.split(P.to_tensor(_r(1, 2, 7)), [2, -1, 3], axis=1)
     + P.split(P.to_tensor(_r(1, 6, 2)), 3)),
    ("chunk_unbind_tensor_split", "exact",
     lambda P: P.chunk(P.to_tensor(_r(2, 4, 2)), 2) + P.unbind(
         P.to_tensor(_r(2, 3, 2)), 1) + P.tensor_split(
         P.to_tensor(_r(2, 7)), 3) + P.hsplit(P.to_tensor(_r(2, 2, 4)), 2)),
    ("concat_stack", "exact",
     lambda P: [P.concat([P.to_tensor(_r(3, 2, 2)),
                          P.to_tensor(_r(4, 1, 2))], axis=0),
                P.stack([P.to_tensor(_r(3, 2)), P.to_tensor(_r(4, 2))], 1),
                P.hstack([P.to_tensor(_r(3, 2)), P.to_tensor(_r(4, 3))])]),
    ("unique_sorted", "exact",
     lambda P: list(P.unique(P.to_tensor(np.array([3, 1, 2, 3, 1, 7])),
                             return_index=True, return_inverse=True,
                             return_counts=True))
     + [P.unique(P.to_tensor(np.array([[2., 1.], [2., 1.], [0., 5.]],
                                      np.float32)), axis=0),
        P.unique_consecutive(P.to_tensor(np.array([1, 1, 2, 2, 1])))]),
    ("nonzero_masked_select", "exact",
     lambda P: [P.nonzero(P.to_tensor(_TIES > 2)),
                P.masked_select(P.to_tensor(_TIES),
                                P.to_tensor(_TIES > 2))]
     + P.nonzero(P.to_tensor(_TIES > 2), as_tuple=True)),
    ("sort_argsort_stable", "exact",
     lambda P: [P.sort(P.to_tensor(_TIES), axis=1),
                P.sort(P.to_tensor(_TIES), axis=1, descending=True),
                P.argsort(P.to_tensor(_TIES), axis=1),
                P.argsort(P.to_tensor(_TIES), axis=1, descending=True)]),
    ("topk_kthvalue_mode", "exact",
     lambda P: list(P.topk(P.to_tensor(_r(5, 3, 6)), k=2, axis=1))
     + list(P.topk(P.to_tensor(_r(5, 3, 6)), k=2, axis=0, largest=False))
     + list(P.kthvalue(P.to_tensor(_r(5, 3, 6)), 2, axis=1))
     + list(P.mode(P.to_tensor(_TIES)))),
    ("searchsorted_bucketize_histogram_bincount", "exact",
     lambda P: [P.searchsorted(P.to_tensor(np.array([1., 3., 5., 7.],
                                                    np.float32)),
                               P.to_tensor(np.array([0.5, 3., 8.],
                                                    np.float32))),
                P.searchsorted(P.to_tensor(np.array([1., 3., 5.],
                                                    np.float32)),
                               P.to_tensor(np.array([3.], np.float32)),
                               right=True),
                P.bucketize(P.to_tensor(np.array([0.5, 3., 8.],
                                                 np.float32)),
                            P.to_tensor(np.array([1., 3., 5., 7.],
                                                 np.float32))),
                P.histogram(P.to_tensor(np.array([1., 2., 2., 3.],
                                                 np.float32)),
                            bins=3, min=1, max=3),
                P.bincount(P.to_tensor(np.array([0, 1, 1, 4])))]),
    ("cumulative", "close",
     lambda P: [P.cumsum(P.to_tensor(_r(6, 2, 3))),
                P.cumsum(P.to_tensor(_r(6, 2, 3)), axis=1),
                P.cumprod(P.to_tensor(_r(6, 2, 3)), dim=0),
                P.cummax(P.to_tensor(_r(6, 2, 3)), axis=1),
                P.cummin(P.to_tensor(_r(6, 2, 3)), axis=1)]),
    ("scatter_distinct", "exact",
     lambda P: [P.scatter(P.to_tensor(_r(7, 4, 2)),
                          P.to_tensor(np.array([2, 0])),
                          P.to_tensor(_r(8, 2, 2))),
                P.scatter(P.to_tensor(_r(7, 4, 2)),
                          P.to_tensor(np.array([1, 1])),
                          P.to_tensor(_r(8, 2, 2)), overwrite=False),
                P.scatter_nd_add(P.to_tensor(_r(7, 3, 2)),
                                 P.to_tensor(np.array([[1], [1]])),
                                 P.to_tensor(_r(8, 2, 2))),
                P.scatter_nd(P.to_tensor(np.array([[1], [2]])),
                             P.to_tensor(_r(8, 2, 2)), [4, 2])]),
    ("gather_put_index", "exact",
     lambda P: [P.gather_nd(P.to_tensor(_r(9, 3, 4)),
                            P.to_tensor(np.array([[0, 1], [2, 3]]))),
                P.put_along_axis(P.to_tensor(_r(9, 3, 4)),
                                 P.to_tensor(np.array([[0], [2], [1]])),
                                 9.0, 1),
                P.put_along_axis(P.to_tensor(_r(9, 3, 4)),
                                 P.to_tensor(np.array([[0], [2], [1]])),
                                 2.0, 1, reduce="add"),
                P.index_add(P.to_tensor(_r(9, 3, 4)),
                            P.to_tensor(np.array([0, 2])), 0,
                            P.to_tensor(_r(10, 2, 4))),
                P.index_put(P.to_tensor(_r(9, 3, 4)), (np.array([0, 2]),),
                            P.to_tensor(_r(10, 4))),
                P.index_sample(P.to_tensor(_r(9, 3, 4)),
                               P.to_tensor(np.array([[0, 3], [1, 1],
                                                     [2, 0]]))),
                P.masked_scatter(P.to_tensor(_r(9, 2, 3)),
                                 P.to_tensor(_r(9, 2, 3) > 0),
                                 P.to_tensor(_r(11, 6)))]),
    ("shape_ops", "exact",
     lambda P: [P.expand(P.to_tensor(_r(1, 3, 1)), [2, -1, 4]),
                P.squeeze(P.to_tensor(_r(1, 1, 3, 1)), axis=[0, 1]),
                P.unsqueeze(P.to_tensor(_r(1, 3)), [0, 2]),
                P.moveaxis(P.to_tensor(_r(1, 2, 3, 4)), 0, 2),
                P.repeat_interleave(P.to_tensor(_r(1, 2, 2)), 2, axis=1),
                P.strided_slice(P.to_tensor(_r(1, 6, 4)), [0, 1], [1, 0],
                                [5, 4], [2, 3]),
                P.slice(P.to_tensor(_r(1, 6, 4)), [0], [1], [3]),
                P.crop(P.to_tensor(_r(1, 6, 4)), [2, 2], [1, 1]),
                P.rot90(P.to_tensor(_r(1, 2, 3))),
                P.where(P.to_tensor(_r(1, 2, 3) > 0), P.to_tensor(
                    _r(2, 2, 3)), 0.5),
                P.tril_indices(4, 3, 1), P.triu_indices(3, 4, -1),
                P.block_diag([P.to_tensor(_r(1, 2, 2)),
                              P.to_tensor(_r(2, 1, 3))])]),
    ("getitem_setitem", "exact",
     lambda P: _index_case(P)),
    ("norms", "close",
     lambda P: [P.norm(P.to_tensor(_r(12, 3, 4)), p=p, axis=ax)
                for p, ax in ((2, None), ("fro", [0, 1]), (1, 1),
                              (float("inf"), 0), (float("-inf"), None),
                              (0, 1), (3, None))]
     + [P.norm(P.to_tensor(_r(12, 3, 4)), p="nuc"),
        P.linalg.vector_norm(P.to_tensor(_r(12, 3, 4)), p=3, axis=0),
        P.linalg.matrix_norm(P.to_tensor(_r(12, 3, 4)), p=1),
        P.dist(P.to_tensor(_r(12, 3)), P.to_tensor(_r(13, 3)),
               p=float("inf"))]),
    ("linalg_solvers", "close",
     lambda P: [P.linalg.solve(P.to_tensor(_spd()), P.to_tensor(_r(3, 4, 2))),
                P.linalg.cholesky(P.to_tensor(_spd()), upper=True),
                P.linalg.cholesky_solve(
                    P.to_tensor(_r(3, 4, 2)),
                    P.linalg.cholesky(P.to_tensor(_spd()))),
                P.linalg.triangular_solve(
                    P.linalg.cholesky(P.to_tensor(_spd()), upper=True),
                    P.to_tensor(_r(3, 4, 2)), upper=True),
                P.linalg.triangular_solve(
                    P.linalg.cholesky(P.to_tensor(_spd())),
                    P.to_tensor(_r(3, 4, 2)), upper=False,
                    transpose=True),
                P.linalg.pinv(P.to_tensor(_r(3, 4, 3))),
                P.linalg.slogdet(P.to_tensor(_spd())),
                P.linalg.matrix_rank(P.to_tensor(_r(3, 4, 3) @ _r(4, 3, 5))),
                P.linalg.eigvalsh(P.to_tensor(_spd())),
                P.linalg.cond(P.to_tensor(_spd())),
                P.linalg.matrix_exp(P.to_tensor(_r(1, 3, 3) * 0.1)),
                P.linalg.cov(P.to_tensor(_r(4, 3, 6))),
                P.linalg.corrcoef(P.to_tensor(_r(4, 3, 6))),
                P.einsum("ij,jk->ik", P.to_tensor(_r(1, 2, 3)),
                         P.to_tensor(_r(2, 3, 4)))]),
    ("lstsq", "close",
     lambda P: list(P.linalg.lstsq(P.to_tensor(_r(15, 5, 3)),
                                   P.to_tensor(_r(16, 5, 2))))),
    ("decompositions_by_reconstruction", "close",
     lambda P: _reconstructions(P)),
]


def _index_case(P):
    t = P.to_tensor(np.arange(24, dtype=np.float32).reshape(2, 3, 4))
    out = [t[1], t[:, 1], t[0, 1:, ::2], t[P.to_tensor([1, 0])],
           t[..., -1], t[t > 20], t[:, P.to_tensor(np.array([2, 0]))]]
    u = P.zeros([3, 3])
    u[1, 1] = 5.0
    u[0] = P.ones([3])
    u[:, 2] = P.to_tensor(np.array([7., 8., 9.], np.float32))
    return out + [u]


def _reconstructions(P):
    a = P.to_tensor(_r(14, 4, 3))
    s = P.to_tensor(_spd())
    q, r = P.linalg.qr(a)
    u, sv, v = P.linalg.svd(a)
    w, vec = P.linalg.eigh(s)
    lu, piv = P.linalg.lu(s)
    pm, lo, up = P.linalg.lu_unpack(lu, piv)
    return [P.matmul(q, r), P.matmul(q.T, q), r.abs(),
            P.matmul(u * sv, v.T), sv, P.matmul(vec * w, vec.T), w,
            P.matmul(pm, P.matmul(lo, up)), vec.abs().sum(axis=0)]


@pytest.mark.parametrize("case", EXTRA, ids=[c[0] for c in EXTRA])
def test_unspecced_op(case):
    name, mode, fn = case
    jouts, touts = _outs(fn(jpaddle)), _outs(fn(tpaddle))
    assert len(jouts) == len(touts), name
    for k, (j, t) in enumerate(zip(jouts, touts)):
        assert isinstance(t, tpaddle.Tensor), (name, k, type(t))
        assert _dtype_name(t) == _dtype_name(j), (name, k, t.dtype, j.dtype)
        got, want = _np(t), _np(j)
        assert got.shape == want.shape, (name, k, got.shape, want.shape)
        if mode == "exact":
            np.testing.assert_array_equal(got, want, err_msg=f"{name}[{k}]")
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name}[{k}]")


def test_the_ports_copy_of_the_specs_equals_the_jax_table():
    """``paddle_tpu_torch/ops/op_spec.py`` (which the card's ``[tensor
    ops]`` phase runs) is the JAX table with ``P`` the port: the same
    specs in the same order, with the same inputs, kwargs, dtypes and
    bounds, and each callable the port's op of the JAX one's name."""
    from paddle_tpu_torch.ops import op_spec as top_spec
    port = top_spec.build_specs()
    assert [s.name for s in port] == [s.name for s in SPECS]
    fields = ("kwargs", "dtypes", "check_grad", "covers", "grad_inputs",
              "fw_rtol", "fw_atol", "grad_atol", "grad_rtol", "grad_eps")
    for j, t in zip(SPECS, port):
        for f in fields:
            assert getattr(t, f) == getattr(j, f), (j.name, f)
        for a, b in zip(_inputs(j), _inputs(t)):
            np.testing.assert_array_equal(a, b, err_msg=j.name)
        assert t.fn.__code__.co_code == port_fn(j.fn).__code__.co_code
        if j.fn.__name__ != "<lambda>":
            assert t.fn is getattr(tpaddle, j.fn.__name__), j.name
