"""Helpers the ``nn`` family parity tests share (not a test module): the
tolerance check, seeded inputs, one function held against its JAX
counterpart with ``jax.vjp``, and weights carried from a JAX layer.

Tolerances (fp32): forward 1e-5 x max(|ref|, 1), gradients 1e-4 x
max(|ref|, 1): the two packages compute the same sums in another order
(XLA against ATen on the CPU).  bf16 under O2: 5e-2 x max(|ref|, 1), as
``tests/test_torch_vision_resnet.py`` holds a bf16 forward.
"""

import numpy as np
import pytest
import torch

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 5e-2
CPU = "cpu"


# torch's inter-op pool is sized once per process, before its first use:
# one thread, set when the first module that imports this one loads
try:
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread(request):
    """The port's CPU ops on one thread while a module that imports this
    fixture runs: the suite runs several test processes at once, each of
    which would start a thread per core, and the oversubscribed cores
    made these tests several times slower.  The thread count comes back
    after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def session_shared(tmp_path_factory, key, compute):
    """``compute()`` once per test session for ``key``, whichever xdist
    workers ask: the first computes it under a file lock in the
    session's shared temporary directory and pickles it, the others
    wait and read it (a module fixture alone runs once per worker that
    runs one of its tests).  An exception is kept and raised to every
    asker."""
    import fcntl
    import os
    import pickle
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = os.path.join(str(base), f"shared-{key}")
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(path + ".pkl"):
                try:
                    out = compute()
                except Exception as e:  # noqa: BLE001
                    out = e
                with open(path + ".tmp", "wb") as f:
                    pickle.dump(out, f)
                os.replace(path + ".tmp", path + ".pkl")
            with open(path + ".pkl", "rb") as f:
                out = pickle.load(f)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if isinstance(out, Exception):
        raise out
    return out


def close(got, ref, tol, what=""):
    """``got`` within ``tol * max(|ref|, 1)`` of ``ref`` everywhere the
    reference is finite, and equal where it is not."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(got[~finite], ref[~finite], err_msg=what)
    scale = max(float(np.abs(ref[finite]).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got[finite], ref[finite], rtol=0,
                               atol=tol * scale, err_msg=what)


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def to_np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def check_fn(jfn, tfn, inputs, seed=0, fwd_tol=FWD_TOL, grad_tol=GRAD_TOL,
             grads=True):
    """``jfn`` (jnp arrays) and ``tfn`` (torch tensors) on the same fp32
    ``inputs``: the output, and the gradient of every input for one
    random cotangent.  Returns the port's output."""
    import jax
    import jax.numpy as jnp
    jin = [jnp.asarray(a) for a in inputs]
    # one compiled program a case (the forward and its vjp), not one
    # per primitive as eager dispatch compiles them
    jout = jax.jit(jfn)(*jin)
    tin = [torch.tensor(a, requires_grad=grads) for a in inputs]
    tout = tfn(*tin)
    close(to_np(tout), np.asarray(jout, np.float32), fwd_tol, "forward")
    if not grads:
        return tout
    rng = np.random.default_rng(seed + 100)
    g = rng.standard_normal(np.shape(jout)).astype(np.float32)
    g[~np.isfinite(np.asarray(jout, np.float32))] = 0.0
    jgrads = jax.jit(lambda g, *xs: jax.vjp(jfn, *xs)[1](g))(
        jnp.asarray(g), *jin)
    tout.backward(torch.from_numpy(g))
    for i, (t, jg) in enumerate(zip(tin, jgrads)):
        close(t.grad.numpy(), np.asarray(jg), grad_tol, f"grad {i}")
    return tout


def copy_weights(jlayer, tlayer):
    """The JAX layer's parameters and buffers into the port's, by name
    (``set_state_dict`` checks the shapes); both hold the same names."""
    state = {k: np.asarray(v.numpy()) for k, v in
             jlayer.state_dict().items()}
    missing, unexpected = tlayer.set_state_dict(state)
    assert not missing and not unexpected, (missing, unexpected)


def check_layer(jlayer, tlayer, inputs, fwd_tol=FWD_TOL, grad_tol=GRAD_TOL,
                seed=0):
    """A JAX layer and the port's on the same fp32 ``inputs`` (weights
    carried across): the output, and the gradients of the inputs and of
    every parameter for one random cotangent.  The JAX layer runs as
    one compiled program (its parameters bound by ``functional_call.
    bind``) under ``jax.vjp``."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.nn.functional_call import bind
    from paddle_tpu.tensor import Tensor as JTensor
    copy_weights(jlayer, tlayer)
    names = [n for n, _ in jlayer.named_parameters()]
    params = [p._value for _, p in jlayer.named_parameters()]

    def fwd(params, *xs):
        with bind(jlayer, dict(zip(names, params))):
            return jlayer(*[JTensor(x) for x in xs])._value

    jin = [jnp.asarray(a) for a in inputs]
    ref = np.asarray(jax.jit(fwd)(params, *jin), np.float32)
    tin = [torch.tensor(a, requires_grad=True) for a in inputs]
    tout = tlayer(*tin)
    close(to_np(tout), ref, fwd_tol, type(tlayer).__name__)
    g = np.random.default_rng(seed + 7).standard_normal(ref.shape).astype(
        np.float32)
    jp, *jx = jax.jit(lambda g, p, *xs: jax.vjp(fwd, p, *xs)[1](g))(
        jnp.asarray(g), params, *jin)
    tout.backward(torch.from_numpy(g))
    for i, (j, t) in enumerate(zip(jx, tin)):
        close(t.grad.numpy(), np.asarray(j), grad_tol, f"input {i}")
    jparams = dict(zip(names, jp))
    for name, p in tlayer.named_parameters():
        close(p.grad.numpy(), np.asarray(jparams[name]), grad_tol, name)
    return tout


def check_layer_eager(jlayer, tlayer, inputs, fwd_tol=FWD_TOL,
                      grad_tol=GRAD_TOL, seed=0):
    """:func:`check_layer` through the JAX package's eager tape, for
    layers whose forward pre-hooks write buffers or record their own tape
    nodes (``weight_norm``, ``spectral_norm``), which a traced call would
    leak."""
    import paddle_tpu as jpaddle
    copy_weights(jlayer, tlayer)
    jin = [jpaddle.to_tensor(a, stop_gradient=False) for a in inputs]
    tin = [torch.tensor(a, requires_grad=True) for a in inputs]
    jout, tout = jlayer(*jin), tlayer(*tin)
    ref = np.asarray(jout.numpy(), np.float32)
    close(to_np(tout), ref, fwd_tol, type(tlayer).__name__)
    g = np.random.default_rng(seed + 7).standard_normal(ref.shape).astype(
        np.float32)
    (jout * jpaddle.to_tensor(g)).sum().backward()
    tout.backward(torch.from_numpy(g))
    for i, (j, t) in enumerate(zip(jin, tin)):
        close(t.grad.numpy(), np.asarray(j.grad.numpy()), grad_tol,
              f"input {i}")
    jparams = dict(jlayer.named_parameters())
    for name, p in tlayer.named_parameters():
        close(p.grad.numpy(), np.asarray(jparams[name].grad.numpy()),
              grad_tol, name)
    return tout


def jit_forward(jlayer, *inputs):
    """The JAX layer's output on ``inputs`` as one compiled program, its
    parameters and buffers passed in (``functional_call.bind``) rather
    than baked into the program as constants."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.nn.functional_call import bind, buffer_dict
    from paddle_tpu.tensor import Tensor as JTensor
    params = {n: p._value for n, p in jlayer.named_parameters()}

    def fwd(params, buffers, *xs):
        with bind(jlayer, params, buffers):
            return jlayer(*[JTensor(x) for x in xs])._value

    return np.asarray(jax.jit(fwd)(params, buffer_dict(jlayer), *[
        jnp.asarray(x) for x in inputs]), np.float32)


def jax_twin(build_jax, tlayer):
    """The JAX package's twin of the port's ``tlayer``: ``build_jax()``
    under ``LazyGuard`` (zeros placeholders: no initializer compiles a
    program per shape), then the port's state copied in by name."""
    import paddle_tpu as jpaddle
    with jpaddle.LazyGuard():
        jlayer = build_jax()
    jlayer.set_state_dict({k: v.detach().numpy() for k, v in
                           tlayer.state_dict().items()})
    return jlayer


def positional_names(cls):
    """The positional parameter names of ``cls.__init__`` (or of a
    function) after ``self``."""
    import inspect
    fn = cls.__init__ if isinstance(cls, type) else getattr(cls, "raw", cls)
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind == p.POSITIONAL_OR_KEYWORD and p.name != "self"]
