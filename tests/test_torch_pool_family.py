"""The pooling family of the port against the JAX package: 1-D and 3-D
max and average pools (``exclusive``, ``ceil_mode``, "SAME",
``divisor_override``), the adaptive 1-D and 3-D pools, the masks of
``max_pool1d/2d/3d(return_mask=True)`` (Paddle's flat per-plane
indices, compared exactly), ``max_unpool1d/2d/3d`` and every layer.

Functions against the JAX ``.raw`` bodies under ``jax.vjp`` (forward
1e-5, gradients 1e-4 x max(|ref|, 1)); bf16 under O2 within 5e-2.  The
arguments the JAX layers take and drop (``MaxPool1D``'s ``return_mask``
and ``ceil_mode``, ``AvgPool1D``'s ``ceil_mode``,
``adaptive_max_pool2d``'s ``return_mask``) are refused.
"""

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
from torch_parity_helpers import (BF16_TOL, FWD_TOL, check_fn, close,
                                  positional_names, rand)
from torch_parity_helpers import torch_one_thread  # noqa: F401 (autouse)

POOL_CASES = {
    "max_pool1d k3 s2 p1": ("max_pool1d", (2, 3, 11),
                            dict(kernel_size=3, stride=2, padding=1)),
    "max_pool1d SAME": ("max_pool1d", (2, 3, 10),
                        dict(kernel_size=4, stride=3, padding="SAME")),
    "max_pool1d padding [0, 2]": ("max_pool1d", (2, 3, 9),
                                  dict(kernel_size=3, padding=[0, 2])),
    "avg_pool1d k3 s2 p1 exclusive": ("avg_pool1d", (2, 3, 11),
                                      dict(kernel_size=3, stride=2,
                                           padding=1)),
    "avg_pool1d k3 p1 inclusive": ("avg_pool1d", (2, 3, 8),
                                   dict(kernel_size=3, stride=1, padding=1,
                                        exclusive=False)),
    "avg_pool1d SAME (divides by k)": ("avg_pool1d", (2, 3, 10),
                                       dict(kernel_size=4, stride=3,
                                            padding="SAME")),
    "max_pool3d k3 s2 p1": ("max_pool3d", (2, 2, 5, 7, 6),
                            dict(kernel_size=3, stride=2, padding=1)),
    "max_pool3d (1, 2, 2) ceil": ("max_pool3d", (1, 3, 4, 5, 7),
                                  dict(kernel_size=(1, 2, 2),
                                       stride=(1, 2, 2), ceil_mode=True)),
    "max_pool3d SAME": ("max_pool3d", (1, 2, 5, 5, 6),
                        dict(kernel_size=2, stride=2, padding="SAME")),
    "avg_pool3d k3 s2 p1 exclusive ceil": ("avg_pool3d", (1, 2, 5, 6, 7),
                                           dict(kernel_size=3, stride=2,
                                                padding=1, ceil_mode=True)),
    "avg_pool3d inclusive": ("avg_pool3d", (1, 2, 4, 5, 5),
                             dict(kernel_size=(2, 3, 3), stride=1,
                                  padding=1, exclusive=False)),
    "avg_pool3d divisor_override 5": ("avg_pool3d", (1, 2, 4, 4, 4),
                                      dict(kernel_size=2, stride=2,
                                           padding=1, divisor_override=5)),
    "avg_pool3d asymmetric padding": ("avg_pool3d", (1, 2, 4, 5, 5),
                                      dict(kernel_size=2, stride=1,
                                           padding=[1, 0, 0, 1, 1, 1])),
}


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pool_function_matches_jax(case):
    op, xs, kw = POOL_CASES[case]
    x = rand(np.random.default_rng(0), *xs)
    jfn, tfn = getattr(jops, op).raw, getattr(TF, op)
    check_fn(lambda x: jfn(x, **kw), lambda x: tfn(x, **kw), [x])


ADAPTIVE = [("adaptive_avg_pool1d", (2, 3, 10), 4),
            ("adaptive_max_pool1d", (2, 3, 10), 3),
            ("adaptive_avg_pool3d", (1, 2, 5, 7, 6), (2, 3, 4)),
            ("adaptive_max_pool3d", (1, 2, 5, 7, 6), (3, 3, 2)),
            ("adaptive_avg_pool3d", (1, 2, 4, 6, 6), 1)]


@pytest.mark.parametrize("op, xs, size", ADAPTIVE)
def test_adaptive_pool_matches_jax(op, xs, size):
    x = rand(np.random.default_rng(1), *xs)
    jfn, tfn = getattr(jops, op).raw, getattr(TF, op)
    check_fn(lambda x: jfn(x, size), lambda x: tfn(x, size), [x])


MASK_CASES = {
    "max_pool2d k2 s2": ("max_pool2d", (2, 3, 6, 8),
                         dict(kernel_size=2, stride=2)),
    "max_pool2d k3 s2 p1": ("max_pool2d", (2, 3, 7, 6),
                            dict(kernel_size=3, stride=2, padding=1)),
    "max_pool2d padding [0, 1, 1, 0] (the -inf-padded path)": (
        "max_pool2d", (1, 2, 5, 6),
        dict(kernel_size=(2, 3), stride=1, padding=[0, 1, 1, 0])),
    "max_pool1d k3 s2 p1": ("max_pool1d", (2, 3, 9),
                            dict(kernel_size=3, stride=2, padding=1)),
    "max_pool3d k2 s2": ("max_pool3d", (1, 2, 4, 6, 4),
                         dict(kernel_size=2, stride=2)),
    "max_pool3d (1, 3, 3) p (0, 1, 1)": ("max_pool3d", (1, 2, 3, 5, 5),
                                         dict(kernel_size=(1, 3, 3),
                                              stride=(1, 2, 2),
                                              padding=(0, 1, 1))),
}


@pytest.mark.parametrize("case", list(MASK_CASES))
def test_return_mask_matches_jax_exactly(case):
    """The pooled values and the mask (Paddle's flat index of each
    window's max in the unpadded plane, int64) are the JAX function's;
    the gradient reaches the same elements."""
    op, xs, kw = MASK_CASES[case]
    x = rand(np.random.default_rng(2), *xs)
    jout, jmask = getattr(jops, op).raw(jnp.asarray(x), return_mask=True,
                                        **kw)
    tout, tmask = getattr(TF, op)(torch.from_numpy(x), return_mask=True,
                                  **kw)
    assert tmask.dtype == torch.int64
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    close(tout.numpy(), np.asarray(jout), FWD_TOL)
    check_fn(lambda x: getattr(jops, op).raw(x, **kw),
             lambda x: getattr(TF, op)(x, **kw), [x])


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_max_unpool_inverts_the_jax_mask(nd):
    """``max_unpool{nd}d`` on the JAX pool's output and mask, against the
    JAX unpool: values, the gradient of the pooled values, and
    ``output_size``."""
    xs = {1: (2, 3, 8), 2: (2, 3, 6, 4), 3: (1, 2, 4, 4, 6)}[nd]
    x = rand(np.random.default_rng(3), *xs)
    pool = getattr(jops, f"max_pool{nd}d").raw
    y, mask = pool(jnp.asarray(x), 2, 2, return_mask=True)
    y, mask = np.array(y), np.array(mask)
    jun = getattr(jops, f"max_unpool{nd}d").raw
    tun = getattr(TF, f"max_unpool{nd}d")
    tmask = torch.from_numpy(mask)
    check_fn(lambda v: jun(v, jnp.asarray(mask), 2, 2),
             lambda v: tun(v, tmask, 2, 2), [y])
    bigger = [s + 1 for s in xs[2:]]
    close(tun(torch.from_numpy(y), tmask, 2, 2, output_size=bigger).numpy(),
          np.asarray(jun(jnp.asarray(y), jnp.asarray(mask), 2, 2,
                         output_size=bigger)), FWD_TOL)
    with pytest.raises(ValueError, match="out of range"):
        tun(torch.from_numpy(y), tmask + 10 ** 4, 2, 2)


LAYERS = {
    # name: (positional args, input shape)
    "MaxPool1D": ((3, 2, 1), (2, 3, 9)),
    "AvgPool1D": ((3, 2, 1, False), (2, 3, 9)),
    "MaxPool3D": ((3, 2, 1, True), (1, 2, 5, 6, 6)),
    "AvgPool3D": ((3, 2, 1, False, True, None), (1, 2, 5, 6, 6)),
    "AdaptiveAvgPool1D": ((4,), (2, 3, 9)),
    "AdaptiveMaxPool1D": ((4,), (2, 3, 9)),
    "AdaptiveAvgPool3D": (((1, 2, 3),), (1, 2, 5, 6, 6)),
    "AdaptiveMaxPool3D": ((2,), (1, 2, 5, 6, 6)),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_pool_layer_matches_jax_positionally(name):
    args, xs = LAYERS[name]
    assert positional_names(getattr(tnn, name)) == \
        positional_names(getattr(jnn, name))
    x = rand(np.random.default_rng(4), *xs)
    jl, tl = getattr(jnn, name)(*args), getattr(tnn, name)(*args)
    close(tl(torch.from_numpy(x)).numpy(), np.asarray(jl(JTensor(x)).numpy()),
          FWD_TOL, name)


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_max_unpool_layers_match_jax(nd):
    name = f"MaxUnPool{nd}D"
    assert positional_names(getattr(tnn, name)) == \
        positional_names(getattr(jnn, name))
    xs = {1: (2, 3, 8), 2: (2, 3, 6, 4), 3: (1, 2, 4, 4, 6)}[nd]
    x = rand(np.random.default_rng(5), *xs)
    pool = getattr(TF, f"max_pool{nd}d")
    y, mask = pool(torch.from_numpy(x), 2, 2, return_mask=True)
    jl, tl = getattr(jnn, name)(2, 2), getattr(tnn, name)(2, 2)
    close(tl(y, mask).numpy(),
          np.asarray(jl(JTensor(y.numpy()), JTensor(mask.numpy())).numpy()),
          FWD_TOL, name)


def test_max_pool3d_layer_returns_the_mask():
    """``MaxPool3D(return_mask=True)`` passes it on in the JAX package
    (``MaxPool2D`` does not, and is refused)."""
    x = rand(np.random.default_rng(6), 1, 2, 4, 4, 6)
    out, mask = tnn.MaxPool3D(2, return_mask=True)(torch.from_numpy(x))
    jout, jmask = jnn.MaxPool3D(2, return_mask=True)(JTensor(x))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask.numpy()))
    close(out.numpy(), np.asarray(jout.numpy()), FWD_TOL)


def test_arguments_the_reference_ignores_are_refused():
    x = torch.zeros(1, 2, 8)
    for make in (lambda: tnn.MaxPool2D(2, return_mask=True),
                 lambda: tnn.MaxPool1D(2, return_mask=True),
                 lambda: tnn.MaxPool1D(2, ceil_mode=True),
                 lambda: tnn.AvgPool1D(2, ceil_mode=True),
                 lambda: tnn.AdaptiveMaxPool2D(2, return_mask=True),
                 lambda: TF.max_pool1d(x, 3, 2, ceil_mode=True),
                 lambda: TF.avg_pool1d(x, 3, 2, ceil_mode=True),
                 lambda: TF.adaptive_max_pool2d(x[None], 2,
                                                return_mask=True)):
        with pytest.raises(NotImplementedError, match="ignores it"):
            make()


def test_refusals_the_jax_functions_share():
    x = torch.zeros(1, 2, 4, 4, 4)
    with pytest.raises(NotImplementedError, match="ceil_mode"):
        TF.max_pool3d(x, 2, ceil_mode=True, return_mask=True)
    with pytest.raises(NotImplementedError, match="str padding"):
        TF.max_pool2d(x[:, :, 0], 2, padding="SAME", return_mask=True)
    with pytest.raises(NotImplementedError, match="return_mask"):
        TF.adaptive_max_pool3d(x, 2, return_mask=True)
    with pytest.raises(NotImplementedError, match="channels_last"):
        tnn.MaxPool3D(2, data_format="NDHWC")


@pytest.mark.parametrize("op, kw", [
    ("max_pool3d", dict(kernel_size=3, stride=2, padding=1)),
    ("avg_pool3d", dict(kernel_size=3, stride=2, padding=1)),
    ("adaptive_avg_pool3d", dict(output_size=1)),
    ("max_pool1d", dict(kernel_size=3, stride=2, padding=1))])
def test_pool_family_bf16_under_o2_matches_jax(op, kw):
    shape = (2, 4, 9) if op.endswith("1d") else (2, 4, 4, 7, 7)
    x = rand(np.random.default_rng(7), *shape)
    with jamp.auto_cast(level="O2", dtype="bfloat16"):
        jout = getattr(jops, op)(jpaddle.to_tensor(x), **kw)
    with tamp.auto_cast(level="O2", dtype="bfloat16"):
        tout = getattr(TF, op)(torch.from_numpy(x), **kw)
    assert tout.dtype == torch.bfloat16
    close(tout.float().numpy(), np.asarray(jout.numpy(), np.float32),
          BF16_TOL, op)
