"""The convolution family of the port against the JAX package: 1-D and
3-D convolutions, the three transposed convolutions (output padding,
``output_size``, groups, dilation, asymmetric padding) and their layers.

Each function is held against the JAX function's pure body (``.raw``)
under ``jax.vjp``, each layer against the JAX layer with its weights
carried across (forward 1e-5, gradients 1e-4 x max(|ref|, 1)), and
under ``auto_cast`` O2 in bf16 (5e-2 x max(|ref|, 1)).  Also: the JAX
positional order of every layer, the initializers' bounds, and the
refusal of ``padding_mode`` (which the JAX layers take and ignore).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu.ops import nn_ops as jops

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
from torch_parity_helpers import (BF16_TOL, CPU, check_fn, check_layer, close,
                                  positional_names, rand)
from torch_parity_helpers import torch_one_thread  # noqa: F401 (autouse)

CONV_CASES = {
    "conv1d k3 p1": ("conv1d", (2, 4, 11), (6, 4, 3), dict(padding=1)),
    "conv1d groups 2, stride 2, dilation 2, padding [1, 2]": (
        "conv1d", (2, 4, 13), (6, 2, 3),
        dict(stride=2, dilation=2, padding=[1, 2], groups=2)),
    "conv1d SAME stride 2": ("conv1d", (2, 4, 11), (5, 4, 4),
                             dict(stride=2, padding="SAME")),
    "conv3d (1, 3, 3) p (0, 1, 1) stride (1, 2, 2)": (
        "conv3d", (2, 3, 4, 9, 8), (5, 3, 1, 3, 3),
        dict(stride=(1, 2, 2), padding=(0, 1, 1))),
    "conv3d (3, 1, 1) p (1, 0, 0) stride (2, 1, 1)": (
        "conv3d", (2, 4, 5, 6, 6), (6, 4, 3, 1, 1),
        dict(stride=(2, 1, 1), padding=(1, 0, 0))),
    "conv3d groups 2 dilation 2 asymmetric": (
        "conv3d", (1, 4, 7, 7, 7), (4, 2, 3, 3, 3),
        dict(groups=2, dilation=2, padding=[1, 0, 2, 1, 0, 1])),
    "conv3d VALID (3, 7, 7) stride (1, 2, 2)": (
        "conv3d", (1, 3, 5, 12, 12), (4, 3, 3, 7, 7),
        dict(stride=(1, 2, 2), padding="VALID")),
    "conv2d_transpose s2 p1 op1 (CycleGAN)": (
        "conv2d_transpose", (2, 6, 5, 4), (6, 3, 3, 3),
        dict(stride=2, padding=1, output_padding=1)),
    "conv2d_transpose groups 2 dilation 2": (
        "conv2d_transpose", (2, 4, 5, 5), (4, 3, 3, 3),
        dict(stride=2, padding=2, dilation=2, groups=2)),
    "conv2d_transpose asymmetric [1, 0, 2, 1]": (
        "conv2d_transpose", (1, 3, 5, 6), (3, 2, 3, 4),
        dict(stride=(2, 3), padding=[1, 0, 2, 1])),
    "conv2d_transpose output_size": (
        "conv2d_transpose", (1, 3, 4, 4), (3, 2, 3, 3),
        dict(stride=3, padding=1, output_size=(12, 11))),
    "conv2d_transpose output padding 2 (past torch's own bound)": (
        "conv2d_transpose", (1, 3, 4, 4), (3, 2, 3, 3),
        dict(stride=3, padding=0, output_padding=2)),
    "conv1d_transpose s2 p1 op1 groups 2": (
        "conv1d_transpose", (2, 4, 7), (4, 3, 3),
        dict(stride=2, padding=1, output_padding=1, groups=2)),
    "conv1d_transpose output_size dilation 2": (
        "conv1d_transpose", (2, 3, 6), (3, 2, 3),
        dict(stride=2, padding=1, dilation=2, output_size=[14])),
    "conv3d_transpose s2 p1 op1": (
        "conv3d_transpose", (1, 4, 3, 4, 4), (4, 3, 3, 3, 3),
        dict(stride=2, padding=1, output_padding=1)),
    "conv3d_transpose output_size": (
        "conv3d_transpose", (1, 2, 3, 3, 3), (2, 2, 3, 3, 3),
        dict(stride=(1, 2, 2), padding=1, output_size=(3, 6, 5))),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv_function_matches_jax(case):
    op, xs, ws, kw = CONV_CASES[case]
    rng = np.random.default_rng(0)
    x, w = rand(rng, *xs), rand(rng, *ws, scale=0.3)
    cout = ws[0] if "transpose" not in op else ws[1] * kw.get("groups", 1)
    b = rand(rng, cout)
    jfn, tfn = getattr(jops, op).raw, getattr(TF, op)
    check_fn(lambda x, w, b: jfn(x, w, b, **kw),
             lambda x, w, b: tfn(x, w, b, **kw), [x, w, b])


LAYERS = {
    # name: (positional args, input shape, groups); the positional order
    # is the JAX layer's (the 2-D transpose puts dilation before groups,
    # the 1-D and 3-D ones groups before dilation)
    "Conv1D": ((4, 6, 3, 2, 1, 1, 2), (2, 4, 9), 2),
    "Conv3D": ((4, 6, (1, 3, 3), (1, 2, 2), (0, 1, 1), 1, 2),
               (1, 4, 3, 7, 7), 2),
    "Conv1DTranspose": ((4, 6, 3, 2, 1, 1, 2, 1), (2, 4, 5), 2),
    "Conv2DTranspose": ((4, 6, 3, 2, 1, 1, 1, 2), (2, 4, 4, 5), 2),
    "Conv3DTranspose": ((4, 6, 3, 2, 1, 1, 1, 1), (1, 4, 3, 3, 2), 1),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_conv_layer_matches_jax_positionally(name):
    args, xs, _ = LAYERS[name]
    assert positional_names(getattr(tnn, name)) == \
        positional_names(getattr(jnn, name))
    jpaddle.seed(0)
    jl = getattr(jnn, name)(*args)
    tl = getattr(tnn, name)(*args, device=CPU)
    assert tuple(tl.weight.shape) == tuple(jl.weight.shape)
    check_layer(jl, tl, [rand(np.random.default_rng(1), *xs)])


@pytest.mark.parametrize("name", list(LAYERS))
def test_conv_layer_initializers_follow_the_jax_layer(name):
    """KaimingUniform(fan_in = in/groups * prod(k)) for every
    convolution, the transposed ones too, and a zero bias;
    ``bias_attr=False`` leaves it out."""
    args, _, groups = LAYERS[name]
    tl = getattr(tnn, name)(*args, device=CPU,
                            generator=torch.Generator().manual_seed(0))
    limit = np.sqrt(6.0 / ((args[0] // groups) * np.prod(
        tl.weight.shape[2:])))
    w = tl.weight.detach().numpy()
    assert np.abs(w).max() <= limit and np.abs(w).max() > 0.8 * limit
    assert not tl.bias.detach().numpy().any()
    assert getattr(tnn, name)(*args, bias_attr=False, device=CPU).bias \
        is None


@pytest.mark.parametrize("op", ["conv1d", "conv3d", "conv2d_transpose",
                                "conv1d_transpose", "conv3d_transpose"])
def test_conv_family_bf16_under_o2_matches_jax(op):
    """Under ``auto_cast(level="O2", dtype="bfloat16")`` every input goes
    to bf16 in both packages (the 1-D and 3-D transposes too, which the
    white list lacks: O2 casts every op not on the black list)."""
    case = next(c for c in CONV_CASES.values() if c[0] == op)
    _, xs, ws, kw = case
    rng = np.random.default_rng(3)
    x, w = rand(rng, *xs), rand(rng, *ws, scale=0.3)
    J = jpaddle.to_tensor
    with jamp.auto_cast(level="O2", dtype="bfloat16"):
        jout = getattr(jops, op)(J(x), J(w), None, **kw)
    with tamp.auto_cast(level="O2", dtype="bfloat16"):
        tout = getattr(TF, op)(torch.from_numpy(x), torch.from_numpy(w),
                               None, **kw)
    assert tout.dtype == torch.bfloat16 and str(jout.dtype).endswith(
        "bfloat16")
    close(tout.float().numpy(), np.asarray(jout.numpy(), np.float32),
          BF16_TOL, op)


@pytest.mark.parametrize("name", ["Conv1D", "Conv2D", "Conv3D"])
def test_padding_mode_is_refused_as_the_reference_ignores_it(name):
    """The JAX ``_ConvBase`` takes ``padding_mode`` and never reads it
    (its ``Conv2D(padding_mode="reflect")`` pads with zeros)."""
    with pytest.raises(NotImplementedError, match="ignores it"):
        getattr(tnn, name)(3, 4, 3, padding=1, padding_mode="reflect",
                           device=CPU)


def test_transposed_refusals_follow_the_jax_functions():
    x = torch.zeros(1, 2, 3, 3, 3)
    with pytest.raises(NotImplementedError, match="groups"):
        TF.conv3d_transpose(x, torch.zeros(2, 1, 3, 3, 3), groups=2)
    with pytest.raises(NotImplementedError, match="str padding"):
        TF.conv2d_transpose(x[:, :, 0], torch.zeros(2, 1, 3, 3),
                            padding="SAME")
    with pytest.raises(ValueError, match="output_size"):
        TF.conv2d_transpose(x[:, :, 0], torch.zeros(2, 1, 3, 3), stride=2,
                            output_size=(9, 9))
    with pytest.raises(NotImplementedError, match="channels_last"):
        TF.conv3d(x, torch.zeros(2, 2, 1, 1, 1), data_format="NDHWC")


def test_conv2d_transpose_dtype_and_bias_follow_the_jax_function():
    """The output keeps the operands' dtype (no cast to the activation's,
    unlike ``conv2d``) and the bias is added after the convolution."""
    rng = np.random.default_rng(5)
    x, w, b = rand(rng, 1, 2, 3, 3), rand(rng, 2, 3, 2, 2), rand(rng, 3)
    jout = jops.conv2d_transpose.raw(jnp.asarray(x, jnp.bfloat16),
                                     jnp.asarray(w, jnp.bfloat16),
                                     jnp.asarray(b, jnp.bfloat16), 2)
    tout = TF.conv2d_transpose(torch.from_numpy(x).bfloat16(),
                               torch.from_numpy(w).bfloat16(),
                               torch.from_numpy(b).bfloat16(), 2)
    assert tout.dtype == torch.bfloat16
    close(tout.float().numpy(), np.asarray(jout.astype(jnp.float32)),
          BF16_TOL)
