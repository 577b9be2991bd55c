"""The rest of ``nn`` in the port against the JAX package: every
activation and its layer, the dropouts, the pads, the shape and
upsampling layers, Fold / Unfold, CosineSimilarity, Bilinear and the
remaining functions (``temporal_shift``, ``affine_grid``,
``grid_sample``, ``one_hot``, ``normalize``, ``sequence_mask``,
``embedding``).

Functions against the JAX ``.raw`` bodies under ``jax.vjp`` (forward
1e-5, gradients 1e-4 x max(|ref|, 1)).  The random ones (dropout masks,
``RReLU``'s slopes, the Gumbel noise) draw different bits by design:
the JAX package's draw is replaced by a given array (``monkeypatch`` on
``jax.random``) and the port's plain function of the draw
(``*_apply``) takes the same array; the port's own draws are held by
distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import activation as jact
from paddle_tpu.ops import creation as jcreation
from paddle_tpu.ops import manipulation as jmanip
from paddle_tpu.ops import nn_ops as jops
from paddle_tpu.tensor import Tensor as JTensor

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import activation as tact
from paddle_tpu_torch.ops import nn_ops as tops
from torch_parity_helpers import (BF16_TOL, CPU, FWD_TOL, check_fn,
                                  check_layer, close, positional_names, rand)
from torch_parity_helpers import torch_one_thread  # noqa: F401 (autouse)

ACTS = {
    # name: (extra positional args, input scale)
    "leaky_relu": ((0.2,), 3.0), "elu": ((0.7,), 3.0), "selu": ((), 3.0),
    "celu": ((1.5,), 3.0), "log_sigmoid": ((), 6.0),
    "hardtanh": ((-1.5, 2.0), 3.0), "tanhshrink": ((), 3.0),
    "softplus": ((2.0, 5.0), 4.0), "softsign": ((), 3.0),
    "softshrink": ((0.3,), 2.0), "hardshrink": ((0.4,), 2.0),
    "mish": ((), 4.0), "tanh": ((), 3.0),
    "thresholded_relu": ((0.5, -0.25), 2.0), "rrelu": ((0.1, 0.3), 3.0),
    "softmax": ((0,), 3.0), "log_softmax": ((1,), 3.0), "glu": ((1,), 2.0),
    "maxout": ((2, 1), 2.0), "prelu (one slope)": (("w1",), 3.0),
    "prelu (per channel)": (("w4",), 3.0),
}


@pytest.mark.parametrize("name", list(ACTS))
def test_activation_function_matches_jax(name):
    args, scale = ACTS[name]
    op = name.split(" ")[0]
    rng = np.random.default_rng(0)
    x = rand(rng, 3, 4, 5, scale=scale)
    if op == "prelu":
        w = rand(rng, int(args[0][1:]), scale=0.5)
        check_fn(lambda x, w: jact.prelu.raw(x, w),
                 lambda x, w: tact.prelu(x, w), [x, w])
        return
    jfn, tfn = getattr(jact, op).raw, getattr(tact, op)
    check_fn(lambda x: jfn(x, *args), lambda x: tfn(x, *args), [x])


LAYERS = {
    # name: positional args (the JAX layer's order)
    "LeakyReLU": (0.2,), "ELU": (0.5,), "SELU": (), "CELU": (2.0,),
    "LogSigmoid": (), "Hardtanh": (-2.0, 1.0), "Tanh": (),
    "Tanhshrink": (), "Softplus": (2.0, 10.0), "Softsign": (),
    "Softshrink": (0.3,), "Hardshrink": (0.2,), "Mish": (),
    "ThresholdedReLU": (0.4,), "Maxout": (2,), "GLU": (1,),
    "Softmax": (1,), "LogSoftmax": (0,), "Softmax2D": (),
    "PReLU": (4, 0.1), "RReLU": (0.1, 0.2),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_activation_layer_matches_jax(name):
    args = LAYERS[name]
    jl = getattr(jnn, name)(*args)
    tl = getattr(tnn, name)(*args, **({"device": CPU} if name == "PReLU"
                                      else {}))
    if name in ("RReLU",):
        jl.eval()
        tl.eval()
    if name in ("PReLU", "Softmax", "LogSoftmax", "RReLU"):
        assert positional_names(getattr(tnn, name)) == \
            positional_names(getattr(jnn, name))
    x = rand(np.random.default_rng(1), 2, 4, 3, 3, scale=3.0)
    check_layer(jl, tl, [x])


def test_rrelu_draws_slopes_while_training(monkeypatch):
    """Training: the JAX layer's uniform slopes injected, the port's
    ``rrelu_apply`` on the same slopes; the port's own draw lies in
    [lower, upper] with the mean near the middle."""
    x = rand(np.random.default_rng(2), 64, 64, scale=3.0)
    slope = np.random.default_rng(3).uniform(0.1, 0.3, x.shape).astype(
        np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype, lo, hi: jnp.asarray(slope))
    jout = np.asarray(jnn.RReLU(0.1, 0.3)(JTensor(x)).numpy())
    close(tact.rrelu_apply(torch.from_numpy(x),
                           torch.from_numpy(slope)).numpy(), jout, FWD_TOL)
    out = tnn.RReLU(0.1, 0.3)(torch.from_numpy(x)).numpy()
    neg = x < 0
    drawn = out[neg] / x[neg]
    assert drawn.min() >= 0.1 - 1e-6 and drawn.max() <= 0.3 + 1e-6
    assert abs(drawn.mean() - 0.2) < 0.01
    np.testing.assert_array_equal(out[~neg], x[~neg])
    with pytest.raises(NotImplementedError, match="ignores it"):
        TF.rrelu(torch.from_numpy(x), training=True)


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_with_the_noise_injected(monkeypatch, hard):
    x = rand(np.random.default_rng(4), 6, 5, scale=2.0)
    g = np.random.default_rng(5).gumbel(size=x.shape).astype(np.float32)
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype: jnp.asarray(g))
    jout = np.asarray(jact.gumbel_softmax(JTensor(x), 0.5, hard).numpy())
    tout = tact.gumbel_softmax_apply(torch.from_numpy(x), torch.from_numpy(g),
                                     0.5, hard)
    close(tout.numpy(), jout, FWD_TOL)
    # the port's own draw: rows of argmax counts follow softmax(x)
    torch.manual_seed(0)
    xs = torch.tensor([[1.0, 0.0, -1.0]]).repeat(4000, 1)
    counts = TF.gumbel_softmax(xs, 1.0, True).sum(0).numpy() / 4000
    np.testing.assert_allclose(counts, torch.softmax(xs[0], 0).numpy(),
                               atol=0.03)


def test_softmax_dtype_argument_matches_jax():
    x = rand(np.random.default_rng(6), 3, 4)
    jout = jact.softmax.raw(jnp.asarray(x), -1, "float64")
    tout = tact.softmax(torch.from_numpy(x), -1, "float64")
    assert tout.dtype == torch.float64 and str(jout.dtype) in (
        "float64", "float32")
    close(tout.numpy(), np.asarray(jout), FWD_TOL)


DROPS = {
    # name: (JAX call, port call on the injected mask, mask shape of x)
    "dropout axis 1": (
        lambda x: JF.dropout(x, 0.3, 1), lambda x, k: tops.dropout_apply(
            x, k, 0.3), lambda s: (1, s[1], 1, 1)),
    "dropout downscale_in_infer": (
        lambda x: JF.dropout(x, 0.3, None, True, "downscale_in_infer"),
        lambda x, k: tops.dropout_apply(x, k, 0.3, "downscale_in_infer"),
        lambda s: s),
    "dropout2d": (lambda x: JF.dropout2d(x, 0.4),
                  lambda x, k: tops.dropout_apply(x, k, 0.4),
                  lambda s: (s[0], s[1], 1, 1)),
    "alpha_dropout": (lambda x: JF.alpha_dropout(x, 0.2),
                      lambda x, k: tops.alpha_dropout_apply(x, k, 0.2),
                      lambda s: s),
}


@pytest.mark.parametrize("name", list(DROPS))
def test_dropout_family_with_the_mask_injected(monkeypatch, name):
    jcall, tcall, mshape = DROPS[name]
    x = rand(np.random.default_rng(7), 4, 6, 3, 3)
    keep = np.random.default_rng(8).random(mshape(x.shape)) > 0.3
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(keep))
    jout = np.asarray(jcall(jpaddle.to_tensor(x)).numpy())
    close(tcall(torch.from_numpy(x), torch.from_numpy(keep)).numpy(), jout,
          FWD_TOL)


@pytest.mark.parametrize("name, kw, shared", [
    ("Dropout", dict(p=0.3, axis=[0, 2]), (1, 3)),
    ("Dropout2D", dict(p=0.3), (2, 3)),
    ("Dropout3D", dict(p=0.3), (2, 3, 4)),
    ("AlphaDropout", dict(p=0.3), ())])
def test_dropout_layers_draw_their_own_masks(name, kw, shared):
    """The port's draws: about ``p`` dropped, one draw along the shared
    dims, the kept values as the JAX formula gives them; eval mode is
    the identity (the JAX layers' too)."""
    shape = (64, 32, 4, 4, 4)[:4 if name != "Dropout3D" else 5]
    x = np.random.default_rng(9).uniform(1.0, 2.0, shape).astype(np.float32)
    layer = getattr(tnn, name)(**kw)
    out = layer(torch.from_numpy(x)).numpy()
    if name == "AlphaDropout":
        alpha_p = -1.6732632423543772 * 1.0507009873554805
        a = ((0.7) * (1 + 0.3 * alpha_p ** 2)) ** -0.5
        kept = ~np.isclose(out, a * alpha_p - a * alpha_p * 0.3)
        np.testing.assert_allclose(out[kept], a * x[kept] - a * alpha_p * 0.3,
                                   rtol=1e-5)
    else:
        kept = out != 0
        np.testing.assert_allclose(out[kept], x[kept] / 0.7, rtol=1e-6)
        for d in shared:
            assert (kept == kept.take([0], axis=d)).all()
    assert abs(kept.mean() - 0.7) < 0.05
    layer.eval()
    jl = getattr(jnn, name)(**kw)
    jl.eval()
    np.testing.assert_array_equal(layer(torch.from_numpy(x)).numpy(),
                                  np.asarray(jl(JTensor(x)).numpy()))


PADS = {
    "constant 2-D": ((2, 3, 4, 5), [1, 2, 0, 3], "constant", "NCHW"),
    "reflect 2-D (CycleGAN's 3)": ((1, 3, 6, 7), [3, 3, 3, 3], "reflect",
                                   "NCHW"),
    "replicate 1-D": ((2, 3, 6), [2, 1], "replicate", "NCL"),
    "circular 3-D": ((1, 2, 4, 4, 5), [1, 1, 2, 0, 1, 2], "circular",
                     "NCDHW"),
    "reflect NHWC": ((2, 5, 6, 3), [1, 2, 2, 1], "reflect", "NHWC"),
    "reflect every dim": ((3, 4, 5), [1, 1, 0, 2, 2, 0], "reflect", "NCL"),
}


@pytest.mark.parametrize("case", list(PADS))
def test_pad_matches_jax(case):
    xs, pad, mode, fmt = PADS[case]
    x = rand(np.random.default_rng(10), *xs)
    check_fn(lambda x: jmanip.pad.raw(x, pad, mode, 0.5, fmt),
             lambda x: TF.pad(x, pad, mode, 0.5, fmt), [x])


@pytest.mark.parametrize("name, args, xs", [
    ("Pad1D", ([1, 2], "reflect"), (2, 3, 6)),
    ("Pad2D", ([1, 2, 2, 1], "replicate"), (2, 3, 4, 5)),
    ("Pad3D", ([1, 0, 0, 1, 1, 1], "constant", 2.0), (1, 2, 3, 3, 3)),
    ("ZeroPad2D", ([1, 1, 2, 0],), (2, 3, 4, 4)),
    ("Flatten", (1, 2), (2, 3, 4, 5)),
    ("Unflatten", (1, [2, 3]), (2, 6, 4)),
    ("Upsample", (None, 2, "nearest"), (1, 2, 3, 4)),
    ("Upsample", ((6, 5), None, "bilinear"), (1, 2, 3, 4)),
    ("UpsamplingBilinear2D", ((5, 7),), (1, 2, 3, 4)),
    ("UpsamplingNearest2D", (None, 2), (1, 2, 3, 4)),
    ("PixelShuffle", (2,), (1, 8, 3, 4)),
    ("PixelUnshuffle", (2,), (1, 2, 4, 6)),
    ("ChannelShuffle", (3,), (2, 6, 2, 3)),
    ("Unfold", ([2, 3], 1, [1, 0], [1, 2]), (2, 3, 5, 6)),
    ("Fold", ([4, 5], 2, 1, 0, 1), (2, 12, 12)),
    ("Fold", ([6, 6], 3, 2, 1, 1), (1, 18, 9))])
def test_shape_and_upsampling_layers_match_jax(name, args, xs):
    assert positional_names(getattr(tnn, name)) == \
        positional_names(getattr(jnn, name))
    jl, tl = getattr(jnn, name)(*args), getattr(tnn, name)(*args)
    check_layer(jl, tl, [rand(np.random.default_rng(11), *xs)])


def test_cosine_similarity_and_bilinear_layers_match_jax():
    rng = np.random.default_rng(12)
    a, b = rand(rng, 3, 5, 4), rand(rng, 3, 5, 4)
    check_layer(jnn.CosineSimilarity(2, 1e-6), tnn.CosineSimilarity(2, 1e-6),
                [a, b])
    assert positional_names(tnn.Bilinear) == positional_names(jnn.Bilinear)
    jl = jnn.Bilinear(4, 3, 5)
    tl = tnn.Bilinear(4, 3, 5, device=CPU)
    assert tuple(tl.weight.shape) == (5, 4, 3) and tuple(tl.bias.shape) == \
        (1, 5)
    with torch.no_grad():
        tl.bias.copy_(torch.from_numpy(rand(rng, 1, 5)))
    jl.set_state_dict({k: v.numpy() for k, v in tl.state_dict().items()})
    check_layer(jl, tl, [rand(rng, 6, 4), rand(rng, 6, 3)])
    std = tnn.Bilinear(40, 30, 50, device=CPU).weight.detach().std()
    assert abs(float(std) / np.sqrt(2 / (40 * 30 + 50 * 30)) - 1) < 0.05


FNS = {
    "temporal_shift": (
        [(6, 8, 2, 3)], lambda m: lambda x: m.temporal_shift(x, 3, 0.25)),
    "affine_grid align": (
        [(2, 2, 3)], lambda m: lambda t: m.affine_grid(t, [2, 1, 4, 5],
                                                       True)),
    "affine_grid half-pixel": (
        [(2, 2, 3)], lambda m: lambda t: m.affine_grid(t, [2, 1, 3, 4],
                                                       False)),
    "bilinear": ([(5, 3), (5, 4), (2, 3, 4), (2,)],
                 lambda m: lambda a, b, w, c: m.bilinear(a, b, w, c)),
    "fold asymmetric padding": (
        [(2, 12, 24)], lambda m: lambda x: m.fold(x, [4, 6], 2, 1,
                                                  [1, 0, 0, 1])),
}


@pytest.mark.parametrize("name", list(FNS))
def test_function_matches_jax(name):
    shapes, bind = FNS[name]
    rng = np.random.default_rng(13)
    inputs = [rand(rng, *s) for s in shapes]

    class J:     # the JAX functions' pure bodies, by name
        def __getattr__(self, op):
            return getattr(jops, op).raw

    check_fn(bind(J()), bind(TF), inputs)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align", [True, False])
def test_grid_sample_matches_jax(mode, padding_mode, align):
    rng = np.random.default_rng(14)
    x = rand(rng, 2, 3, 5, 6)
    grid = rng.uniform(-1.3, 1.3, (2, 4, 3, 2)).astype(np.float32)
    kw = dict(mode=mode, padding_mode=padding_mode, align_corners=align)
    check_fn(lambda x, g: jops.grid_sample.raw(x, g, **kw),
             lambda x, g: TF.grid_sample(x, g, **kw), [x, grid],
             grads=mode == "bilinear")


def test_index_functions_match_jax():
    ids = np.array([[0, 3, 2], [4, 1, 7]], np.int64)
    np.testing.assert_array_equal(
        TF.one_hot(torch.from_numpy(ids), 5).numpy(),
        np.asarray(jcreation.one_hot.raw(jnp.asarray(ids), 5)))
    assert TF.one_hot(torch.from_numpy(ids), 5).dtype == torch.float32
    lens = np.array([2, 0, 4], np.int64)
    for maxlen, dt in ((None, "int64"), (6, "float32")):
        np.testing.assert_array_equal(
            TF.sequence_mask(torch.from_numpy(lens), maxlen, dt).numpy(),
            np.asarray(JF.sequence_mask(jpaddle.to_tensor(lens), maxlen,
                                        dt).numpy()))
    x = rand(np.random.default_rng(15), 3, 4, 5)
    for p, axis in ((2, 1), (1, -1), (3, 0)):
        close(TF.normalize(torch.from_numpy(x), p, axis).numpy(),
              np.asarray(JF.normalize(JTensor(x), p, axis).numpy()),
              FWD_TOL, f"normalize p={p}")
    w = rand(np.random.default_rng(16), 8, 3)
    check_fn(lambda w: jops.embedding.raw(jnp.asarray(ids), w, 3),
             lambda w: TF.embedding(torch.from_numpy(ids), w, 3), [w])
    # sparse=True: the same gradient, as a sparse row gradient
    tw = torch.tensor(w, requires_grad=True)
    TF.embedding(torch.from_numpy(ids), tw, None, True).sum().backward()
    assert tw.grad.is_sparse
    np.testing.assert_array_equal(
        tw.grad.to_dense().numpy(),
        np.asarray(jax.grad(lambda w: jops.embedding.raw(
            jnp.asarray(ids), w).sum())(jnp.asarray(w))))


def test_arguments_the_reference_ignores_are_refused():
    for make in (lambda: tnn.PixelShuffle(2, "NHWC"),
                 lambda: tnn.PixelUnshuffle(2, "NHWC"),
                 lambda: tnn.ChannelShuffle(2, "NHWC"),
                 lambda: tnn.UpsamplingBilinear2D(2, data_format="NHWC"),
                 lambda: TF.pixel_shuffle(torch.zeros(1, 4, 2, 2), 2,
                                          "NHWC")):
        with pytest.raises(NotImplementedError, match="ignores it"):
            make()


def test_alignment_need_weights_and_cache_the_reference_ignores_are_refused():
    """C9: ``align_corners=True`` and a linear mode's ``align_mode=1``
    (the JAX resize reads neither), ``MultiHeadAttention(need_weights=
    True)`` and a ``cache=`` on the encoder and decoder layers and stacks
    are refused; their defaults run."""
    x = torch.zeros(1, 1, 4, 4)
    for make in (
            lambda: TF.interpolate(x, (7, 7), mode="bilinear",
                                   align_corners=True),
            lambda: TF.interpolate(x, (7, 7), mode="linear", align_mode=1),
            lambda: TF.upsample(x, (7, 7), mode="bilinear",
                                align_corners=True),
            lambda: tnn.Upsample((7, 7), None, "bilinear", True),
            lambda: tnn.Upsample((7, 7), None, "bilinear", align_mode=1),
            lambda: tnn.MultiHeadAttention(8, 2, need_weights=True,
                                           device=CPU)):
        with pytest.raises(NotImplementedError, match="ignores it"):
            make()
    assert TF.interpolate(x, (7, 7), mode="nearest",
                          align_mode=1).shape == (1, 1, 7, 7)
    assert tnn.Upsample((7, 7), None, "bilinear", False, 0)(x).shape == \
        (1, 1, 7, 7)
    src = torch.zeros(2, 3, 8)
    enc = tnn.TransformerEncoderLayer(8, 2, 16, 0.0, device=CPU)
    dec = tnn.TransformerDecoderLayer(8, 2, 16, 0.0, device=CPU)
    stacks = (enc, tnn.TransformerEncoder(enc, 2), dec,
              tnn.TransformerDecoder(dec, 2))
    cache = tnn.MultiHeadAttention(8, 2, device=CPU).gen_cache(src)
    for layer in stacks:
        args = (src,) if layer in stacks[:2] else (src, src)
        assert layer(*args, cache=None).shape == (2, 3, 8)
        with pytest.raises(NotImplementedError, match="ignores it"):
            layer(*args, cache=cache)


@pytest.mark.parametrize("size,out", [((4, 6), (7, 9)), ((6, 8), (3, 5))])
def test_upsampling_bilinear_is_the_jax_half_pixel_resize(size, out):
    """``UpsamplingBilinear2D`` computes what the JAX layer computes: a
    half-pixel bilinear resize (anti-aliased when it shrinks), although
    the JAX layer passes ``align_corners=True``, which its
    ``interpolate`` ignores; not Paddle's corner-aligned resize."""
    x = rand(np.random.default_rng(18), 1, 2, *size)
    check_layer(jnn.UpsamplingBilinear2D(out), tnn.UpsamplingBilinear2D(out),
                [x])
    corner = torch.nn.functional.interpolate(
        torch.from_numpy(x), out, mode="bilinear", align_corners=True)
    got = tnn.UpsamplingBilinear2D(out)(torch.from_numpy(x))
    assert float((got - corner).abs().max()) > 0.05


@pytest.mark.parametrize("op", ["leaky_relu", "tanh", "pad", "elu"])
def test_bf16_under_o2_matches_jax(op):
    x = rand(np.random.default_rng(17), 2, 3, 4, 5, scale=2.0)
    calls = {"leaky_relu": ((jact.leaky_relu, tact.leaky_relu), (0.2,)),
             "tanh": ((jact.tanh, tact.tanh), ()),
             "elu": ((jact.elu, tact.elu), (1.0,)),
             "pad": ((jmanip.pad, TF.pad), ([1, 1, 2, 2], "reflect"))}
    (jfn, tfn), args = calls[op]
    with jamp.auto_cast(level="O2", dtype="bfloat16"):
        jout = jfn(jpaddle.to_tensor(x), *args)
    with tamp.auto_cast(level="O2", dtype="bfloat16"):
        tout = tfn(torch.from_numpy(x), *args)
    assert tout.dtype == torch.bfloat16
    close(tout.float().numpy(), np.asarray(jout.numpy(), np.float32),
          BF16_TOL, op)
