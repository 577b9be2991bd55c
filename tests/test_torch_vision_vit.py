"""ViT of the PyTorch port against the JAX package, with the operators it
added to the port (``gelu``, ``interpolate``, ``reshape`` /
``transpose`` / ``expand`` / ``concat``, ``LayerList``,
``TruncatedNormal``).

The model is ``VisionTransformer(img_size=32, patch_size=8,
embed_dim=64, depth=2, num_heads=4, num_classes=4)``, built in the JAX
package (``paddle.seed(0)``) and carried to the port through
``vision_state_dict_from_jax``; both see the same numpy images.  Each
test builds its own JAX reference (no shared fixture: under xdist a
module fixture is rebuilt on every worker that draws a test of the
file).

Sizes: 32 is the build grid (4x4 patches), 48 grows it to 6x6 and 24
shrinks it to 3x3.  ``jax.image.resize`` anti-aliases when it shrinks,
so only the shrinking grid tells an anti-aliased resize from a plain
bilinear one (``F.interpolate(antialias=False)`` is 0.8 off there on a
14 -> 12 grid).

Tolerances: fp32 logits and tables 1e-5 x max(|ref|, 1) (the same sums
in another order); three AdamW steps: losses 1e-5 relative, gradients
and parameters 5e-4 x max(|ref|, 1) (the flash tolerances; the key
bias, whose gradient is rounding noise, within 4 lr); bf16 O2
forward 5e-2 x max(|ref|, 1): the port's composed attention computes
in fp32 where the JAX one computes in bf16 (``ROADMAP.md`` queue C).
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.nn import functional_call as JF
from paddle_tpu.ops import activation as JA
from paddle_tpu.ops import manipulation as JMAN
from paddle_tpu.ops import nn_ops as JN
from paddle_tpu.tensor import Tensor as JTensor
from paddle_tpu.vision import models as JM

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.ops import activation as TA
from paddle_tpu_torch.ops import manipulation as TMAN
from paddle_tpu_torch.ops import nn_ops as TN
from paddle_tpu_torch.vision import models as TM
from torch_parity_helpers import torch_one_thread  # noqa: F401

FWD_TOL = 1e-5
GRAD_TOL = 5e-4
O2_TOL = 5e-2
CFG = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
           num_classes=4)
B = 2
LR = 1e-3


def _close(got, ref, tol, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    scale = max(float(np.abs(ref).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale,
                               err_msg=what)


def _pair():
    jpaddle.seed(0)
    jnet = JM.VisionTransformer(**CFG)
    net = TM.VisionTransformer(**CFG, device="cpu")
    net.load_state_dict(TM.vision_state_dict_from_jax(jnet, net))
    return jnet, net


def _images(size, seed=0, n=B):
    return np.random.default_rng(seed).random((n, 3, size, size)).astype(
        np.float32)


@pytest.mark.parametrize("size", [32, 48, 24])
def test_logits_match_jax_at_the_build_a_larger_and_a_smaller_grid(size):
    jnet, net = _pair()
    jnet.eval()
    net.eval()
    x = _images(size)
    ref = np.asarray(jnet(JTensor(x)).numpy())
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert tuple(got.shape) == (B, 4)
    _close(got.numpy(), ref, FWD_TOL, f"logits at {size}")


def test_pos_embed_for_identity_refusal_and_resized_tables():
    jnet, net = _pair()
    assert net._pos_embed_for(16) is net.pos_embed
    with pytest.raises(ValueError, match="non-square"):
        net._pos_embed_for(20)
    for n in (9, 36, 4):
        ref = np.asarray(jnet._pos_embed_for(n).numpy())
        with torch.no_grad():
            got = net._pos_embed_for(n)
        _close(got.numpy(), ref, FWD_TOL, f"table for {n} patches")


def _jax_steps(jnet, batches):
    """AdamW steps of ``jnet`` as ``bench.py``'s ``bench_vit`` takes
    them, one jitted step per shape: the losses, the first step's
    gradients and the parameters at the end."""
    opt = joptimizer.AdamW(learning_rate=LR, parameters=jnet.parameters())
    lossf = jnn.CrossEntropyLoss()
    params = JF.param_dict(jnet)
    frozen, buffers = JF.frozen_dict(jnet), JF.buffer_dict(jnet)
    state = opt.init_state_tree(params)

    @jax.jit
    def step(p, st, imgs, labels):
        def loss_fn(pp):
            with JF.bind(jnet, pp, buffers, frozen):
                return lossf(jnet(JTensor(imgs)), JTensor(labels))._value
        loss, grads = jax.value_and_grad(loss_fn)(p)
        new_p, new_s = opt.apply_gradients_tree(p, grads, st, LR)
        return loss, grads, new_p, new_s

    losses, first = [], None
    for x, y in batches:
        loss, grads, params, state = step(params, state, x, y)
        losses.append(float(loss))
        first = first if first is not None else \
            {k: np.asarray(v) for k, v in grads.items()}
    return losses, first, {k: np.asarray(v) for k, v in params.items()}


def test_three_adamw_steps_across_buckets_match_jax():
    """Steps at 32, 24 and 32: the shrinking resize is differentiated
    too.  The port trains through ``Model.fit`` (``steps_per_dispatch=1``:
    the fold engine's step body, run eagerly on the CPU)."""
    jnet, net = _pair()
    rng = np.random.default_rng(1)
    batches = [(_images(s, seed=i), rng.integers(0, 4, (B,)).astype(np.int64))
               for i, s in enumerate((32, 24, 32))]
    jlosses, jgrads, jparams = _jax_steps(jnet, batches)

    crit = tnn.CrossEntropyLoss()
    net.train()
    x0, y0 = (torch.from_numpy(v) for v in batches[0])
    crit(net(x0), y0).backward()
    first_grads = {}
    for name, p in net.named_parameters():
        first_grads[name] = p.grad.numpy().copy()
        _close(first_grads[name], jgrads[name], GRAD_TOL, f"grad {name}")
        p.grad = None

    opt = tpaddle.optimizer.AdamW(LR, parameters=net.parameters())
    model = tpaddle.Model(net, device="cpu")
    model.prepare(opt, crit)
    losses = []

    class Keep(tpaddle.hapi.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(float(logs["loss"][0]))

    model.fit([(torch.from_numpy(x), torch.from_numpy(y))
               for x, y in batches], epochs=1, verbose=0,
              callbacks=[Keep()], steps_per_dispatch=1)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert model.compile_stats() == {"graphs": 2, "captures": 2}
    for name, p in net.named_parameters():
        got, ref = p.detach().numpy(), jparams[name]
        if name.endswith("attn.qkv.bias"):
            # the key bias shifts every logit of a query's row alike, so
            # softmax makes its gradient 0: both packages' are rounding
            # noise (~1e-8), which AdamW's m / sqrt(v) turns into steps
            # of up to lr with the noise's sign (ROADMAP.md queue C,
            # "Adam on noise"): those elements within a few lr
            keys = np.arange(CFG["embed_dim"], 2 * CFG["embed_dim"])
            for g in (jgrads[name][keys], first_grads[name][keys]):
                assert np.abs(g).max() < 1e-6, (name, np.abs(g).max())
            np.testing.assert_allclose(got[keys], ref[keys], rtol=0,
                                       atol=4 * LR, err_msg=name)
            got, ref = np.delete(got, keys), np.delete(ref, keys)
        _close(got, ref, GRAD_TOL, f"param {name}")


@pytest.mark.parametrize("size", [32, 24])
def test_bf16_o2_forward_matches_jax(size):
    jnet, net = _pair()
    jnet.eval()
    net.eval()
    jamp.decorate(jnet, level="O2", dtype="bfloat16")
    tpaddle.amp.decorate(net, level="O2", dtype="bfloat16")
    assert net.pos_embed.dtype == net.cls_token.dtype == torch.bfloat16
    assert net.norm.weight.dtype == net.blocks[0].norm1.weight.dtype \
        == torch.float32
    x = _images(size)
    with jamp.auto_cast(level="O2", dtype="bfloat16"):
        ref = np.asarray(jnet(JTensor(x)).numpy().astype(np.float32))
    with torch.no_grad(), tpaddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        got = net(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), ref, O2_TOL, f"O2 logits at {size}")


@pytest.mark.parametrize("mode,src,dst", [
    ("bilinear", (14, 14), (12, 12)), ("bilinear", (4, 5), (6, 3)),
    ("bilinear", (8, 8), (4, 4)), ("bicubic", (9, 7), (4, 11)),
    ("nearest", (5, 5), (10, 10)), ("nearest", (9, 4), (4, 7)),
    ("area", (6, 6), (4, 4))])
def test_interpolate_matches_jax_image_resize(mode, src, dst):
    x = np.random.default_rng(3).standard_normal((2, 3) + src).astype(
        np.float32)
    ref = np.asarray(JN.interpolate(JTensor(x), size=list(dst),
                                    mode=mode).numpy())
    got = TN.interpolate(torch.from_numpy(x), size=list(dst), mode=mode)
    _close(got.numpy(), ref, FWD_TOL, f"{mode} {src} -> {dst}")
    nhwc = TN.interpolate(torch.from_numpy(x).permute(0, 2, 3, 1),
                          size=list(dst), mode=mode, data_format="NHWC")
    np.testing.assert_array_equal(nhwc.permute(0, 3, 1, 2).numpy(),
                                  got.numpy())


def test_interpolate_bf16_scale_factor_and_refusal():
    """bf16 in, bf16 out with the weights cast first, as JAX casts them;
    ``scale_factor`` sizes; the nearest x2 of CSPPAN is exact."""
    x = np.random.default_rng(4).standard_normal((1, 8, 14, 14)).astype(
        np.float32)
    ref = JN.interpolate(JTensor(jax.numpy.asarray(x, jax.numpy.bfloat16)),
                         size=[12, 12], mode="bilinear")
    got = TN.interpolate(torch.from_numpy(x).bfloat16(), size=[12, 12],
                         mode="bilinear")
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(ref.numpy(), np.float32), 1e-2,
           "bf16 resize")
    up = TN.upsample(torch.from_numpy(x), scale_factor=2, mode="nearest")
    np.testing.assert_array_equal(
        up.numpy(), np.asarray(JN.upsample(JTensor(x), scale_factor=2,
                                           mode="nearest").numpy()))
    with pytest.raises(NotImplementedError, match="lanczos3"):
        TN.interpolate(torch.from_numpy(x), size=[4, 4], mode="lanczos3")


def test_activations_and_shape_ops_match_jax():
    x = np.random.default_rng(5).standard_normal((2, 3, 4)).astype(
        np.float32)
    tx, jx = torch.from_numpy(x), JTensor(x)
    _close(TA.gelu(tx).numpy(), np.asarray(JA.gelu(jx).numpy()), 1e-6,
           "gelu")
    _close(TA.gelu(tx, approximate=True).numpy(),
           np.asarray(JA.gelu(jx, approximate=True).numpy()), 1e-6,
           "gelu tanh")
    _close(TA.silu(tx).numpy(), np.asarray(JA.silu(jx).numpy()), 1e-6, "silu")
    _close(tnn.GELU()(tx).numpy(), np.asarray(jnn.GELU()(jx).numpy()), 1e-6,
           "GELU")
    _close(tnn.Silu()(tx).numpy(), np.asarray(jnn.Silu()(jx).numpy()), 1e-6,
           "Silu")
    for got, ref in (
            (TMAN.reshape(tx, [3, -1]), JMAN.reshape(jx, [3, -1])),
            (TMAN.transpose(tx, [2, 0, 1]), JMAN.transpose(jx, [2, 0, 1])),
            (TMAN.expand(tx[:1], [2, 2, -1, 4]),
             JMAN.expand(JTensor(x[:1]), [2, 2, -1, 4])),
            (TMAN.concat([tx, tx * 2], axis=1),
             JMAN.concat([jx, JTensor(x * 2)], axis=1))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref.numpy()))


def test_layer_list_and_truncated_normal():
    layers = tnn.LayerList([tnn.Identity(), tnn.ReLU()])
    layers.append(tnn.GELU())
    assert len(layers) == 3 and isinstance(layers[-1], tnn.GELU)
    assert isinstance(layers[1:], tnn.LayerList) and len(layers[1:]) == 2
    assert [type(m).__name__ for m in layers] == ["Identity", "ReLU", "GELU"]
    holder = torch.nn.Module()
    holder.blocks = tnn.LayerList([tnn.Linear(2, 2, device="cpu")])
    assert set(holder.state_dict()) == {"blocks.0.weight", "blocks.0.bias"}
    init = tnn.initializer.TruncatedNormal(mean=1.0, std=0.02, a=-1.5, b=2.0)
    w = init((4096,), "cpu", torch.Generator().manual_seed(0))
    assert float(w.min()) >= 1.0 - 1.5 * 0.02
    assert float(w.max()) <= 1.0 + 2.0 * 0.02
    jpaddle.seed(0)
    ref = np.asarray(jnn.initializer.TruncatedNormal(
        mean=1.0, std=0.02, a=-1.5, b=2.0)((4096,), "float32"))
    assert abs(float(w.mean()) - ref.mean()) < 2e-3
    assert abs(float(w.std()) - ref.std()) < 2e-3
    p = tnn.initializer.create_parameter(
        [1, 3], default_initializer=init, device="cpu",
        generator=torch.Generator().manual_seed(0))
    assert isinstance(p, torch.nn.Parameter) and p.dtype == torch.float32
    bias = tnn.initializer.create_parameter([3], is_bias=True, device="cpu")
    assert float(bias.detach().abs().max()) == 0.0


def test_refusals_and_constructors():
    with pytest.raises(RuntimeError, match="pretrained"):
        TM.vit_b_16(pretrained=True, device="cpu")
    with pytest.raises(RuntimeError, match="pretrained"):
        TM.vit_l_16(pretrained=True, device="cpu")
    net = TM.vit_b_16(num_classes=0, img_size=32, device="cpu")
    assert not hasattr(net, "head") and len(net.blocks) == 12
    with torch.no_grad():
        out = net(torch.zeros(1, 3, 32, 32))
    assert tuple(out.shape) == (1, 5, 768)
