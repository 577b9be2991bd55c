"""``nn/transformer.py`` and the composed masked attention of the PyTorch
port against the JAX package, and the translation model of
``chip_smoke.py`` (PaddleNLP's ``TransformerModel`` on the port's
layers) against the same model on the JAX package.

Weights cross by structured name (``Layer.set_state_dict``); the
stacks' cloned layers are redrawn on each side from its own generator,
so nothing is compared before the carry-over.  Inputs come from numpy
seeds; dropout is 0 wherever two packages are compared (their bits come
from different generators).

Tolerances (fp32): forward 1e-5 x max(|ref|, 1), gradients 1e-4 x
max(|ref|, 1) (the same sums in another order; the port's attention
computes in fp32, the JAX one in the input's dtype, the same here);
bf16 O2 forward 5e-2 x max(|ref|, 1) (the JAX attention runs in bf16,
the port's in fp32); parameters after three ``fit`` steps 1e-4 x
max(|ref|, 1), losses 1e-5 relative.
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.hapi.callbacks import LRSchedulerCallback as JLRCallback
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import nn_ops as jops
from paddle_tpu.tensor import Tensor as JTensor

import chip_smoke
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.hapi.callbacks import LRSchedulerCallback
from paddle_tpu_torch.nn.transformer import _clone_layer
from paddle_tpu_torch.ops import nn_ops as tops
from torch_parity_helpers import torch_one_thread  # noqa: F401

CPU = "cpu"
FWD, GRAD, BF16, PARAM = 1e-5, 1e-4, 5e-2, 1e-4
DELTA = 2e-2   # x the largest change of a leaf over three Noam steps
SMALL = dict(vocab=64, d_model=32, n_head=4, num_layers=2, d_inner=64,
             dropout=0.0, max_length=64)


def _close(got, ref, tol, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale,
                               err_msg=what)


def _carry(jlayer, layer):
    state = {k: np.asarray(v.numpy()) for k, v in jlayer.state_dict().items()}
    missing, unexpected = layer.set_state_dict(state)
    assert not missing and not unexpected, (missing, unexpected)
    return layer


def _grads_both(jlayer, layer, jout, tout, seed=0):
    """Every parameter's gradient of ``sum(out * g)`` in both packages,
    compared by name."""
    g = np.random.default_rng(seed).standard_normal(
        tuple(jout.shape)).astype(np.float32)
    (jout * jpaddle.to_tensor(g)).sum().backward()
    (tout * torch.from_numpy(g)).sum().backward()
    jp = dict(jlayer.named_parameters())
    for n, p in layer.named_parameters():
        _close(p.grad.numpy(), np.asarray(jp[n].grad.numpy()), GRAD, n)


class JTransformerModel(jnn.Layer):
    """``chip_smoke.slice19_models()["TransformerModel"]`` on the JAX
    package's layers."""

    def __init__(self, vocab, d_model, n_head, num_layers, d_inner, dropout,
                 max_length, pad_id=0):
        super().__init__()
        self.d_model, self.pad_id, self.dropout = d_model, pad_id, dropout
        self.word_embedding = jnn.Embedding(
            vocab, d_model, padding_idx=pad_id,
            weight_attr=jnn.initializer.Normal(0.0, d_model ** -0.5))
        self.register_buffer("pos_table", JTensor(
            chip_smoke.sinusoid_table(max_length, d_model)),
            persistable=False)
        self.transformer = jnn.Transformer(
            d_model, n_head, num_layers, num_layers, d_inner, dropout,
            "relu", normalize_before=True)

    def embed(self, ids):
        pos = jpaddle.cast(ids != self.pad_id, "int64") * jpaddle.arange(
            ids.shape[1])
        out = self.word_embedding(ids) * self.d_model ** 0.5 + \
            JF.embedding(pos, self.pos_table)
        return JF.dropout(out, p=self.dropout, training=self.training)

    def src_bias(self, src):
        bias = jpaddle.cast(src == self.pad_id, "float32") * -1e9
        return jpaddle.unsqueeze(bias, [1, 2])

    def logits(self, dec):
        return jpaddle.matmul(dec, self.word_embedding.weight,
                              transpose_y=True)

    def forward(self, src, tgt):
        bias = self.src_bias(src)
        causal = jnn.Transformer.generate_square_subsequent_mask(
            tgt.shape[1])
        dec = self.transformer(self.embed(src), self.embed(tgt),
                               src_mask=bias, tgt_mask=causal,
                               memory_mask=bias)
        return self.logits(dec)

    def greedy(self, src, max_len):
        bias = self.src_bias(src)
        memory = self.transformer.encoder(self.embed(src), src_mask=bias)
        b = src.shape[0]
        seq = np.zeros((b, 1), np.int64)
        done = np.zeros(b, bool)
        for _ in range(max_len):
            causal = jnn.Transformer.generate_square_subsequent_mask(
                seq.shape[1])
            dec = self.transformer.decoder(self.embed(jpaddle.to_tensor(
                seq)), memory, tgt_mask=causal, memory_mask=bias)
            last = np.asarray(self.logits(dec).numpy())[:, -1]
            nxt = np.where(done, 0, last.argmax(-1))
            done |= nxt == chip_smoke.NMT_EOS
            seq = np.concatenate([seq, nxt[:, None]], 1)
        return seq[:, 1:]


class JCriterion(jnn.Layer):
    def __init__(self, vocab, eps=0.1):
        super().__init__()
        self.vocab, self.eps = vocab, eps

    def forward(self, logits, label):
        soft = JF.one_hot(label, self.vocab) * (1 - self.eps) + \
            self.eps / self.vocab
        cost = JF.cross_entropy(logits, soft, soft_label=True,
                                reduction="none")
        w = jpaddle.cast(label != 0, "float32")
        return (cost * w).sum() / w.sum()


def _models(seed=0):
    jpaddle.seed(seed)
    jnet = JTransformerModel(**SMALL)
    # the JAX clones share their 1-D parameters' arrays with the first
    # layer (a deep copy of an immutable array), which the JAX fit then
    # donates twice: give each parameter an array of its own
    jnet.set_state_dict({k: np.array(v.numpy())
                         for k, v in jnet.state_dict().items()})
    net = chip_smoke.slice19_models()["TransformerModel"](**SMALL,
                                                          device=CPU)
    return jnet, _carry(jnet, net)


def _batch(seed, b=3, s=7):
    return chip_smoke.nmt_batch(b, s, seed, vocab=SMALL["vocab"])


# -- mirrors of tests/test_nn.py ----------------------------------------------


def test_multihead_attention():
    mha = tnn.MultiHeadAttention(16, 4, device=CPU)
    x = torch.randn(2, 6, 16)
    out = mha(x, x, x)
    assert tuple(out.shape) == (2, 6, 16)
    out.sum().backward()
    assert mha.q_proj.weight.grad is not None


def test_transformer_encoder():
    layer = tnn.TransformerEncoderLayer(16, 4, 32, dropout=0.0, device=CPU)
    enc = tnn.TransformerEncoder(layer, 2)
    assert tuple(enc(torch.randn(2, 5, 16)).shape) == (2, 5, 16)


# -- the attention and its masks ----------------------------------------------


def _mask(kind, rng, b, sq, sk):
    if kind == "none":
        return None
    if kind == "bool":
        keep = rng.random((b, 1, sq, sk)) > 0.3
        keep[..., 0] = True
        return keep
    if kind == "additive [B,1,1,S]":
        bias = np.zeros((b, 1, 1, sk), np.float32)
        bias[:, :, :, sk - 2:] = -1e9
        return bias
    causal = np.triu(np.full((sq, sk), -np.inf, np.float32), 1)
    if kind == "-inf [S,S]":
        return causal
    bias = np.zeros((b, 1, 1, sk), np.float32)
    bias[1, :, :, sk - 2:] = -1e9
    return causal + bias                      # -inf causal + -1e9 padding


MASKS = ["none", "bool", "additive [B,1,1,S]", "-inf [S,S]",
         "-inf [S,S] + -1e9 [B,1,1,S]"]


@pytest.mark.parametrize("kind", MASKS)
def test_sdpa_masks_match_jax(kind):
    rng = np.random.default_rng(MASKS.index(kind))
    b, s, h, d = 2, 6, 3, 4
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    mask = _mask(kind, rng, b, s, s)
    jm = None if mask is None else jpaddle.to_tensor(mask)
    tm = None if mask is None else torch.tensor(mask)
    jin = [jpaddle.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
    tin = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    jout = jops.scaled_dot_product_attention(*jin, attn_mask=jm)
    tout = tops.scaled_dot_product_attention(*tin, attn_mask=tm)
    _close(tout.detach().numpy(), np.asarray(jout.numpy()), FWD, "out")
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)
    (jout * jpaddle.to_tensor(g)).sum().backward()
    (tout * torch.tensor(g)).sum().backward()
    for i, (j, t) in enumerate(zip(jin, tin)):
        _close(t.grad.numpy(), np.asarray(j.grad.numpy()), GRAD, f"d{i}")


def test_sdpa_row_masked_everywhere_is_nan_in_both():
    q = np.ones((1, 2, 1, 4), np.float32)
    mask = np.array([[0.0, 0.0], [-np.inf, -np.inf]], np.float32)
    jout = np.asarray(jops.scaled_dot_product_attention(
        *(jpaddle.to_tensor(q),) * 3, attn_mask=jpaddle.to_tensor(mask))
        .numpy())
    tout = tops.scaled_dot_product_attention(
        *(torch.tensor(q),) * 3, attn_mask=torch.tensor(mask)).numpy()
    assert np.isnan(jout[0, 1]).all() and np.isnan(tout[0, 1]).all()
    np.testing.assert_allclose(tout[0, 0], jout[0, 0], rtol=1e-6)


def test_sdpa_dropout_while_training():
    """With dropout the port's attention is the no-dropout softmax with
    the generator's keep mask applied and scaled: the same draw
    reproduces it, and eval (``training=False``) draws nothing."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(rng.standard_normal((2, 5, 2, 4)).astype(
        np.float32)) for _ in range(3))
    mask = torch.tensor(_mask("additive [B,1,1,S]", rng, 2, 5, 5))
    gen = torch.Generator().manual_seed(7)
    out = tops.scaled_dot_product_attention(q, k, v, mask, 0.25,
                                            generator=gen)
    gen.manual_seed(7)
    keep = torch.rand((2, 2, 5, 5), generator=gen) < 0.75
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / 2.0 + mask
    probs = torch.where(keep, torch.softmax(logits, -1) / 0.75, 0.0)
    want = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    plain = tops.scaled_dot_product_attention(q, k, v, mask)
    assert torch.equal(tops.scaled_dot_product_attention(
        q, k, v, mask, 0.25, training=False, generator=gen), plain)


@pytest.mark.parametrize("case", ["self", "kdim/vdim", "cache"])
def test_multihead_attention_matches_jax(case):
    rng = np.random.default_rng(1)
    b, sq, sk, e = 2, 5, 7, 16
    kv = dict(kdim=12, vdim=8) if case == "kdim/vdim" else {}
    jpaddle.seed(0)
    jmha = jnn.MultiHeadAttention(e, 4, **kv)
    mha = _carry(jmha, tnn.MultiHeadAttention(e, 4, **kv, device=CPU))
    q = rng.standard_normal((b, sq, e)).astype(np.float32)
    if case == "kdim/vdim":
        key = rng.standard_normal((b, sk, 12)).astype(np.float32)
        val = rng.standard_normal((b, sk, 8)).astype(np.float32)
        mask = _mask("bool", rng, b, sq, sk)
        jout = jmha(*(jpaddle.to_tensor(a) for a in (q, key, val, mask)))
        tout = mha(*(torch.tensor(a) for a in (q, key, val, mask)))
    elif case == "self":
        mask = _mask("-inf [S,S] + -1e9 [B,1,1,S]", rng, b, sq, sq)
        jout = jmha(jpaddle.to_tensor(q), attn_mask=jpaddle.to_tensor(mask))
        tout = mha(torch.tensor(q), attn_mask=torch.tensor(mask))
    else:
        past = rng.standard_normal((b, 3, 4, 4)).astype(np.float32)
        jc = jnn.MultiHeadAttention.Cache(jpaddle.to_tensor(past),
                                          jpaddle.to_tensor(past * 2))
        tc = tnn.MultiHeadAttention.Cache(torch.tensor(past),
                                          torch.tensor(past * 2))
        jout, jc = jmha(jpaddle.to_tensor(q), cache=jc)
        tout, tc = mha(torch.tensor(q), cache=tc)
        _close(tc.k.detach().numpy(), np.asarray(jc.k.numpy()), FWD, "k")
        _close(tc.v.detach().numpy(), np.asarray(jc.v.numpy()), FWD, "v")
    _close(tout.detach().numpy(), np.asarray(jout.numpy()), FWD, "out")
    _grads_both(jmha, mha, jout, tout)


def test_cache_one_step_at_a_time_equals_the_causal_call():
    torch.manual_seed(0)
    mha = tnn.MultiHeadAttention(16, 4, device=CPU)
    x = torch.randn(2, 6, 16)
    full = mha(x, attn_mask=tnn.Transformer.generate_square_subsequent_mask(
        6, device=CPU))
    cache, outs = mha.gen_cache(x), []
    assert tuple(cache.k.shape) == (2, 0, 4, 4)
    for t in range(6):
        o, cache = mha(x[:, t:t + 1], cache=cache)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=0, atol=1e-6)


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_layers_match_jax(kind, normalize_before):
    rng = np.random.default_rng(2)
    jpaddle.seed(1)
    if kind == "encoder":
        jl = jnn.TransformerEncoderLayer(16, 4, 32, dropout=0.0,
                                         normalize_before=normalize_before)
        tl = tnn.TransformerEncoderLayer(16, 4, 32, dropout=0.0,
                                         normalize_before=normalize_before,
                                         device=CPU)
    else:
        jl = jnn.TransformerDecoderLayer(16, 4, 32, dropout=0.0,
                                         activation="gelu",
                                         normalize_before=normalize_before)
        tl = tnn.TransformerDecoderLayer(16, 4, 32, dropout=0.0,
                                         activation="gelu",
                                         normalize_before=normalize_before,
                                         device=CPU)
    _carry(jl, tl)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    mask = _mask("-inf [S,S] + -1e9 [B,1,1,S]", rng, 2, 5, 5)
    if kind == "encoder":
        jout = jl(jpaddle.to_tensor(x), jpaddle.to_tensor(mask))
        tout = tl(torch.tensor(x), torch.tensor(mask))
    else:
        mem = rng.standard_normal((2, 4, 16)).astype(np.float32)
        mbias = _mask("additive [B,1,1,S]", rng, 2, 5, 4)
        jout = jl(*(jpaddle.to_tensor(a) for a in (x, mem, mask, mbias)))
        tout = tl(*(torch.tensor(a) for a in (x, mem, mask, mbias)))
    _close(tout.detach().numpy(), np.asarray(jout.numpy()), FWD, "out")
    _grads_both(jl, tl, jout, tout)


# -- nn.Transformer -----------------------------------------------------------


def _transformer_pair(seed=0):
    jpaddle.seed(seed)
    kw = dict(d_model=32, nhead=4, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=64, dropout=0.0,
              normalize_before=True)
    jt = jnn.Transformer(**kw)
    return jt, _carry(jt, tnn.Transformer(**kw, device=CPU))


def _transformer_inputs(rng):
    src = rng.standard_normal((2, 6, 32)).astype(np.float32)
    tgt = rng.standard_normal((2, 5, 32)).astype(np.float32)
    bias = _mask("additive [B,1,1,S]", rng, 2, 1, 6)
    causal = np.triu(np.full((5, 5), -np.inf, np.float32), 1)
    return src, tgt, bias, causal


def test_transformer_matches_jax_fp32():
    rng = np.random.default_rng(4)
    jt, tt = _transformer_pair()
    assert list(tt.state_dict()) == list(jt.state_dict())
    src, tgt, bias, causal = _transformer_inputs(rng)
    jout = jt(*(jpaddle.to_tensor(a) for a in (src, tgt, bias, causal)),
              memory_mask=jpaddle.to_tensor(bias))
    tout = tt(*(torch.tensor(a) for a in (src, tgt, bias, causal)),
              memory_mask=torch.tensor(bias))
    _close(tout.detach().numpy(), np.asarray(jout.numpy()), FWD, "out")
    _grads_both(jt, tt, jout, tout)


def test_transformer_matches_jax_bf16_o2():
    rng = np.random.default_rng(5)
    jt, tt = _transformer_pair()
    jpaddle.amp.decorate(jt, level="O2", dtype="bfloat16")
    tpaddle.amp.decorate(tt, level="O2", dtype="bfloat16")
    src, tgt, bias, causal = _transformer_inputs(rng)
    with jpaddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        jout = jt(*(jpaddle.to_tensor(a) for a in (src, tgt, bias, causal)),
                  memory_mask=jpaddle.to_tensor(bias))
    with tpaddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        tout = tt(*(torch.tensor(a) for a in (src, tgt, bias, causal)),
                  memory_mask=torch.tensor(bias))
    _close(tout.detach().float().numpy(),
           np.asarray(jout.astype("float32").numpy()), BF16, "out")


def test_square_subsequent_mask_and_clone_redraw():
    m = tnn.Transformer.generate_square_subsequent_mask(4, device=CPU)
    want = np.asarray(jnn.Transformer.generate_square_subsequent_mask(
        4).numpy())
    np.testing.assert_array_equal(m.numpy(), want)
    tpaddle.seed(0)
    layer = tnn.TransformerEncoderLayer(64, 4, 256, device=CPU)
    clone = _clone_layer(layer)
    for (n, p), (_, c) in zip(layer.named_parameters(),
                              clone.named_parameters()):
        assert c is not p and c.name != p.name
        if p.ndim >= 2:
            std = math.sqrt(2.0 / (math.prod(p.shape[:-1]) + p.shape[-1]))
            assert not torch.equal(c, p)
            assert abs(float(c.detach().std()) / std - 1) < 0.1, n
        else:
            assert torch.equal(c, p)


# -- the translation model (path a and b) -------------------------------------


def test_translation_forward_and_loss_match_jax():
    jnet, net = _models()
    src, tgt_in, label = _batch(10)
    crit = chip_smoke.slice19_models()["TransformerCriterion"](
        SMALL["vocab"])
    jlogits = jnet(jpaddle.to_tensor(src), jpaddle.to_tensor(tgt_in))
    logits = net(torch.tensor(src), torch.tensor(tgt_in))
    _close(logits.detach().numpy(), np.asarray(jlogits.numpy()), FWD,
           "logits")
    jloss = JCriterion(SMALL["vocab"])(jlogits, jpaddle.to_tensor(label))
    loss = crit(logits, torch.tensor(label))
    _close(loss.detach().numpy(), np.asarray(jloss.numpy()), FWD, "loss")
    jloss.backward()
    loss.backward()
    jp = dict(jnet.named_parameters())
    for n, p in net.named_parameters():
        _close(p.grad.numpy(), np.asarray(jp[n].grad.numpy()), GRAD, n)


def test_translation_fit_matches_jax():
    """Three ``Model.fit`` steps, Adam(0.9, 0.997, 1e-9) under
    NoamDecay(d_model, 4000, 2.0) stepped by step, on both packages."""
    jnet, net = _models(3)
    m = chip_smoke.slice19_models()
    data = [_batch(20 + i) for i in range(3)]
    jsched = joptimizer.lr.NoamDecay(SMALL["d_model"], 4000, 2.0)
    jm = jpaddle.Model(jnet)
    jm.prepare(joptimizer.Adam(learning_rate=jsched, beta1=0.9, beta2=0.997,
                               epsilon=1e-9, parameters=jnet.parameters()),
               JCriterion(SMALL["vocab"]))
    tsched = tpaddle.optimizer.lr.NoamDecay(SMALL["d_model"], 4000, 2.0)
    tm = tpaddle.Model(net, device=CPU)
    tm.prepare(tpaddle.optimizer.Adam(
        learning_rate=tsched, beta1=0.9, beta2=0.997, epsilon=1e-9,
        parameters=net.parameters()),
        m["TransformerCriterion"](SMALL["vocab"]))
    jl, tl = [], []

    def keep(into):
        class K(tpaddle.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                into.append(float(logs["loss"][0]))
        return K()

    class JK(jpaddle.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            jl.append(float(logs["loss"][0]))

    jm.fit(data, epochs=1, verbose=0,
           callbacks=[JK(), JLRCallback(by_step=True, by_epoch=False)])
    tm.fit(data, epochs=1, verbose=0,
           callbacks=[keep(tl), LRSchedulerCallback(by_step=True,
                                                    by_epoch=False)])
    assert tm._fold == 1
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tsched.last_epoch == jsched.last_epoch == 3
    jstate = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    moved = 0.0
    for k, v in net.state_dict().items():
        _close(v.numpy(), jstate[k], PARAM, k)
    start = _models(3)[1].state_dict()
    moved = max(float((v - start[k]).abs().max())
                for k, v in net.state_dict().items())
    assert moved > 0
    # Noam's rate is ~1e-6 here, so every parameter moves by less than
    # PARAM: the Adam moments carry the three gradients (1e-5 of each
    # leaf's largest), and each leaf's change over the three steps is
    # held to DELTA of the JAX change's largest (a 6e-6 change of an
    # fp32 weight of ~0.1 is known to ~1e-3 of itself).  The key
    # biases' gradients are rounding noise (softmax ignores a shift of
    # a row), which Adam turns into whole steps: their moments are held
    # against the model's largest moment, their changes not at all.
    jmom = jm._optimizer._opt_state_tree          # by structured name
    tmom = {k: tm._optimizer._state[i] for i, (k, _) in
            enumerate(net.named_parameters())}
    assert set(jmom) == set(tmom) and len(tmom) > 20
    for m in ("moment1", "moment2"):
        top = max(float(np.abs(np.asarray(st[m])).max())
                  for st in jmom.values())
        for k, st in tmom.items():
            ref = np.asarray(jmom[k][m])
            scale = top if k.endswith("k_proj.bias") else \
                float(np.abs(ref).max())
            np.testing.assert_allclose(st[m].numpy(), ref, rtol=0,
                                       atol=FWD * scale, err_msg=f"{k} {m}")
    jstart = _models(3)[0].state_dict()
    for k, v in net.state_dict().items():
        if k.endswith("k_proj.bias"):
            continue
        change = np.asarray(jstate[k]) - np.asarray(jstart[k].numpy())
        np.testing.assert_allclose(
            (v - start[k]).numpy(), change, rtol=0,
            atol=DELTA * float(np.abs(change).max()), err_msg=k)


def test_greedy_tokens_match_jax():
    jnet, net = _models(4)
    jnet.eval()
    net.eval()
    src = _batch(30, b=4, s=6)[0]
    jtok = jnet.greedy(jpaddle.to_tensor(src), 8)
    tok, logits = net.greedy(torch.tensor(src), 8)
    # a token may differ only where the two best logits tie within 1e-5
    diff = tok.numpy() != jtok
    if diff.any():
        top = logits.topk(2, -1).values
        gap = (top[..., 0] - top[..., 1]).numpy()
        assert (gap[diff] <= chip_smoke.NMT_GAP).all()
    assert not diff[:, :1].any()
