"""BERT/ERNIE of the PyTorch port against the JAX package.

A tiny BERT (2 layers, hidden 64, 4 heads of dim 16, vocab 256, 256
positions, dropout 0) is built in the JAX package; its weights carry
over to the port through ``bert_state_dict_from_jax`` and both
packages see the same numpy tokens and labels (15% of positions keep
their token as the MLM label, the rest -100).  Each comparison runs
twice: with the default flash configuration, and with the ``[B*H, S,
D]`` knobs on in both packages side by side (``PADDLE_TPU_FLASH_
NO_PACKED/HEADPACK=2/FUSED_BWD`` and the port's ``PADDLE_TORCH_*``
twins), where the JAX package runs ``_flash_kernel_hpack`` and
``_flash_bwd_fused_kernel`` in interpret mode over two 128-row blocks
(``PADDLE_TPU_FLASH_BQ=BK=128``, S=256) and the port the plain
versions of ``flash_fwd_hpack`` and ``flash_bwd_fused``.

Tolerances (fp32): as ``tests/test_torch_training.py`` states them for
GPT: 2e-5 on logits, loss and gradients (the same sums in another
order); after three AdamW ``Model.fit`` steps 2e-6 on 99.5% of the
parameters and 1e-3 on all (Adam moves parameters whose gradient is
rounding noise, such as the key bias, by up to ~lr per step).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.hapi.callbacks import Callback as JCallback
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops import pallas_ops

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.hapi.callbacks import Callback as TCallback
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import flash_attention_kernel as fk

TOL = 2e-5
PARAM_TOL = 2e-6
PARAM_BULK = 0.995
ADAM_NOISE_TOL = 1e-3
B, S, V = 2, 256, 256
TINY = dict(vocab_size=V, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=S, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
BH_KNOBS = {"PADDLE_TPU_FLASH_NO_PACKED": "1",
            "PADDLE_TPU_FLASH_HEADPACK": "2",
            "PADDLE_TPU_FLASH_FUSED_BWD": "1",
            "PADDLE_TORCH_FLASH_NO_PACKED": "1",
            "PADDLE_TORCH_FLASH_HEADPACK": "2",
            "PADDLE_TORCH_FLASH_FUSED_BWD": "1"}


def _interpret_kernels_healthy(monkeypatch):
    """The JAX package probes its flash kernel once per process and
    keeps the verdict; a probe first reached inside a traced train step
    fails and would send every later call to the composed form.  Probe
    eagerly here, in interpret mode, so the kernels run."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    pallas_ops._PALLAS_HEALTH.pop("ok", None)
    assert pallas_ops._pallas_healthy()


@pytest.fixture(params=["default", "bh knobs"])
def knobs(request, monkeypatch):
    _interpret_kernels_healthy(monkeypatch)
    monkeypatch.setenv("PADDLE_TPU_FLASH_BQ", "128")
    monkeypatch.setenv("PADDLE_TPU_FLASH_BK", "128")
    for name in BH_KNOBS:
        monkeypatch.delenv(name, raising=False)
    if request.param == "bh knobs":
        for name, value in BH_KNOBS.items():
            monkeypatch.setenv(name, value)
    return request.param


def _models(cls_name="BertForPretraining", seed=0, **kw):
    jpaddle.seed(seed)
    jnet = getattr(jbert, cls_name)(jbert.BertConfig(**TINY), **kw)
    net = getattr(tbert, cls_name)(tbert.BertConfig(**TINY), device="cpu",
                                   **kw)
    state = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    net.load_state_dict(tbert.bert_state_dict_from_jax(state, net))
    return jnet, net


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, V, (B, S)).astype(np.int64)
    labels = np.where(rng.random((B, S)) < 0.15, x, -100).astype(np.int64)
    nsp = rng.integers(0, 2, (B,)).astype(np.int64)
    return x, labels, nsp


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def test_carry_over_keeps_names_layout_and_the_tie():
    jnet, net = _models()
    jstate, tstate = jnet.state_dict(), net.state_dict()
    assert set(jstate) == set(tstate)
    for k, v in jstate.items():
        np.testing.assert_array_equal(tstate[k].numpy(), _np(v))
    assert len(list(net.parameters())) == len(jstate)
    with pytest.raises(KeyError):
        tbert.bert_state_dict_from_jax({}, net)
    # ERNIE names the same classes
    assert tbert.ErnieForPretraining is tbert.BertForPretraining
    cfg = tbert.ernie_3_base()
    assert (cfg.vocab_size, cfg.hidden_size, cfg.num_hidden_layers,
            cfg.num_attention_heads, cfg.layer_norm_eps) == \
        (40000, 768, 12, 12, 1e-12)
    assert cfg == tbert.BertConfig(**vars(jbert.ernie_3_base()))


def test_mlm_and_nsp_logits_match_jax(knobs):
    jnet, net = _models()
    x, _, _ = _batch()
    jmlm, jnsp = jnet(jpaddle.to_tensor(x))
    fk.reset_counts()
    with torch.no_grad():
        mlm, nsp = net(torch.from_numpy(x))
    assert mlm.shape == (B, S, V) and nsp.shape == (B, 2)
    np.testing.assert_allclose(mlm.numpy(), _np(jmlm), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(nsp.numpy(), _np(jnsp), rtol=TOL, atol=TOL)
    hpack = fk.flash_fwd_hpack.plain_calls
    assert (hpack, fk.flash_fwd.plain_calls) == \
        ((2, 0) if knobs == "bh knobs" else (0, 2))


def test_loss_and_every_gradient_match_jax(knobs):
    jnet, net = _models()
    x, labels, nsp = _batch(1)
    jcrit = jbert.BertPretrainingCriterion(V)
    jloss = jcrit(*jnet(jpaddle.to_tensor(x)), jpaddle.to_tensor(labels),
                  jpaddle.to_tensor(nsp))
    jloss.backward()
    fk.reset_counts()
    loss = tbert.BertPretrainingCriterion(V)(
        *net(torch.from_numpy(x)), torch.from_numpy(labels),
        torch.from_numpy(nsp))
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(_np(jloss)), rtol=TOL)
    jgrads = {n: _np(p.grad) for n, p in jnet.named_parameters()}
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()}
    assert set(grads) == set(jgrads)
    for n, g in grads.items():
        np.testing.assert_allclose(g, jgrads[n], rtol=TOL, atol=TOL,
                                   err_msg=n)
    fused = fk.flash_bwd_fused.plain_calls
    assert (fused, fk.flash_bwd_dq.plain_calls) == \
        ((2, 0) if knobs == "bh knobs" else (0, 2))


def test_mlm_loss_ignores_minus_100_labels():
    _, net = _models()
    x, labels, _ = _batch(2)
    crit = tbert.BertPretrainingCriterion(V)
    with torch.no_grad():
        mlm, nsp = net(torch.from_numpy(x))
        loss = crit(mlm, nsp, torch.from_numpy(labels))
        keep = labels.reshape(-1) != -100
        lf = mlm.reshape(-1, V)[torch.from_numpy(keep)]
        want = torch.nn.functional.cross_entropy(
            lf, torch.from_numpy(labels.reshape(-1)[keep]))
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=1e-6)


class _JLosses(JCallback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"][0]))


class _TLosses(TCallback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"][0]))


def test_three_adamw_fit_steps_match_jax(knobs):
    jnet, net = _models()
    lr = 1e-3
    jopt = joptimizer.AdamW(learning_rate=lr, parameters=jnet.parameters(),
                            weight_decay=0.01)
    topt = tpaddle.optimizer.AdamW(learning_rate=lr,
                                   parameters=net.parameters(),
                                   weight_decay=0.01)
    # one batch three times, with MLM and NSP labels, so every
    # parameter has a gradient in both and the loss must fall
    data = [_batch(3)] * 3
    labels = ["masked_labels", "next_sentence_labels"]
    jmodel = jpaddle.Model(jnet, labels=labels)
    jmodel.prepare(jopt, jbert.BertPretrainingCriterion(V))
    jcb = _JLosses()
    jmodel.fit(data, epochs=1, verbose=0, callbacks=[jcb])
    tmodel = tpaddle.Model(net, labels=labels, device="cpu")
    tmodel.prepare(topt, tbert.BertPretrainingCriterion(V))
    tcb = _TLosses()
    fk.reset_counts()
    tmodel.fit([tuple(torch.from_numpy(a) for a in b) for b in data],
               epochs=1, verbose=0, callbacks=[tcb])
    assert len(tcb.losses) == len(jcb.losses) == 3
    np.testing.assert_allclose(tcb.losses, jcb.losses, rtol=TOL)
    assert tcb.losses[-1] < tcb.losses[0]
    jstate = {k: _np(v) for k, v in jnet.state_dict().items()}
    diffs = np.concatenate([np.abs(v.numpy() - jstate[k]).ravel()
                            for k, v in net.state_dict().items()])
    assert (diffs <= PARAM_TOL).mean() >= PARAM_BULK
    assert diffs.max() <= ADAM_NOISE_TOL
    # three steps x two layers, each through the plain versions
    bh = knobs == "bh knobs"
    assert [f.plain_calls for f in fk.ALL_WRAPPERS] == \
        ([0, 0, 0, 6, 6] if bh else [6, 6, 6, 0, 0])
    assert [f.launches for f in fk.ALL_WRAPPERS] == [0] * 5


def test_attention_mask_path_matches_jax():
    """A 2-D padding mask leaves flash for the composed masked
    attention in both packages; padded tokens change nothing before
    them, and every gradient matches."""
    jnet, net = _models("BertModel")
    x, _, _ = _batch(4)
    mask = np.ones((B, S), np.float32)
    mask[0, 200:] = 0.0
    mask[1, 100:] = 0.0
    jseq, jpooled = jnet(jpaddle.to_tensor(x),
                         attention_mask=jpaddle.to_tensor(mask))
    (jseq.sum() + jpooled.sum()).backward()
    fk.reset_counts()
    seq, pooled = net(torch.from_numpy(x), attention_mask=torch.from_numpy(
        mask))
    (seq.sum() + pooled.sum()).backward()
    assert [f.plain_calls for f in fk.ALL_WRAPPERS] == [0] * 5
    np.testing.assert_allclose(seq.detach().numpy(), _np(jseq), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(pooled.detach().numpy(), _np(jpooled),
                               rtol=TOL, atol=TOL)
    jgrads = {n: _np(p.grad) for n, p in jnet.named_parameters()}
    for n, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[n], rtol=1e-4,
                                   atol=TOL, err_msg=n)
    x2 = x.copy()
    x2[0, 200:] = (x2[0, 200:] + 1) % V
    with torch.no_grad():
        seq2, _ = net(torch.from_numpy(x2),
                      attention_mask=torch.from_numpy(mask))
    torch.testing.assert_close(seq2[0, :200], seq.detach()[0, :200],
                               rtol=1e-5, atol=1e-6)


def test_sequence_classification_matches_jax(knobs):
    jnet, net = _models("ErnieForSequenceClassification", num_classes=3)
    x, _, _ = _batch(5)
    ref = _np(jnet(jpaddle.to_tensor(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (B, 3)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_bert_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tbert.BertForPretraining(tbert.bert_tiny())
    net = tbert.BertForPretraining(tbert.bert_tiny(), device="cpu")
    assert next(net.parameters()).device.type == "cpu"
    with pytest.raises(NotImplementedError, match="hidden_act"):
        tbert.BertLayer(tbert.bert_tiny(hidden_act="swish"), device="cpu")
