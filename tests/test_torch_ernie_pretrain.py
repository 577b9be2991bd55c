"""ERNIE pretraining as PaddleNLP sets it up, through ``Model.fit``, in
the port and in the JAX package: a small BERT (2 layers, hidden 64, 4
heads of 16, vocab 256, S=128, MLM 15%, dropout 0) in fp32 with

- ``AdamW(beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=0.01,
  apply_decay_param_fun=<p.name of the parameters whose structured
  name has neither "bias" nor a norm's name>, grad_clip=
  ClipGradByGlobalNorm(1.0), multi_precision=True)``;
- ``LinearWarmup(PolynomialDecay(1e-3, 4, end_lr=1e-4, power=1.0), 2,
  0.0, 1e-3)``, stepped by ``LRSchedulerCallback(by_step=True,
  by_epoch=False)``, so six steps cross the warmup into the decay and
  ``fit`` runs one step a group.

Each package builds its decay set from its own ``p.name`` s, mapped by
structured name (PaddleNLP's rule is "bias" and "norm"; this BERT names
its LayerNorms ``ln1``, ``ln2`` and ``transform_ln``, so "ln" joins
them).  The weights carry over with ``bert_state_dict_from_jax``; the
JAX flash kernels run in interpret mode, the port's plain versions.
Tolerances are ``tests/test_torch_training.py::
test_three_adamw_fit_steps_match_jax``'s: losses 2e-5 relative,
parameters 2e-6 on 99.5% of the elements and 1e-3 on all.  The run
stops after three steps to save a ``.pdopt`` with its ``LR_Scheduler``
in each package, which the other package loads to run the last three
steps.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.hapi.callbacks import Callback as JCallback
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops import pallas_ops

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.hapi.callbacks import Callback as TCallback
from paddle_tpu_torch.models import bert as tbert
from torch_parity_helpers import torch_one_thread  # noqa: F401

TOL = 2e-5
PARAM_TOL = 2e-6
PARAM_BULK = 0.995
ADAM_NOISE_TOL = 1e-3
B, S, V = 2, 128, 256
PEAK, WARMUP, DECAY = 1e-3, 2, 4
NO_DECAY = ("bias", "norm", "ln")
TINY = dict(vocab_size=V, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=S, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


def _batches():
    out = []
    for seed in range(6):
        rng = np.random.default_rng(seed)
        x = rng.integers(0, V, (B, S)).astype(np.int64)
        labels = np.where(rng.random((B, S)) < 0.15, x, -100).astype(np.int64)
        out.append((x, labels))
    return out


class _JLosses(JCallback):
    def __init__(self):
        super().__init__()
        self.losses, self.rates = [], []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(np.asarray(logs["loss"][0])))
        self.rates.append(self.model._optimizer.get_lr())


class _TLosses(TCallback):
    def __init__(self):
        super().__init__()
        self.losses, self.rates = [], []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"][0]))
        self.rates.append(self.model._optimizer.get_lr())


def _decay_names(net):
    return [p.name for n, p in net.named_parameters()
            if not any(nd in n for nd in NO_DECAY)]


def _jax_model(net):
    decay = _decay_names(net)
    sched = joptimizer.lr.LinearWarmup(
        joptimizer.lr.PolynomialDecay(PEAK, DECAY, end_lr=PEAK / 10,
                                      power=1.0), WARMUP, 0.0, PEAK)
    opt = joptimizer.AdamW(learning_rate=sched, beta1=0.9, beta2=0.999,
                           epsilon=1e-8, parameters=net.parameters(),
                           weight_decay=0.01,
                           apply_decay_param_fun=lambda n: n in decay,
                           grad_clip=jnn.ClipGradByGlobalNorm(1.0),
                           multi_precision=True)
    model = jpaddle.Model(net, labels=["masked_labels"])
    model.prepare(opt, jbert.BertPretrainingCriterion(V))
    return model


def _port_model(net):
    decay = _decay_names(net)
    sched = tpaddle.optimizer.lr.LinearWarmup(
        tpaddle.optimizer.lr.PolynomialDecay(PEAK, DECAY, end_lr=PEAK / 10,
                                             power=1.0), WARMUP, 0.0, PEAK)
    opt = tpaddle.optimizer.AdamW(learning_rate=sched, beta1=0.9,
                                  beta2=0.999, epsilon=1e-8,
                                  parameters=net.parameters(),
                                  weight_decay=0.01,
                                  apply_decay_param_fun=lambda n: n in decay,
                                  grad_clip=tnn.ClipGradByGlobalNorm(1.0),
                                  multi_precision=True)
    model = tpaddle.Model(net, labels=["masked_labels"], device="cpu")
    model.prepare(opt, tbert.BertPretrainingCriterion(V))
    return model


def _fit(model, batches, cb, port):
    data = [tuple(torch.from_numpy(a) for a in b) for b in batches] \
        if port else batches
    sched = (tpaddle.callbacks.LRScheduler if port else
             jpaddle.callbacks.LRScheduler)(by_step=True, by_epoch=False)
    model.fit(data, epochs=1, verbose=0, callbacks=[cb, sched])


def _close(tnet, jstate):
    diffs = np.concatenate([np.abs(v.numpy() - jstate[k]).ravel()
                            for k, v in tnet.state_dict().items()])
    assert (diffs <= PARAM_TOL).mean() >= PARAM_BULK
    assert diffs.max() <= ADAM_NOISE_TOL


def _jstate(jnet):
    return {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages through the six steps, stopped after three to save;
    and each package resumed from the other's checkpoint."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    mp.setenv("PADDLE_TPU_FLASH_BQ", "128")
    mp.setenv("PADDLE_TPU_FLASH_BK", "128")
    pallas_ops._PALLAS_HEALTH.pop("ok", None)
    assert pallas_ops._pallas_healthy()
    tmp = tmp_path_factory.mktemp("ernie")
    batches = _batches()
    jpaddle.seed(0)
    jnet = jbert.BertForPretraining(jbert.BertConfig(**TINY))
    init = _jstate(jnet)
    tnet = tbert.BertForPretraining(tbert.BertConfig(**TINY), device="cpu")
    tnet.load_state_dict(tbert.bert_state_dict_from_jax(init, tnet))
    jm, tm = _jax_model(jnet), _port_model(tnet)
    # the clip is active from the first step on
    x, labels = (torch.from_numpy(a) for a in batches[0])
    tbert.BertPretrainingCriterion(V)(*tnet(x), labels).backward()
    first_norm = tm._optimizer._grad_clip.global_norm(
        [p.grad for p in tnet.parameters() if p.grad is not None]).item()
    tnet.zero_grad(set_to_none=True)
    jcb, tcb = _JLosses(), _TLosses()
    _fit(jm, batches[:3], jcb, port=False)
    _fit(tm, batches[:3], tcb, port=True)
    jpath, tpath = str(tmp / "jax"), str(tmp / "port")
    jm.save(jpath)
    tm.save(tpath)
    _fit(jm, batches[3:], jcb, port=False)
    _fit(tm, batches[3:], tcb, port=True)
    # each package resumes from the other's checkpoint
    tnet2 = tbert.BertForPretraining(tbert.BertConfig(**TINY), device="cpu")
    tm2 = _port_model(tnet2)
    tm2.load(jpath)
    tcb2 = _TLosses()
    _fit(tm2, batches[3:], tcb2, port=True)
    jpaddle.seed(1)
    jnet2 = jbert.BertForPretraining(jbert.BertConfig(**TINY))
    jm2 = _jax_model(jnet2)
    jm2.load(tpath)
    jcb2 = _JLosses()
    _fit(jm2, batches[3:], jcb2, port=False)
    yield dict(jm=jm, tm=tm, jcb=jcb, tcb=tcb, tm2=tm2, tcb2=tcb2, jm2=jm2,
               jcb2=jcb2, jpath=jpath, tpath=tpath, first_norm=first_norm)
    mp.undo()
    pallas_ops._PALLAS_HEALTH.pop("ok", None)


def test_six_fit_steps_across_warmup_into_decay_match_jax(runs):
    jcb, tcb = runs["jcb"], runs["tcb"]
    assert runs["first_norm"] > 1.0      # the clip scales step 1
    assert len(tcb.losses) == len(jcb.losses) == 6
    np.testing.assert_allclose(tcb.losses, jcb.losses, rtol=TOL)
    # the rate each step ran at: the warmup's 0 and 5e-4, then the
    # linear decay from 1e-3 towards 1e-4 over four steps
    assert tcb.rates == jcb.rates
    np.testing.assert_allclose(
        tcb.rates, [0.0, 5e-4, 1e-3, 7.75e-4, 5.5e-4, 3.25e-4], rtol=1e-12)
    assert runs["tm"]._fold == 1
    _close(runs["tm"].network, _jstate(runs["jm"].network))


def test_decay_function_reaches_the_coefficients(runs):
    """The decay function reaches each parameter's coefficient: the
    matrices and embeddings decay, the biases and norms do not."""
    opt = runs["tm"]._optimizer
    decays = {n: opt._param_decay(i, p) for i, (n, p) in enumerate(
        runs["tm"].network.named_parameters())}
    assert decays["bert.encoder.0.fc1.weight"] == 0.01
    for n in ("bert.encoder.0.fc1.bias", "bert.encoder.0.ln1.weight",
              "transform_ln.weight", "bert.embeddings.layer_norm.weight"):
        assert decays[n] == 0.0, n
    # three embeddings, four matrices a layer, pooler, transform, NSP
    assert sum(d > 0 for d in decays.values()) == 14


def test_pdopt_with_lr_scheduler_round_trips_both_ways(runs):
    jsd = jpaddle.load(runs["tpath"] + ".pdopt")
    sd = tpaddle.load(runs["jpath"] + ".pdopt")
    for got in (jsd["LR_Scheduler"], sd["LR_Scheduler"]):
        assert got["last_epoch"] == 3 and got["warmup_steps"] == WARMUP
        assert got["lr_after"].last_epoch == 1
    assert type(sd["LR_Scheduler"]["lr_after"]).__module__ == \
        "paddle_tpu_torch.optimizer.lr"
    assert type(jsd["LR_Scheduler"]["lr_after"]).__module__ == \
        "paddle_tpu.optimizer.lr"
    # the resumed runs take the last three steps as the straight ones
    np.testing.assert_allclose(runs["tcb2"].losses, runs["jcb"].losses[3:],
                               rtol=TOL)
    np.testing.assert_allclose(runs["jcb2"].losses, runs["tcb"].losses[3:],
                               rtol=TOL)
    assert runs["tcb2"].rates == runs["tcb"].rates[3:]
    assert runs["tm2"]._optimizer._learning_rate.last_epoch == 6
    _close(runs["tm2"].network, _jstate(runs["jm"].network))
    _close(runs["tm"].network, _jstate(runs["jm2"].network))
