"""Metrics of the PyTorch port (``paddle_tpu_torch/metric``) against the
JAX package's (``paddle_tpu/metric``), on the same numpy inputs from a
seed, by both update paths: the host path (``compute``/``update``) and
the device path (``device_batch_stats`` then ``update_device_stats``),
each through ``accumulate()``.  Counts must be equal, values within
1e-7.  Predictions are distinct in every row, since ``torch.topk`` and
``jax.lax.top_k`` may order equal logits differently (ROADMAP queue C,
top-k ties)."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu import metric as jmetric
from paddle_tpu.tensor import Tensor as JTensor

from paddle_tpu_torch import metric as tmetric
from torch_parity_helpers import torch_one_thread  # noqa: F401

TOL = 1e-7
B, C, BATCHES = 32, 10, 3


def _distinct_logits(rng, b=B, c=C):
    """Rows of distinct values: a random permutation of spaced levels
    plus small noise."""
    base = np.stack([rng.permutation(c) for _ in range(b)]).astype(np.float32)
    return base + rng.uniform(0, 0.5, (b, c)).astype(np.float32)


def _labels(rng, form, b=B, c=C):
    y = rng.integers(0, c, b).astype(np.int64)
    if form == "col":
        return y[:, None]
    if form == "onehot":
        return np.eye(c, dtype=np.float32)[y]
    return y


def _feed(jm, tm, path, pred, label, jpred=None, tpred=None):
    """One batch into both metrics by ``path``; returns the two batch
    values."""
    jpred = pred if jpred is None else jpred
    tpred = torch.from_numpy(pred) if tpred is None else tpred
    tlabel = torch.from_numpy(label)
    if path == "host":
        if isinstance(jm, jmetric.Accuracy):
            jv = jm.update(jm.compute(JTensor(jpred), JTensor(label)))
            tv = tm.update(tm.compute(tpred, tlabel))
        else:
            jv = jm.update(jpred, label)
            tv = tm.update(tpred, tlabel)
        return jv, tv
    jstat = jax.jit(jm.device_batch_stats())(jnp.asarray(jpred),
                                             jnp.asarray(label))
    tstat = tm.device_batch_stats()(tpred, tlabel)
    np.testing.assert_array_equal(np.asarray(tstat), np.asarray(jstat))
    return jm.update_device_stats(jstat), tm.update_device_stats(tstat)


def _values(v):
    v = v if isinstance(v, list) else [v]
    return [float(np.asarray(x)) for x in v]


@pytest.mark.parametrize("path", ["host", "device"])
@pytest.mark.parametrize("form", ["flat", "col", "onehot"])
@pytest.mark.parametrize("topk", [(1,), (1, 5)])
def test_accuracy_matches_jax(topk, form, path):
    rng = np.random.default_rng(7)
    jm, tm = jmetric.Accuracy(topk=topk), tmetric.Accuracy(topk=topk)
    assert tm.name() == jm.name()
    for _ in range(BATCHES):
        jv, tv = _feed(jm, tm, path, _distinct_logits(rng),
                       _labels(rng, form))
        np.testing.assert_allclose(_values(tv), _values(jv), rtol=0,
                                   atol=TOL)
    if path == "host":
        assert tm.total == jm.total and tm.count == jm.count
    else:
        np.testing.assert_array_equal(tm._device_stat_sum(),
                                      jm._device_stat_sum())
    np.testing.assert_allclose(_values(tm.accumulate()),
                               _values(jm.accumulate()), rtol=0, atol=TOL)


def test_accuracy_paths_agree_and_carry_adds_up():
    """The host path, the pending stats and an accumulator that the
    stats were added into give one result."""
    rng = np.random.default_rng(3)
    batches = [(_distinct_logits(rng), _labels(rng, "col"))
               for _ in range(4)]
    host, pend, carry = (tmetric.Accuracy(topk=(1, 5)) for _ in range(3))
    acc = carry.device_acc_init()
    for pred, label in batches:
        p, l = torch.from_numpy(pred), torch.from_numpy(label)
        host.update(host.compute(p, l))
        pend.update_device(p, l)
        acc.add_(carry.device_batch_stats()(p, l))
    carry.adopt_device_acc(acc)
    assert host.accumulate() == pend.accumulate() == carry.accumulate()


def _binary(rng, b=B):
    """Predictions in (0, 1) away from 0.5, labels ``[B, 1]``."""
    p = rng.uniform(0.01, 0.99, (b, 1)).astype(np.float32)
    p[np.abs(p - 0.5) < 1e-3] = 0.25
    return p, rng.integers(0, 2, (b, 1)).astype(np.int64)


@pytest.mark.parametrize("path", ["host", "device"])
@pytest.mark.parametrize("name", ["Precision", "Recall"])
def test_precision_recall_match_jax(name, path):
    rng = np.random.default_rng(11)
    jm, tm = getattr(jmetric, name)(), getattr(tmetric, name)()
    for _ in range(BATCHES):
        jv, tv = _feed(jm, tm, path, *_binary(rng))
        if path == "device":
            assert float(tv) == float(jv)
    if path == "host":
        other = "fp" if name == "Precision" else "fn"
        assert (tm.tp, getattr(tm, other)) == (jm.tp, getattr(jm, other))
    else:
        np.testing.assert_array_equal(tm._device_stat_sum(),
                                      jm._device_stat_sum())
    assert abs(tm.accumulate() - jm.accumulate()) <= TOL


@pytest.mark.parametrize("path", ["host", "device"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_auc_matches_jax(dtype, path):
    """Bins are ``int(p * T)`` in the prediction's dtype: a bf16
    prediction bins in bf16 in both packages."""
    rng = np.random.default_rng(5)
    jm, tm = jmetric.Auc(num_thresholds=255), tmetric.Auc(num_thresholds=255)
    for _ in range(BATCHES):
        p, y = _binary(rng)
        if dtype == "bfloat16":
            jp = p.astype(ml_dtypes.bfloat16)
            tp = torch.from_numpy(p).to(torch.bfloat16)
            assert np.array_equal(jp.astype(np.float32),
                                  tp.float().numpy())
        else:
            jp, tp = p, torch.from_numpy(p)
        jv, tv = _feed(jm, tm, path, p, y, jpred=jp, tpred=tp)
        if path == "device":
            assert abs(float(tv) - float(jv)) <= TOL
    if path == "host":
        np.testing.assert_array_equal(tm._stat_pos, jm._stat_pos)
        np.testing.assert_array_equal(tm._stat_neg, jm._stat_neg)
    else:
        np.testing.assert_array_equal(tm._device_stat_sum(),
                                      jm._device_stat_sum())
    assert abs(tm.accumulate() - jm.accumulate()) <= TOL


def test_auc_bf16_bins_differ_from_upcast_bins():
    """The control of the bf16 case: bf16 predictions whose bins in bf16
    differ from their bins after an upcast to fp32, on both paths, so a
    port that upcast first would fail the parity above."""
    t = torch.linspace(0.3, 0.31, 64).to(torch.bfloat16)
    auc = tmetric.Auc(num_thresholds=4095)
    assert not np.array_equal(auc._host_bins(t), auc._host_bins(t.float()))
    label = torch.ones(64, dtype=torch.int64)
    stats = auc.device_batch_stats()
    assert not torch.equal(stats(t, label), stats(t.float(), label))


@pytest.mark.parametrize("k", [1, 3])
def test_accuracy_function_matches_jax(k):
    rng = np.random.default_rng(2)
    pred, label = _distinct_logits(rng), _labels(rng, "col")
    want = jmetric.accuracy(JTensor(pred), JTensor(label), k=k)
    got = tmetric.accuracy(torch.from_numpy(pred), torch.from_numpy(label),
                           k=k)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(np.asarray(want.numpy()))) <= TOL
