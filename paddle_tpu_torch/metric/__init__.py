"""Metrics (counterpart of ``paddle_tpu/metric/__init__.py``).

Two update paths, as in the JAX package:

- the host path, ``compute`` / ``update`` on numpy arrays, for direct
  calls and for metrics without a device path;
- the device path, for metrics that set ``supports_device_update``,
  which ``Model.fit`` and ``Model.evaluate`` run inside the step.

The device protocol:

- ``device_batch_stats()`` returns a torch function ``(pred, label) ->
  stat`` of device tensors that runs inside the training step, and so
  inside its CUDA graph on the card: no ``.item()``, ``.cpu()`` or
  ``bool(tensor)``, nothing that waits for the host.  The stat is a
  self-contained fp32 vector (it carries its own row or bin counts),
  so stats combine by addition: ``[corr_k..., rows]`` for
  :class:`Accuracy`, ``[tp, fp]`` / ``[tp, fn]`` for
  :class:`Precision` / :class:`Recall`, the ``[2, T+1]`` histogram for
  :class:`Auc`.
- ``device_acc_init(device)`` is the zero accumulator.  ``Model`` owns
  one per metric, at a fixed address that the captured step adds to in
  place, and zeroes it at each epoch's start; ``adopt_device_acc``
  hands the metric a reference (no copy, no sync).
- ``update_device_stats(stat)`` is the single-step path (the eager
  route, evaluation): a host list append.
- ``device_step_result(stack, i)`` is a folded group's per-step log
  value, a lazy view of the group's ``[K, ...]`` stat stack.

``accumulate()`` merges the host counters, the pending single-step
stats and the accumulator, summed in float64: the one sync, at the
epoch's end.  The counts are integers in fp32, so they are exact below
2**24 rows an epoch whatever the order of the additions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework.lazy import LazyScalar

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric:
    # metrics that implement the device-stat protocol set this True;
    # Model.fit then keeps their accumulators on the device
    supports_device_update = False

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args

    # -- device-stat protocol -----------------------------------------------
    def device_batch_stats(self):
        raise NotImplementedError

    def device_acc_init(self, device="cpu"):
        raise NotImplementedError

    def _stat_result(self, stat):
        """One stat (a batch's, or a slice's) as the metric's value, on
        the host."""
        raise NotImplementedError

    def update_device_stats(self, stat):
        self._dev_pending.append(stat)
        return LazyScalar(stat, post=self._stat_result)

    def device_step_result(self, stack, i):
        return LazyScalar(stack, post=lambda a, i=i: self._stat_result(a[i]))

    def adopt_device_acc(self, acc):
        self._dev_acc = acc

    def update_device(self, pred, label):
        """The device update outside a step: the stat of one batch,
        appended to the pending list."""
        if getattr(self, "_stats_fn", None) is None:
            self._stats_fn = self.device_batch_stats()
        with torch.no_grad():
            stat = self._stats_fn(pred, label)
        return self.update_device_stats(stat)

    def _device_stat_sum(self):
        """The pending stats and the accumulator, summed in float64 on
        the device and fetched once; None when there were no device
        updates."""
        stats = list(getattr(self, "_dev_pending", []))
        acc = getattr(self, "_dev_acc", None)
        if acc is not None:
            stats.append(acc)
        if not stats:
            return None
        by_device = {}
        for s in stats:
            by_device.setdefault(s.device, []).append(s)
        total = None
        for group in by_device.values():
            part = torch.stack([s.detach().to(torch.float64)
                                for s in group]).sum(0).cpu().numpy()
            total = part if total is None else total + part
        return total

    def _reset_device_state(self):
        self._dev_pending = []
        self._dev_acc = None


class Accuracy(Metric):
    """Top-k accuracy.  The device path ranks with ``torch.topk`` and
    the host path with ``np.argsort(-pred)``, as the JAX package ranks
    with ``jax.lax.top_k`` and ``np.argsort``: equal logits may rank in
    another order, so tests compare on distinct logits."""

    supports_device_update = True

    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self._stats_fn = None
        self.reset()

    def compute(self, pred, label, *args):
        pred_np = _np(pred)
        label_np = _np(label)
        order = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        if label_np.ndim == pred_np.ndim:
            label_np = label_np.squeeze(-1) if \
                label_np.shape[-1] == 1 else label_np.argmax(-1)
        return torch.from_numpy(
            (order == label_np[..., None]).astype(np.float32))

    def update(self, correct, *args):
        c = _np(correct).reshape(-1, self.maxk)
        num = c.shape[0]
        accs = []
        for j, k in enumerate(self.topk):
            corr_k = c[:, :k].sum()
            self.total[j] += corr_k
            self.count[j] += num
            accs.append(corr_k / max(num, 1))
        return accs[0] if len(accs) == 1 else accs

    def device_batch_stats(self):
        """``[corr_k1, ..., corr_kn, rows]``: the trailing row count
        makes the stat self-contained."""
        maxk, topk = self.maxk, self.topk

        def stats(pred, label):
            order = torch.topk(pred, maxk, dim=-1).indices
            if label.ndim == pred.ndim:
                label = (label[..., 0] if label.shape[-1] == 1
                         else label.argmax(-1))
            correct = (order == label[..., None]).to(torch.float32)
            flat = correct.reshape(-1, maxk)
            counts = [flat[:, :k].sum() for k in topk]
            counts.append(torch.full((), flat.shape[0], dtype=torch.float32,
                                     device=flat.device))
            return torch.stack(counts)

        return stats

    def device_acc_init(self, device="cpu"):
        return torch.zeros(len(self.topk) + 1, dtype=torch.float32,
                           device=device)

    def _result_views(self, dev, pick):
        def ratio(a, j):
            c = pick(a)
            return float(c[j]) / max(float(c[-1]), 1.0)

        if len(self.topk) == 1:
            return LazyScalar(dev, post=lambda a: ratio(a, 0))
        return [LazyScalar(dev, post=lambda a, j=j: ratio(a, j))
                for j in range(len(self.topk))]

    def update_device_stats(self, stat):
        self._dev_pending.append(stat)
        return self._result_views(stat, lambda a: a)

    def device_step_result(self, stack, i):
        return self._result_views(stack, lambda a, i=i: a[i])

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)
        self._reset_device_state()

    def accumulate(self):
        total = list(self.total)
        count = list(self.count)
        dev = self._device_stat_sum()
        if dev is not None:
            for i in range(len(self.topk)):
                total[i] += float(dev[i])
                count[i] += float(dev[-1])
        res = [t / max(c, 1) for t, c in zip(total, count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class _Binary(Metric):
    """Precision and Recall: a prediction above 0.5 is positive."""

    supports_device_update = True

    def device_acc_init(self, device="cpu"):
        return torch.zeros(2, dtype=torch.float32, device=device)

    def _stat_result(self, stat):
        denom = float(stat[0]) + float(stat[1])
        return float(stat[0]) / denom if denom else 0.0

    def _finish(self, a, b):
        a, b = float(a), float(b)
        dev = self._device_stat_sum()
        if dev is not None:
            a += float(dev[0])
            b += float(dev[1])
        return a / (a + b) if a + b else 0.0

    def name(self):
        return self._name


class Precision(_Binary):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        l = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def device_batch_stats(self):
        """``[tp, fp]``, exact counts in fp32."""

        def stats(pred, label):
            p = pred.reshape(-1) > 0.5
            l = label.reshape(-1).to(torch.int32)
            tp = (p & (l == 1)).to(torch.float32).sum()
            fp = (p & (l == 0)).to(torch.float32).sum()
            return torch.stack([tp, fp])

        return stats

    def reset(self):
        self.tp = 0
        self.fp = 0
        self._reset_device_state()

    def accumulate(self):
        return self._finish(self.tp, self.fp)


class Recall(_Binary):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        l = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def device_batch_stats(self):
        """``[tp, fn]``, exact counts in fp32."""

        def stats(pred, label):
            p = pred.reshape(-1) > 0.5
            l = label.reshape(-1).to(torch.int32)
            tp = (p & (l == 1)).to(torch.float32).sum()
            fn = (~p & (l == 1)).to(torch.float32).sum()
            return torch.stack([tp, fn])

        return stats

    def reset(self):
        self.tp = 0
        self.fn = 0
        self._reset_device_state()

    def accumulate(self):
        return self._finish(self.tp, self.fn)


def _auc_from_hist(pos, neg):
    """The trapezoid over descending thresholds of a positive and a
    negative histogram."""
    tp = np.cumsum(pos[::-1])
    fp = np.cumsum(neg[::-1])
    tot_pos, tot_neg = tp[-1], fp[-1]
    if tot_pos == 0 or tot_neg == 0:
        return 0.0
    prev_tp = np.concatenate([[0.0], tp[:-1]])
    prev_fp = np.concatenate([[0.0], fp[:-1]])
    area = float(np.sum((fp - prev_fp) * (tp + prev_tp) / 2.0))
    return area / float(tot_pos * tot_neg)


class Auc(Metric):
    """ROC AUC over ``num_thresholds + 1`` bins.  A prediction's bin is
    ``int(p * T)``, clipped, computed in the prediction's dtype: a bf16
    prediction (O2) bins in bf16 on both paths, as the JAX package's
    does."""

    supports_device_update = True

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def _host_bins(self, preds):
        T = self.num_thresholds
        if isinstance(preds, torch.Tensor) and preds.dtype in (
                torch.bfloat16, torch.float16):
            p = preds.detach().cpu()
            if p.ndim == 2 and p.shape[1] == 2:
                p = p[:, 1]
            return np.clip((p.reshape(-1) * T).to(torch.int64).numpy(),
                           0, T)
        p = _np(preds)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        return np.clip((p.reshape(-1) * T).astype(int), 0, T)

    def update(self, preds, labels):
        bins = self._host_bins(preds)
        l = _np(labels).reshape(-1)
        for b, lab in zip(bins, l):
            if lab:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def device_batch_stats(self):
        """``[2, T+1]``: the positive and negative histograms, one
        ``index_add_`` each."""
        T = self.num_thresholds

        def stats(pred, label):
            p = pred
            if p.ndim == 2 and p.shape[1] == 2:
                p = p[:, 1]
            p = p.reshape(-1)
            lab = (label.reshape(-1) != 0).to(torch.float32)
            bins = torch.clamp((p * T).to(torch.int32), 0, T)
            hist = torch.zeros(2, T + 1, dtype=torch.float32,
                               device=p.device)
            hist[0].index_add_(0, bins, lab)
            hist[1].index_add_(0, bins, 1.0 - lab)
            return hist

        return stats

    def device_acc_init(self, device="cpu"):
        return torch.zeros(2, self.num_thresholds + 1, dtype=torch.float32,
                           device=device)

    def _stat_result(self, stat):
        return _auc_from_hist(stat[0], stat[1])

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)
        self._reset_device_state()

    def accumulate(self):
        stat_pos = self._stat_pos
        stat_neg = self._stat_neg
        dev = self._device_stat_sum()
        if dev is not None:
            stat_pos = stat_pos + dev[0]
            stat_neg = stat_neg + dev[1]
        return _auc_from_hist(stat_pos, stat_neg)

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the ``k`` largest
    predictions, as a 0-d fp32 tensor (on the CPU)."""
    pred = _np(input)
    lab = _np(label).reshape(-1)
    order = np.argsort(-pred, axis=-1)[:, :k]
    corr = (order == lab[:, None]).any(axis=1).mean()
    return torch.tensor(corr, dtype=torch.float32)
