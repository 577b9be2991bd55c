"""The CRNN text recognizer of ``tests/test_crnn_e2e.py`` (conv, BiLSTM,
CTC) on the PyTorch port against the same model on the JAX package:
three ``Model.fit`` steps from the same weights, and the full-width
CRNN of ``chip_smoke.py`` (the VGG of the CRNN paper's Table 1,
PaddleOCR's BiLSTM neck and CTC head) at a small batch.

Tolerances (fp32): losses 1e-5 relative; parameters after three Adam
steps 1e-4 x max(|ref|, 1).
"""

import numpy as np
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.tensor import Tensor as JTensor

import chip_smoke
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import nn as tnn
from torch_parity_helpers import torch_one_thread  # noqa: F401

CPU = "cpu"
B, H, W, L, CLASSES, HIDDEN = 4, 16, 32, 5, 11, 32


class JCRNN(jnn.Layer):
    """``tests/test_crnn_e2e.py``'s CRNN."""

    def __init__(self):
        super().__init__()
        self.conv = jnn.Sequential(
            jnn.Conv2D(1, 8, 3, stride=2, padding=1), jnn.ReLU(),
            jnn.Conv2D(8, 16, 3, stride=(2, 1), padding=1), jnn.ReLU())
        self.lstm = jnn.LSTM(16 * 4, HIDDEN, direction="bidirect")
        self.head = jnn.Linear(2 * HIDDEN, CLASSES)

    def forward(self, x):
        f = self.conv(x)
        n, c, h, w = f.shape
        f = f.transpose([0, 3, 1, 2]).reshape([n, w, c * h])
        seq, _ = self.lstm(f)
        return self.head(seq)


class JCTC(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.ctc = jnn.CTCLoss(blank=0)

    def forward(self, logits, labels, label_lengths):
        lp = logits.transpose([1, 0, 2])
        t, b = lp.shape[0], lp.shape[1]
        return self.ctc(lp, labels, JTensor(np.full((b,), t, np.int64)),
                        label_lengths)


class CRNN(tnn.Layer):
    """The same model on the port's layers."""

    def __init__(self):
        super().__init__()
        self.conv = tnn.Sequential(
            tnn.Conv2D(1, 8, 3, stride=2, padding=1, device=CPU), tnn.ReLU(),
            tnn.Conv2D(8, 16, 3, stride=(2, 1), padding=1, device=CPU),
            tnn.ReLU())
        self.lstm = tnn.LSTM(16 * 4, HIDDEN, direction="bidirect",
                             device=CPU)
        self.head = tnn.Linear(2 * HIDDEN, CLASSES, device=CPU)

    def forward(self, x):
        f = self.conv(x)
        n, c, h, w = f.shape
        seq, _ = self.lstm(f.permute(0, 3, 1, 2).reshape(n, w, c * h))
        return self.head(seq)


def _batches(n, seed=0):
    """The e2e test's stripes, with label lengths from 2 to L."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = rng.randint(2, L + 1, B)
        labels = rng.randint(1, CLASSES, (B, L))
        labels[np.arange(L)[None, :] >= lens[:, None]] = 0
        imgs = np.zeros((B, 1, H, W), np.float32)
        for b in range(B):
            for i in range(lens[b]):
                imgs[b, 0, :, 2 + i * 6:6 + i * 6] = labels[b, i] / 10.0
        imgs += rng.randn(B, 1, H, W).astype(np.float32) * 0.01
        out.append((imgs, labels.astype(np.int64), lens.astype(np.int64)))
    return out


class _Keep(tpaddle.callbacks.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"][0]))


class _JKeep(jpaddle.callbacks.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"][0]))


def test_crnn_fit_matches_jax():
    jpaddle.seed(0)
    jnet = JCRNN()
    state = {k: np.array(v.numpy()) for k, v in jnet.state_dict().items()}
    jnet.set_state_dict(state)
    net = CRNN()
    assert net.set_state_dict(state) == ([], [])
    data = _batches(3)
    jm = jpaddle.Model(jnet, labels=["label", "length"])
    jm.prepare(joptimizer.Adam(2e-3, parameters=jnet.parameters()), JCTC())
    tm = tpaddle.Model(net, labels=["label", "length"], device=CPU)
    tm.prepare(tpaddle.optimizer.Adam(2e-3, parameters=net.parameters()),
               chip_smoke.slice19_models()["CTCCriterion"]())
    jk, tk = _JKeep(), _Keep()
    jm.fit(data, epochs=1, verbose=0, callbacks=[jk])
    tm.fit(data, epochs=1, verbose=0, callbacks=[tk])
    np.testing.assert_allclose(tk.losses, jk.losses, rtol=1e-5)
    jstate = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    for k, v in net.state_dict().items():
        ref = jstate[k]
        scale = max(float(np.abs(ref).max()), 1.0)
        np.testing.assert_allclose(v.numpy(), ref, rtol=0, atol=1e-4 * scale,
                                   err_msg=k)
        assert not np.array_equal(v.numpy(), state[k]), k


def test_full_width_crnn_shapes_and_loss():
    """``chip_smoke``'s CRNN at its published widths on two images:
    ``[2, 1, 32, 100]`` to ``[2, 26, 37]``, a finite CTC loss at both
    reductions, and a gradient for every parameter."""
    m = chip_smoke.slice19_models()
    tpaddle.seed(0)
    net = m["CRNN"](device=CPU)
    imgs, labels, lens = chip_smoke.ocr_batch(2, 0)
    assert imgs.shape == (2, 1, 32, 100) and labels.shape == (2, 12)
    assert (labels[np.arange(12)[None, :] >= lens[:, None]] == 0).all()
    logits = net(torch.tensor(imgs))
    assert tuple(logits.shape) == (2, 26, chip_smoke.CRNN_CLASSES)
    mean = m["CTCCriterion"]()(logits, torch.tensor(labels),
                                torch.tensor(lens))
    total = m["CTCCriterion"]("sum")(logits, torch.tensor(labels),
                                     torch.tensor(lens))
    per = m["CTCCriterion"]("none")(logits, torch.tensor(labels),
                                    torch.tensor(lens))
    torch.testing.assert_close(total, per.sum())
    torch.testing.assert_close(mean, (per / torch.tensor(lens)).mean())
    mean.backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in net.parameters())
