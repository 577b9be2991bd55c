"""``nn/rnn.py`` and ``ops/rnn_ops.py`` of the PyTorch port against the
JAX package: the nine tests of ``tests/test_rnn.py`` with the JAX layers
as the oracle (weights carried by name), the two RNN tests of
``tests/test_nn_coverage.py``, and outputs, final states and every
gradient with ragged ``sequence_length`` in both directions.

Tolerances (fp32): outputs and states 1e-5 x max(|ref|, 1), gradients
1e-4 x max(|ref|, 1) (the same recurrence; the port multiplies every
step's input in one matmul first, so its sums differ in order).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu.tensor import Tensor as JTensor

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import nn as tnn
from torch_parity_helpers import torch_one_thread  # noqa: F401

CPU = "cpu"
FWD, GRAD = 1e-5, 1e-4


def _close(got, ref, tol, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale,
                               err_msg=what)


def _pair(name, *args, seed=0, **kw):
    jpaddle.seed(seed)
    jl = getattr(jnn, name)(*args, **kw)
    tl = getattr(tnn, name)(*args, **kw, device=CPU)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert tl.set_state_dict(state) == ([], [])
    return jl, tl


def _np(t):
    return np.asarray(t.numpy()) if isinstance(t, JTensor) else \
        t.detach().numpy()


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("name,seed,shape", [
    ("LSTM", 0, (3, 7, 5, 4)), ("GRU", 1, (2, 5, 4, 6)),
    ("SimpleRNN", 2, (2, 4, 3, 5))])
def test_single_layer_matches_jax(name, seed, shape):
    """``test_lstm_matches_torch``, ``test_gru_matches_torch``,
    ``test_simple_rnn_matches_torch``."""
    B, T, I, H = shape
    jl, tl = _pair(name, I, H, seed=seed)
    x = _x(seed, B, T, I)
    jout, jst = jl(JTensor(x))
    out, st = tl(torch.tensor(x))
    _close(_np(out), _np(jout), FWD, "out")
    jst = jst if isinstance(jst, tuple) else (jst,)
    st = st if isinstance(st, tuple) else (st,)
    for a, b in zip(st, jst):
        _close(_np(a), _np(b), FWD, "state")


def test_bidirectional_multilayer_shapes_and_jax():
    B, T, I, H, L = 2, 6, 4, 3, 2
    jl, tl = _pair("LSTM", I, H, num_layers=L, direction="bidirect", seed=3)
    x = _x(3, B, T, I)
    out, (h, c) = tl(torch.tensor(x))
    assert tuple(out.shape) == (B, T, 2 * H)
    assert tuple(h.shape) == tuple(c.shape) == (2 * L, B, H)
    jout, (jh, jc) = jl(JTensor(x))
    for a, b in ((out, jout), (h, jh), (c, jc)):
        _close(_np(a), _np(b), FWD)


def test_sequence_length_masking():
    B, T, I, H = 2, 6, 3, 4
    jl, tl = _pair("LSTM", I, H, seed=4)
    x = _x(4, B, T, I)
    lens = np.array([4, 6], np.int64)
    out, (h, _) = tl(torch.tensor(x), sequence_length=torch.tensor(lens))
    o = _np(out)
    np.testing.assert_allclose(o[0, 4:], 0.0, atol=1e-7)
    assert np.abs(o[1, 4:]).sum() > 0
    _, (h2, _) = tl(torch.tensor(x[:1, :4]))
    np.testing.assert_allclose(_np(h)[0, 0], _np(h2)[0, 0], rtol=1e-5,
                               atol=1e-6)
    jout, (jh, _) = jl(JTensor(x), sequence_length=JTensor(lens))
    _close(o, _np(jout), FWD)
    _close(_np(h), _np(jh), FWD)
    jbi, bi = _pair("LSTM", I, H, direction="bidirect", seed=4)
    _, (hb, _) = bi(torch.tensor(x), sequence_length=torch.tensor(lens))
    _, (hb2, _) = bi(torch.tensor(x[:1, :4]))
    np.testing.assert_allclose(_np(hb)[1, 0], _np(hb2)[1, 0], rtol=1e-5,
                               atol=1e-6)
    _, (jhb, _) = jbi(JTensor(x), sequence_length=JTensor(lens))
    _close(_np(hb), _np(jhb), FWD)


def test_cell_stepwise_matches_scan():
    B, T, I, H = 2, 5, 3, 4
    jcell, cell = _pair("LSTMCell", I, H, seed=5)
    rnn = tnn.RNN(cell)
    x = _x(5, B, T, I)
    out, (h, _) = rnn(torch.tensor(x))
    states = cell.get_initial_states(torch.tensor(x))
    jstates = jcell.get_initial_states(JTensor(x))
    for t in range(T):
        o, states = cell(torch.tensor(x[:, t]), states)
        jo, jstates = jcell(JTensor(x[:, t]), jstates)
        np.testing.assert_allclose(_np(out)[:, t], _np(o), rtol=1e-5,
                                   atol=1e-6)
        _close(_np(o), _np(jo), FWD)
    np.testing.assert_allclose(_np(h), _np(states[0]), rtol=1e-5, atol=1e-6)


def test_birnn_wrapper():
    B, T, I, H = 2, 4, 3, 5
    tpaddle.seed(6)
    bi = tnn.BiRNN(tnn.GRUCell(I, H, device=CPU), tnn.GRUCell(I, H,
                                                              device=CPU))
    jpaddle.seed(6)
    jbi = jnn.BiRNN(jnn.GRUCell(I, H), jnn.GRUCell(I, H))
    bi.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in jbi.state_dict().items()})
    x = _x(6, B, T, I)
    out, (st_f, st_b) = bi(torch.tensor(x))
    assert tuple(out.shape) == (B, T, 2 * H)
    assert tuple(st_f.shape) == tuple(st_b.shape) == (B, H)
    jout, (jf, jb) = jbi(JTensor(x))
    for a, b in ((out, jout), (st_f, jf), (st_b, jb)):
        _close(_np(a), _np(b), FWD)


def test_lstm_bptt_trains():
    """Gradients flow through the whole recurrence: a small LSTM learns
    the mean of its inputs over all steps."""
    B, T, I, H = 8, 6, 2, 16
    tpaddle.seed(7)

    class Net(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.lstm = tnn.LSTM(I, H, device=CPU)
            self.fc = tnn.Linear(H, 1, device=CPU)

        def forward(self, x):
            out, _ = self.lstm(x)
            return self.fc(out[:, -1])

    net = Net()
    opt = tpaddle.optimizer.Adam(5e-2, parameters=net.parameters())
    rng = np.random.RandomState(7)
    first = None
    for _ in range(60):
        x = rng.randn(B, T, I).astype(np.float32)
        y = x.sum(axis=(1, 2))[:, None] / T
        loss = tnn.MSELoss()(net(torch.tensor(x)), torch.tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        if first is None:
            first = float(loss.detach())
    assert float(loss.detach()) < 0.5 * first


def test_time_major_layout():
    B, T, I, H = 2, 5, 3, 4
    tpaddle.seed(8)
    bm = tnn.LSTM(I, H, device=CPU)
    tm = tnn.LSTM(I, H, time_major=True, device=CPU)
    tm.set_state_dict(bm.state_dict())
    x = _x(8, B, T, I)
    out_bm, (h1, _) = bm(torch.tensor(x))
    out_tm, (h2, _) = tm(torch.tensor(np.swapaxes(x, 0, 1)))
    np.testing.assert_allclose(_np(out_tm), np.swapaxes(_np(out_bm), 0, 1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(h1), _np(h2), rtol=1e-5)


def test_custom_cell_rnn_masks_sequence_length():
    class MyCell(tnn.RNNCellBase):
        def __init__(self, i, h):
            super().__init__()
            self.hidden_size = h
            self.fc = tnn.Linear(i + h, h, device=CPU)

        def forward(self, x, states=None):
            if states is None:
                states = self.get_initial_states(x)
            h = torch.tanh(self.fc(torch.cat([x, states], -1)))
            return h, h

    B, T, I, H = 2, 6, 3, 4
    tpaddle.seed(14)
    rnn = tnn.RNN(MyCell(I, H))
    x = _x(14, B, T, I)
    lens = torch.tensor([3, 6])
    out, h = rnn(torch.tensor(x), sequence_length=lens)
    o = _np(out)
    np.testing.assert_allclose(o[0, 3:], 0.0, atol=1e-7)
    assert np.abs(o[1, 3:]).sum() > 0
    _, h2 = rnn(torch.tensor(x[:1, :3]))
    np.testing.assert_allclose(_np(h)[0], _np(h2)[0], rtol=1e-5, atol=1e-6)
    rev = tnn.RNN(rnn.cell, is_reverse=True)
    _, hr = rev(torch.tensor(x), sequence_length=lens)
    _, hr2 = rev(torch.tensor(x[:1, :3]))
    np.testing.assert_allclose(_np(hr)[0], _np(hr2)[0], rtol=1e-5, atol=1e-6)


def test_rnn_cell_bias_false_drops_both():
    cell = tnn.LSTMCell(3, 4, bias_hh_attr=False, device=CPU)
    assert cell.bias_ih is None and cell.bias_hh is None
    assert len(cell.parameters()) == 2
    jcell = jnn.LSTMCell(3, 4, bias_hh_attr=False)
    assert list(jcell.state_dict()) == list(cell.state_dict())


@pytest.mark.parametrize("name", ["SimpleRNN", "LSTM", "GRU"])
def test_ragged_gradients_both_directions_match_jax(name):
    """Two bidirectional layers with ragged lengths and initial states:
    outputs, final states and the gradient of the input, the initial
    states and every weight, against the JAX layer."""
    B, T, I, H, L = 3, 6, 4, 5, 2
    jl, tl = _pair(name, I, H, num_layers=L, direction="bidirectional",
                   seed=20)
    rng = np.random.RandomState(21)
    x = rng.randn(B, T, I).astype(np.float32)
    lens = np.array([6, 2, 4], np.int64)
    h0 = rng.randn(2 * L, B, H).astype(np.float32)
    c0 = rng.randn(2 * L, B, H).astype(np.float32)
    lstm = name == "LSTM"
    jin = [jpaddle.to_tensor(a, stop_gradient=False) for a in (x, h0, c0)]
    tin = [torch.tensor(a, requires_grad=True) for a in (x, h0, c0)]
    jout, jst = jl(jin[0], (jin[1], jin[2]) if lstm else jin[1],
                   JTensor(lens))
    out, st = tl(tin[0], (tin[1], tin[2]) if lstm else tin[1],
                 torch.tensor(lens))
    jh = jst[0] if lstm else jst
    h = st[0] if lstm else st
    _close(_np(out), _np(jout), FWD, "out")
    _close(_np(h), _np(jh), FWD, "h")
    assert not _np(out)[1, 2:].any()
    g = rng.randn(B, T, 2 * H).astype(np.float32)
    gh = rng.randn(2 * L, B, H).astype(np.float32)
    ((jout * jpaddle.to_tensor(g)).sum()
     + (jh * jpaddle.to_tensor(gh)).sum()).backward()
    ((out * torch.tensor(g)).sum() + (h * torch.tensor(gh)).sum()).backward()
    for i in range(3 if lstm else 2):
        _close(tin[i].grad.numpy(), _np(jin[i].grad), GRAD, f"input {i}")
    jp = dict(jl.named_parameters())
    for n, p in tl.named_parameters():
        _close(p.grad.numpy(), _np(jp[n].grad), GRAD, n)
