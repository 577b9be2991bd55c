"""Recurrent layer functions (counterpart of ``paddle_tpu/ops/
rnn_ops.py``): one direction of one layer of an LSTM, a GRU or a plain
RNN over a batch.

The JAX functions are a ``lax.scan``; here the same recurrence is a
loop over the time steps, each a matmul of the state and the gate
arithmetic, after one matmul of every step's input.  So the form is
the same on the CPU and the card, a captured training step holds it
as it is (no host read, no weights flattened into a library buffer),
its backward is autograd's (no atomics: replays repeat bit for bit),
and ``seq_lens`` keeps the JAX semantics: it is a device tensor, the
state holds and the output is 0 at a step past a sequence's length,
and the reverse direction runs from the last step, so each sequence's
reverse pass starts at its own end.  Gate order (i, f, g, o) for the
LSTM and (r, z, c) for the GRU, with the reset gate on the hidden
projection, as cuDNN's and the JAX functions'.  The inputs are cast by
the AMP rule first (the JAX primitives are): under O2 the scan runs in
bf16, as the JAX one does.
"""

from __future__ import annotations

import torch

from ..amp.auto_cast import cast_inputs


def _scan(step, x, carry, seq_lens, reverse, time_major, w_ih, b):
    """Run ``step(carry, xw_t) -> (new_carry, out_t)`` over the steps of
    ``x`` (``[B, T, I]``, or ``[T, B, I]`` if ``time_major``), where
    ``xw_t`` is step t's ``x @ w_ih.T`` (+ ``b``): masked by ``seq_lens``
    (each carry tensor held, the output 0, at a step past a sequence's
    length), forward or from the last step.  Returns the outputs in
    ``x``'s layout and the last carry."""
    xs = x if time_major else x.transpose(0, 1)
    xw = torch.matmul(xs, w_ih.t())
    if b is not None:
        xw = xw + b
    steps = range(xs.shape[0] - 1, -1, -1) if reverse else range(xs.shape[0])
    lens = None if seq_lens is None else \
        torch.as_tensor(seq_lens, device=x.device)
    outs = [None] * xs.shape[0]
    for t in steps:
        new, out = step(carry, xw[t])
        if lens is not None:
            keep = (lens > t)[:, None]
            new = tuple(torch.where(keep, n, c) for n, c in zip(new, carry))
            out = torch.where(keep, new[0], torch.zeros_like(new[0]))
        carry = new
        outs[t] = out
    out = torch.stack(outs, 0)
    return (out if time_major else out.transpose(0, 1)), carry


def lstm_layer(x, w_ih, w_hh, b_ih, b_hh, h0, c0, seq_lens=None,
               reverse=False, time_major=False):
    """One LSTM direction-layer: ``w_ih`` ``[4H, I]``, ``w_hh`` ``[4H,
    H]``, gates (i, f, g, o).  Returns (outputs ``[B, T, H]``, h_T,
    c_T)."""
    x, w_ih, w_hh, b_ih, b_hh, h0, c0 = cast_inputs(
        "lstm_layer", x, w_ih, w_hh, b_ih, b_hh, h0, c0)
    w_hh_t = w_hh.t()

    def step(carry, xw):
        h, c = carry
        gates = xw + torch.matmul(h, w_hh_t)
        if b_ih is not None:
            gates = gates + b_ih + b_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return (h_new, c_new), h_new

    out, (h, c) = _scan(step, x, (h0, c0), seq_lens, reverse, time_major,
                        w_ih, None)
    return out, h, c


def gru_layer(x, w_ih, w_hh, b_ih, b_hh, h0, seq_lens=None, reverse=False,
              time_major=False):
    """One GRU direction-layer: ``w_ih`` ``[3H, I]``, gates (r, z, c),
    the candidate ``tanh(x W_c + b_ic + r * (h W_hc + b_hc))``.  Returns
    (outputs, h_T)."""
    x, w_ih, w_hh, b_ih, b_hh, h0 = cast_inputs(
        "gru_layer", x, w_ih, w_hh, b_ih, b_hh, h0)
    w_hh_t = w_hh.t()

    def step(carry, gi):
        (h,) = carry
        gh = torch.matmul(h, w_hh_t)
        if b_hh is not None:
            gh = gh + b_hh
        ir, iz, ic = gi.chunk(3, dim=-1)
        hr, hz, hc = gh.chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        c = torch.tanh(ic + r * hc)
        h_new = (1.0 - z) * c + z * h
        return (h_new,), h_new

    out, (h,) = _scan(step, x, (h0,), seq_lens, reverse, time_major, w_ih,
                      b_ih)
    return out, h


def simple_rnn_layer(x, w_ih, w_hh, b_ih, b_hh, h0, seq_lens=None,
                     reverse=False, time_major=False, activation="tanh"):
    """One plain-RNN direction-layer: ``h' = act(x W_i^T + h W_h^T + b_ih
    + b_hh)``, ``act`` tanh or relu.  Returns (outputs, h_T)."""
    x, w_ih, w_hh, b_ih, b_hh, h0 = cast_inputs(
        "simple_rnn_layer", x, w_ih, w_hh, b_ih, b_hh, h0)
    act = torch.tanh if activation == "tanh" else torch.relu
    w_hh_t = w_hh.t()

    def step(carry, xw):
        (h,) = carry
        pre = xw + torch.matmul(h, w_hh_t)
        if b_ih is not None:
            pre = pre + b_ih + b_hh
        h_new = act(pre)
        return (h_new,), h_new

    out, (h,) = _scan(step, x, (h0,), seq_lens, reverse, time_major, w_ih,
                      None)
    return out, h
