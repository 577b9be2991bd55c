"""Recurrent layers (counterpart of ``paddle_tpu/nn/rnn.py``): the cells
``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``; ``RNN`` and ``BiRNN`` over
a cell; ``SimpleRNN``, ``LSTM`` and ``GRU`` stacks.

Each direction of each layer of a built-in cell runs one function of
``ops/rnn_ops.py`` (the recurrence written out in torch: its docstring
says why not cuDNN's RNN); a custom cell runs step by step with the
same ``sequence_length`` masking.  Parameter names are the JAX
package's (``cells.<layer * directions + direction>.weight_ih`` ...),
so a state dict carries over by name (``Layer.set_state_dict``).
Every layer takes ``device=`` (None: the card) and ``generator=``,
keyword only.
"""

from __future__ import annotations

import math

import torch

from ..ops import nn_ops
from ..ops import rnn_ops as R
from . import initializer as I
from .container import LayerList
from .layer import Layer, to_torch_dtype

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """``init_value``-filled states ``[batch, hidden_size]`` (or
        ``shape``, -1/None taking the batch size of ``batch_ref``), fp32
        unless ``dtype``, on ``batch_ref``'s device: a pair for the
        LSTM."""
        batch = batch_ref.shape[batch_dim_idx]
        if shape is not None:
            shp = [batch if s in (None, -1) else int(s) for s in shape]
        else:
            shp = [batch, self.hidden_size]
        dt = to_torch_dtype(dtype) or torch.float32
        n = getattr(self, "state_components", 1)
        states = [torch.full(shp, init_value, dtype=dt,
                             device=batch_ref.device) for _ in range(n)]
        return tuple(states) if n > 1 else states[0]


class _BuiltinCell(RNNCellBase):
    GATES = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, generator=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        g = self.GATES
        k = 1.0 / math.sqrt(hidden_size)
        init = I.Uniform(-k, k)
        kw = dict(default_initializer=init, device=device,
                  generator=generator)
        self.weight_ih = self.create_parameter(
            [g * hidden_size, input_size], attr=weight_ih_attr, **kw)
        self.weight_hh = self.create_parameter(
            [g * hidden_size, hidden_size], attr=weight_hh_attr, **kw)
        if bias_ih_attr is False or bias_hh_attr is False:
            # both biases go when either attr is False, as upstream's
            self.bias_ih = self.bias_hh = None
        else:
            self.bias_ih = self.create_parameter(
                [g * hidden_size], attr=bias_ih_attr, is_bias=True, **kw)
            self.bias_hh = self.create_parameter(
                [g * hidden_size], attr=bias_hh_attr, is_bias=True, **kw)

    def extra_repr(self):
        return f"{self.input_size}, {self.hidden_size}"

    def _proj(self, inputs, h):
        return (torch.matmul(inputs, self.weight_ih.t()),
                torch.matmul(h, self.weight_hh.t()))


class SimpleRNNCell(_BuiltinCell):
    GATES = 1
    state_components = 1

    def __init__(self, input_size, hidden_size, activation="tanh", **kw):
        super().__init__(input_size, hidden_size, **kw)
        if activation not in ("tanh", "relu"):
            raise ValueError("activation must be tanh or relu")
        self.activation = activation

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        xi, hh = self._proj(inputs, states)
        pre = xi + hh
        if self.bias_ih is not None:
            pre = pre + self.bias_ih + self.bias_hh
        h = torch.tanh(pre) if self.activation == "tanh" else \
            torch.relu(pre)
        return h, h


class LSTMCell(_BuiltinCell):
    GATES = 4
    state_components = 2

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = states
        xi, hh = self._proj(inputs, h)
        gates = xi + hh
        if self.bias_ih is not None:
            gates = gates + self.bias_ih + self.bias_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, (h_new, c_new)


class GRUCell(_BuiltinCell):
    GATES = 3
    state_components = 1

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = states
        gi, gh = self._proj(inputs, h)
        if self.bias_ih is not None:
            gi = gi + self.bias_ih
            gh = gh + self.bias_hh
        ir, iz, ic = gi.chunk(3, dim=-1)
        hr, hz, hc = gh.chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        c = torch.tanh(ic + r * hc)
        h_new = (1.0 - z) * c + z * h
        return h_new, h_new


def _cell_scan(cell, x, states, seq_lens, reverse, time_major):
    """One direction of a built-in cell over ``x``: (outputs, final
    states) from its ``ops/rnn_ops.py`` function."""
    args = (x, cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh)
    kw = dict(seq_lens=seq_lens, reverse=reverse, time_major=time_major)
    if isinstance(cell, LSTMCell):
        h0, c0 = states
        out, h, c = R.lstm_layer(*args, h0, c0, **kw)
        return out, (h, c)
    if isinstance(cell, GRUCell):
        return R.gru_layer(*args, states, **kw)
    return R.simple_rnn_layer(*args, states, activation=cell.activation,
                              **kw)


class RNN(Layer):
    """A cell run over the steps of ``inputs`` (``[B, T, I]``, or ``[T,
    B, I]`` if ``time_major``), forward or from the last step
    (``is_reverse``); ``sequence_length`` holds each sequence's state
    and zeroes its output past its length.  Returns (outputs, final
    states)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        cell = self.cell
        if initial_states is None:
            ref = inputs.transpose(0, 1) if self.time_major else inputs
            initial_states = cell.get_initial_states(ref)
        if isinstance(cell, (SimpleRNNCell, LSTMCell, GRUCell)):
            return _cell_scan(cell, inputs, initial_states, sequence_length,
                              self.is_reverse, self.time_major)
        xs = inputs if self.time_major else inputs.transpose(0, 1)
        T = xs.shape[0]
        order = range(T - 1, -1, -1) if self.is_reverse else range(T)
        seq = None if sequence_length is None else \
            torch.as_tensor(sequence_length, device=inputs.device)
        states = initial_states
        outs = [None] * T

        def held(new, old, keep):
            if isinstance(new, (tuple, list)):
                return type(new)(held(n, o, keep) for n, o in zip(new, old))
            return torch.where(keep, new, old)

        for t in order:
            out, new_states = cell(xs[t], states)
            if seq is not None:
                keep = (seq > t)[:, None]
                new_states = held(new_states, states, keep)
                out = torch.where(keep, out, torch.zeros_like(out))
            states = new_states
            outs[t] = out
        out = torch.stack(outs, 0)
        return (out if self.time_major else out.transpose(0, 1)), states


class BiRNN(Layer):
    """Two cells, one forward and one from the last step; outputs joined
    on the feature axis, states as ``(fw, bw)``."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        s_fw = s_bw = None
        if initial_states is not None:
            s_fw, s_bw = initial_states
        out_f, st_f = self.rnn_fw(inputs, s_fw, sequence_length)
        out_b, st_b = self.rnn_bw(inputs, s_bw, sequence_length)
        return torch.cat([out_f, out_b], dim=-1), (st_f, st_b)


class _RNNBase(Layer):
    """``num_layers`` layers of one or two directions (``direction``
    "forward", "bidirect" or "bidirectional") with dropout between
    layers while training.  Initial and final states are ``[layers *
    directions, B, H]`` (a pair for the LSTM)."""

    CELL = None

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 device=None, generator=None, **cell_kw):
        super().__init__()
        if direction in ("bidirect", "bidirectional"):
            self.num_directions = 2
        elif direction == "forward":
            self.num_directions = 1
        else:
            raise ValueError(f"direction must be 'forward' or 'bidirect', "
                             f"got {direction!r}")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        cells = []
        for layer in range(num_layers):
            for _ in range(self.num_directions):
                in_size = input_size if layer == 0 else \
                    hidden_size * self.num_directions
                cells.append(self.CELL(
                    in_size, hidden_size, weight_ih_attr=weight_ih_attr,
                    weight_hh_attr=weight_hh_attr,
                    bias_ih_attr=bias_ih_attr, bias_hh_attr=bias_hh_attr,
                    device=device, generator=generator, **cell_kw))
        self.cells = LayerList(cells)

    def _cell(self, layer, direction):
        return self.cells[layer * self.num_directions + direction]

    def forward(self, inputs, initial_states=None, sequence_length=None):
        D, L = self.num_directions, self.num_layers
        ncomp = self.CELL.state_components
        batch_ref = inputs.transpose(0, 1) if self.time_major else inputs

        def init_for(idx):
            if initial_states is None:
                return self._cell(0, 0).get_initial_states(batch_ref)
            if ncomp == 2:
                h, c = initial_states
                return (h[idx], c[idx])
            return initial_states[idx]

        x = inputs
        final = []
        for layer in range(L):
            outs = []
            for d in range(D):
                out, st = _cell_scan(self._cell(layer, d), x,
                                     init_for(layer * D + d),
                                     sequence_length, reverse=(d == 1),
                                     time_major=self.time_major)
                outs.append(out)
                final.append(st)
            x = outs[0] if D == 1 else torch.cat(outs, dim=-1)
            if self.dropout > 0 and layer < L - 1:
                x = nn_ops.dropout(x, self.dropout, training=self.training)
        if ncomp == 2:
            return x, (torch.stack([s[0] for s in final], 0),
                       torch.stack([s[1] for s in final], 0))
        return x, torch.stack(final, 0)


class SimpleRNN(_RNNBase):
    CELL = SimpleRNNCell

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, activation=activation, **kw)


class LSTM(_RNNBase):
    CELL = LSTMCell


class GRU(_RNNBase):
    CELL = GRUCell
