"""Recurrent layers (counterpart of ``paddle_tpu/nn/layer/rnn.py``):
``RNNCellBase``, ``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``, the
cell-driven ``RNN`` and ``BiRNN``, and the multi-layer ``SimpleRNN``,
``LSTM`` and ``GRU``, which run the fused ``ops.rnn`` sweep.

Equations, gate order and parameter names and shapes are the JAX
package's (``weight_ih [G*H, I]``, ``weight_hh [G*H, H]``, ``bias_ih``,
``bias_hh [G*H]``; the multi-layer classes suffix ``_l{layer}`` and
``_reverse``), so a JAX state dict loads unchanged. As in the JAX
package, ``sequence_length`` is accepted and not applied (every step of
every sequence runs), and ``get_initial_states`` gives zeros; here of
the input's dtype and device unless ``dtype`` names one.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import ops as F
from .. import initializer as I
from ..parameter import ParamAttr
from .layers import Layer

__all__ = [
    "RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell",
    "RNN", "BiRNN", "SimpleRNN", "LSTM", "GRU",
]


class RNNCellBase(Layer):
    """``get_initial_states`` builds zero states of ``state_shape``."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        batch = batch_ref.shape[batch_dim_idx]
        dtype = I._dtype(dtype) if dtype is not None else batch_ref.dtype
        state_shape = getattr(self, "state_shape", (self.hidden_size,))

        def full(s):
            return torch.full([batch] + list(s), init_value, dtype=dtype,
                              device=batch_ref.device)

        if state_shape and isinstance(state_shape[0], (tuple, list)):
            return tuple(full(s) for s in state_shape)
        return full(state_shape)


def _uniform_attr(attr_in, std):
    attr = ParamAttr._to_attr(attr_in)
    if attr.initializer is None:
        attr.initializer = I.Uniform(-std, std)
    return attr


def _cell_params(layer, input_size, hidden_size, n_gates, weight_ih_attr,
                 weight_hh_attr, bias_ih_attr, bias_hh_attr):
    std = 1.0 / np.sqrt(hidden_size)
    for name, shape, attr_in in (
            ("weight_ih", [n_gates * hidden_size, input_size],
             weight_ih_attr),
            ("weight_hh", [n_gates * hidden_size, hidden_size],
             weight_hh_attr)):
        setattr(layer, name, layer.create_parameter(
            shape=shape, attr=_uniform_attr(attr_in, std)))
    for name, attr_in in (("bias_ih", bias_ih_attr),
                          ("bias_hh", bias_hh_attr)):
        if attr_in is False:
            layer.add_parameter(name, None)
            continue
        setattr(layer, name, layer.create_parameter(
            shape=[n_gates * hidden_size], attr=_uniform_attr(attr_in, std),
            is_bias=True))


def _project(x, w, b):
    y = x @ w.T
    return y if b is None else y + b


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        if activation not in ("tanh", "relu"):
            raise ValueError("activation must be tanh or relu")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = activation
        _cell_params(self, input_size, hidden_size, 1, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        z = (_project(inputs, self.weight_ih, self.bias_ih)
             + _project(states, self.weight_hh, self.bias_hh))
        h = torch.tanh(z) if self.activation == "tanh" else torch.relu(z)
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        _cell_params(self, input_size, hidden_size, 4, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = states
        gates = (_project(inputs, self.weight_ih, self.bias_ih)
                 + _project(h, self.weight_hh, self.bias_hh))
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        _cell_params(self, input_size, hidden_size, 3, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        ri, zi, ci = _project(inputs, self.weight_ih,
                              self.bias_ih).chunk(3, dim=-1)
        rh, zh, ch = _project(states, self.weight_hh,
                              self.bias_hh).chunk(3, dim=-1)
        r = torch.sigmoid(ri + rh)
        z = torch.sigmoid(zi + zh)
        c = torch.tanh(ci + r * ch)
        h = (1 - z) * c + z * states
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


class RNN(Layer):
    """A cell stepped over the time axis in a Python loop."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        axis = 0 if self.time_major else 1
        states = (initial_states if initial_states is not None
                  else self.cell.get_initial_states(
                      inputs, batch_dim_idx=1 if self.time_major else 0))
        steps = inputs.shape[axis]
        order = range(steps - 1, -1, -1) if self.is_reverse else range(steps)
        outs = []
        for t in order:
            out, states = self.cell(inputs.select(axis, t), states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return torch.stack(outs, dim=axis), states


class BiRNN(Layer):
    """A forward and a backward cell, outputs concatenated."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        states_fw = states_bw = None
        if initial_states is not None:
            states_fw, states_bw = initial_states
        out_fw, st_fw = self.rnn_fw(inputs, states_fw)
        out_bw, st_bw = self.rnn_bw(inputs, states_bw)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)


class _RNNBase(Layer):
    """Multi-layer layers over ``ops.rnn``."""

    _mode = "LSTM"
    _n_gates = 4
    _n_states = 2

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"bad direction {direction!r}")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = direction in ("bidirect", "bidirectional")
        self.time_major = time_major
        self.dropout = dropout
        d = 2 if self.bidirectional else 1
        std = 1.0 / np.sqrt(hidden_size)
        g = self._n_gates * hidden_size
        self._flat_names = []
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else hidden_size * d
            for direction_i in range(d):
                suffix = f"_l{layer}" + ("_reverse" if direction_i else "")
                for base, shape, attr_in, is_bias in (
                        ("weight_ih", [g, in_size], weight_ih_attr, False),
                        ("weight_hh", [g, hidden_size], weight_hh_attr,
                         False),
                        ("bias_ih", [g], bias_ih_attr, True),
                        ("bias_hh", [g], bias_hh_attr, True)):
                    self.add_parameter(base + suffix, self.create_parameter(
                        shape=shape, attr=_uniform_attr(attr_in, std),
                        is_bias=is_bias))
                    self._flat_names.append(base + suffix)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        d = 2 if self.bidirectional else 1
        batch = inputs.shape[1 if self.time_major else 0]
        if initial_states is None:
            h0 = inputs.new_zeros(
                (self.num_layers * d, batch, self.hidden_size))
            initial_states = ((h0, torch.zeros_like(h0))
                              if self._n_states == 2 else (h0,))
        elif not isinstance(initial_states, (tuple, list)):
            initial_states = (initial_states,)
        res = F.rnn(inputs, list(initial_states),
                    [getattr(self, n) for n in self._flat_names],
                    self._mode, self.num_layers, self.time_major,
                    self.dropout, self.bidirectional, self.training)
        if self._n_states == 2:
            return res[0], (res[1], res[2])
        return res[0], res[1]


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        self._mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        self._n_gates = 1
        self._n_states = 1
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, **kw)


class LSTM(_RNNBase):
    _mode = "LSTM"
    _n_gates = 4
    _n_states = 2


class GRU(_RNNBase):
    _mode = "GRU"
    _n_gates = 3
    _n_states = 1
