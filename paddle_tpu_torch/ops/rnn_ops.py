"""Recurrent sequence op (counterpart of
``paddle_tpu/ops/impl/rnn_ops.py``).

``rnn`` sweeps a multi-layer, optionally bidirectional LSTM, GRU or
simple RNN over a sequence with the JAX package's equations, gate order
and weight layout (per (layer, direction): ``w_ih [G*H, I]``, ``w_hh
[G*H, H]``, ``b_ih [G*H]``, ``b_hh [G*H]``; LSTM gates i, f, g, o; GRU
r, z, c with the reset gate applied to the hidden projection,
``tanh(ci + r * (h w_hh^T + b_hh))``). The JAX op runs one ``lax.scan``
per (layer, direction); here the input projection of every step is one
product and a Python loop runs the steps (cuBLAS products and eager
elementwise kernels on the card; cuDNN's RNN is not used).

Between layers, ``dropout`` in training draws its keep mask from
``generator`` (the device's default generator when None), as the JAX
op draws from its key: the same seed gives other masks in the two.
"""
from __future__ import annotations

import torch

__all__ = ["rnn"]

# mode -> (gates, states)
_MODES = {"LSTM": (4, 2), "GRU": (3, 1), "RNN_TANH": (1, 1),
          "RNN_RELU": (1, 1)}


def _sweep(x, states, mode, w_ih, w_hh, b_ih, b_hh, reverse):
    """x [T, N, I], states (h,) or (h, c) of [N, H] -> (final states,
    outputs [T, N, H])."""
    steps = x.shape[0]
    xw = x @ w_ih.T + b_ih                       # every step at once
    if mode != "GRU":
        xw = xw + b_hh
    outs = [None] * steps
    order = range(steps - 1, -1, -1) if reverse else range(steps)
    if mode == "LSTM":
        h, c = states
        for t in order:
            i, f, g, o = (xw[t] + h @ w_hh.T).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs[t] = h
        final = (h, c)
    elif mode == "GRU":
        (h,) = states
        for t in order:
            ri, zi, ci = xw[t].chunk(3, dim=-1)
            rh, zh, ch = (h @ w_hh.T + b_hh).chunk(3, dim=-1)
            r = torch.sigmoid(ri + rh)
            z = torch.sigmoid(zi + zh)
            cand = torch.tanh(ci + r * ch)
            h = (1 - z) * cand + z * h
            outs[t] = h
        final = (h,)
    else:
        act = torch.tanh if mode == "RNN_TANH" else torch.relu
        (h,) = states
        for t in order:
            h = act(xw[t] + h @ w_hh.T)
            outs[t] = h
        final = (h,)
    return final, torch.stack(outs)


def rnn(x, initial_states, weight_list, mode="LSTM", num_layers=1,
        time_major=False, dropout=0.0, bidirectional=False, training=True,
        name=None, *, generator=None):
    """Multi-layer (bi)directional recurrent sweep.

    x [N, T, I] ([T, N, I] when ``time_major``); ``initial_states`` [h0]
    or [h0, c0], each [num_layers * D, N, H]; ``weight_list`` flat per
    (layer, direction): w_ih, w_hh, b_ih, b_hh. Returns (out, h_n) or
    (out, h_n, c_n), out [N, T, D * H] ([T, N, D * H] when
    ``time_major``)."""
    if mode not in _MODES:
        raise ValueError(f"rnn: mode must be one of {sorted(_MODES)}, "
                         f"got {mode!r}")
    _, n_states = _MODES[mode]
    d = 2 if bidirectional else 1
    if not time_major:
        x = x.transpose(0, 1)
    h0 = initial_states[0]
    c0 = initial_states[1] if n_states == 2 else None
    layer_in = x
    finals_h, finals_c = [], []
    for layer in range(num_layers):
        outs = []
        for direction in range(d):
            idx = layer * d + direction
            states = (h0[idx],) if n_states == 1 else (h0[idx], c0[idx])
            final, ys = _sweep(layer_in, states, mode,
                               *weight_list[idx * 4:idx * 4 + 4],
                               reverse=bool(direction))
            outs.append(ys)
            finals_h.append(final[0])
            if n_states == 2:
                finals_c.append(final[1])
        layer_in = outs[0] if d == 1 else torch.cat(outs, dim=-1)
        if dropout > 0.0 and training and layer < num_layers - 1:
            keep = torch.empty_like(layer_in).bernoulli_(
                1.0 - dropout, generator=generator)
            layer_in = layer_in * keep / (1.0 - dropout)
    out = layer_in if time_major else layer_in.transpose(0, 1)
    if n_states == 2:
        return out, torch.stack(finals_h), torch.stack(finals_c)
    return out, torch.stack(finals_h)
