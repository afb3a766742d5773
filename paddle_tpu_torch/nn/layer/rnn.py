"""Recurrent layers (counterpart of paddle_tpu/nn/layer/rnn.py):
RNNCellBase, SimpleRNNCell, LSTMCell, GRUCell, RNN, BiRNN, SimpleRNN,
LSTM and GRU, with the reference's parameter names, shapes, state_dict
keys and order, and initial values drawn uniform in +-1/sqrt(hidden).

The gates are the reference's (:120-146), which are also ATen's: LSTM
i, f, g, o with c' = f c + i g, h' = o tanh(c'); GRU r, z, n with
n = tanh(W_in x + b_in + r (W_hn h + b_hn)) and h' = (1 - z) n + z h.

`LSTM` / `GRU` / `SimpleRNN` run the reference's time loop (one
`lax.scan` a layer and direction, plain XLA, no Pallas kernel) as ATen's
fused recurrence, `torch.lstm` / `gru` / `rnn_tanh` / `rnn_relu` (cuDNN
on the card), one layer at a time with the port's own dropout between
layers.  There is no fallback: on a CUDA tensor the fused recurrence runs
or raises.  `plain_forward` keeps the reference's per-step loop over the
step functions beside it, as the oracle the tests and the chip check
hold it against; no model path calls it.

Every weight is read by its attribute name at each call, so
`torch.func.functional_call` (the hapi static-mode adapter's) computes
with the tensors it substitutes.

Reference behaviour the port keeps, and where it differs (ROADMAP
queue 3):
- `get_initial_states` makes float32 states whatever `dtype` says.
- `LSTM` / `GRU` / `SimpleRNN` run forward pre-hooks only and return
  `(y, (h, c))` for LSTM, `(y, h)` otherwise; `RNN` steps its cell in a
  Python loop.
- `sequence_length` is accepted and not read by the reference, which is
  exact only when every length is the full one: the port takes None or
  full lengths (one host read) and raises NotImplementedError on a
  shorter one.
- The reference draws its dropout between layers with the fixed key
  `PRNGKey(layer)`, the same mask on every call; the port draws a fresh
  mask each call from its generator (`functional.rng_scope` or the
  layer's own), so parity holds at dropout 0.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import functional as F
from ..initializer import Uniform
from .layers import Layer


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0):
        """States of `batch_ref`'s batch size, float32 (as the
        reference's, whatever `dtype` says), on its device; a tuple of
        them when `shape` (default: the cell's `state_shape`) is a list
        of shapes."""
        batch = batch_ref.shape[0]
        shape = shape or self.state_shape

        def make(s):
            return torch.full([batch] + list(s), float(init_value),
                              dtype=torch.float32, device=batch_ref.device)

        if isinstance(shape, (list, tuple)) and isinstance(
                shape[0], (list, tuple)):
            return tuple(make(s) for s in shape)
        return make(shape)


def _std_uniform(hidden_size):
    std = 1.0 / math.sqrt(hidden_size)
    return Uniform(-std, std)


def _gates(x, h, wi, wh, bi, bh):
    return x @ wi.t() + bi + h @ wh.t() + bh


def _simple_step(x, h, wi, wh, bi, bh, relu=False):
    pre = _gates(x, h, wi, wh, bi, bh)
    return torch.relu(pre) if relu else torch.tanh(pre)


def _lstm_step(x, h, c, wi, wh, bi, bh):
    i, f, g, o = torch.chunk(_gates(x, h, wi, wh, bi, bh), 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _gru_step(x, h, wi, wh, bi, bh):
    ir, iz, ic = torch.chunk(x @ wi.t() + bi, 3, dim=-1)
    hr, hz, hc = torch.chunk(h @ wh.t() + bh, 3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(ic + r * hc)
    return (1 - z) * n + z * h


class _CellWeights(RNNCellBase):
    """weight_ih (G*H, I), weight_hh (G*H, H), bias_ih, bias_hh (G*H,)."""

    GATES = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g, init = self.GATES * hidden_size, _std_uniform(hidden_size)
        kw = dict(default_initializer=init, generator=generator)
        self.weight_ih = self.create_parameter([g, input_size],
                                               weight_ih_attr, **kw)
        self.weight_hh = self.create_parameter([g, hidden_size],
                                               weight_hh_attr, **kw)
        self.bias_ih = self.create_parameter([g], bias_ih_attr,
                                             is_bias=True, **kw)
        self.bias_hh = self.create_parameter([g], bias_hh_attr,
                                             is_bias=True, **kw)
        self.input_size = input_size
        self.hidden_size = hidden_size

    def _w(self):
        return self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh


class SimpleRNNCell(_CellWeights):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, generator=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, name,
                         generator=generator)
        self.activation = activation

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = _simple_step(inputs, states, *self._w(),
                         relu=self.activation != "tanh")
        return h, h


class LSTMCell(_CellWeights):
    GATES = 4

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = states
        h_new, c_new = _lstm_step(inputs, h, c, *self._w())
        return h_new, (h_new, c_new)


class GRUCell(_CellWeights):
    GATES = 3

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = _gru_step(inputs, states, *self._w())
        return h, h


def _check_lengths(sequence_length, steps):
    """Lengths are accepted only where the reference, which does not
    read them, is exact: None, or every one the full `steps` (one host
    read)."""
    if sequence_length is None:
        return
    lengths = torch.as_tensor(sequence_length)
    if bool((lengths != steps).any()):
        raise NotImplementedError(
            "sequence_length shorter than the input's time steps: the "
            "reference does not read sequence_length, so its states run "
            "on over the padding")


_FUSED = {"LSTM": torch.lstm, "GRU": torch.gru,
          "RNN_TANH": torch.rnn_tanh, "RNN_RELU": torch.rnn_relu}


class _ScanRNNBase(Layer):
    """Multi-layer, optionally bidirectional recurrence.  mode is LSTM,
    GRU, RNN_TANH or RNN_RELU; the weights of (layer, direction) are
    `weight_ih_l{layer}[_reverse]`, `weight_hh_l...`, `bias_ih_l...`,
    `bias_hh_l...`, registered in that order (:206-226)."""

    GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.generator = generator
        self.bidirect = direction in ("bidirect", "bidirectional")
        ndir = 2 if self.bidirect else 1
        g = self.GATES[mode] * hidden_size
        kw = dict(default_initializer=_std_uniform(hidden_size),
                  generator=generator)
        self._weight_names = []
        for layer in range(num_layers):
            for d in range(ndir):
                in_sz = input_size if layer == 0 else hidden_size * ndir
                sfx = f"{layer}" + ("_reverse" if d else "")
                names = (f"weight_ih_l{sfx}", f"weight_hh_l{sfx}",
                         f"bias_ih_l{sfx}", f"bias_hh_l{sfx}")
                for n, shape, attr, bias in zip(
                        names, ([g, in_sz], [g, hidden_size], [g], [g]),
                        (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                         bias_hh_attr), (False, False, True, True)):
                    self.add_parameter(n, self.create_parameter(
                        shape, attr, is_bias=bias, **kw))
                self._weight_names.append(names)

    def _weights(self, idx):
        """(wi, wh, bi, bh) of layer-direction `idx`, read by name at each
        call (what functional_call substitutes)."""
        return tuple(getattr(self, n) for n in self._weight_names[idx])

    def _prepare(self, inputs, initial_states, sequence_length):
        x = inputs if self.time_major else inputs.transpose(0, 1)
        _check_lengths(sequence_length, x.shape[0])
        n = self.num_layers * (2 if self.bidirect else 1)
        h0 = c0 = None
        if initial_states is not None:
            if self.mode == "LSTM":
                h0, c0 = initial_states
            else:
                h0 = initial_states
        if h0 is None:
            h0 = x.new_zeros((n, x.shape[1], self.hidden_size))
        if c0 is None and self.mode == "LSTM":
            c0 = torch.zeros_like(h0)
        return x, h0, c0

    def _between_layers(self, x, layer):
        if self.training and self.dropout and layer < self.num_layers - 1:
            return F.dropout(x, self.dropout, training=True,
                             generator=self.generator)
        return x

    def _finish(self, x, hs, cs):
        y = x if self.time_major else x.transpose(0, 1)
        h = torch.cat(hs, 0)
        return (y, h, torch.cat(cs, 0)) if self.mode == "LSTM" else (y, h)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        """The fused recurrence, one layer (both directions) at a time.
        Returns (y, h, c) for LSTM and (y, h) otherwise; h and c are
        (num_layers * num_directions, batch, hidden)."""
        x, h0, c0 = self._prepare(inputs, initial_states, sequence_length)
        ndir = 2 if self.bidirect else 1
        fused = _FUSED[self.mode]
        hs, cs = [], []
        for layer in range(self.num_layers):
            rows = slice(layer * ndir, (layer + 1) * ndir)
            params = [w for d in range(ndir)
                      for w in self._weights(layer * ndir + d)]
            hx = (h0[rows], c0[rows]) if self.mode == "LSTM" else h0[rows]
            out = fused(x.contiguous(), hx, params, True, 1, 0.0,
                        self.training, self.bidirect, False)
            x = out[0]
            hs.append(out[1])
            if self.mode == "LSTM":
                cs.append(out[2])
            x = self._between_layers(x, layer)
        return self._finish(x, hs, cs)

    def plain_forward(self, inputs, initial_states=None,
                      sequence_length=None):
        """The reference's per-step loop over the step functions
        (:251-305), with the same dropout between layers as `forward`:
        the oracle of the fused path, on any device."""
        x, h0, c0 = self._prepare(inputs, initial_states, sequence_length)
        ndir = 2 if self.bidirect else 1
        hs, cs = [], []
        for layer in range(self.num_layers):
            outs = []
            for d in range(ndir):
                idx = layer * ndir + d
                w = self._weights(idx)
                h = h0[idx]
                c = c0[idx] if self.mode == "LSTM" else None
                ys = []
                for t in (reversed(range(x.shape[0])) if d
                          else range(x.shape[0])):
                    if self.mode == "LSTM":
                        h, c = _lstm_step(x[t], h, c, *w)
                    elif self.mode == "GRU":
                        h = _gru_step(x[t], h, *w)
                    else:
                        h = _simple_step(x[t], h, *w,
                                         relu=self.mode == "RNN_RELU")
                    ys.append(h)
                outs.append(torch.stack(ys[::-1] if d else ys, 0))
                hs.append(h[None])
                if c is not None:
                    cs.append(c[None])
            x = torch.cat(outs, -1) if ndir == 2 else outs[0]
            x = self._between_layers(x, layer)
        return self._finish(x, hs, cs)

    def __call__(self, inputs, initial_states=None, sequence_length=None):
        """Forward pre-hooks, then forward, restructured as the
        reference's (:310-320): (y, (h, c)) for LSTM, (y, h) otherwise."""
        for hook in self._forward_pre_hooks.values():
            hook(self, (inputs,))
        outs = self.forward(inputs, initial_states, sequence_length)
        if len(outs) == 3:
            return outs[0], (outs[1], outs[2])
        return outs


class LSTM(_ScanRNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class GRU(_ScanRNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class SimpleRNN(_ScanRNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class RNN(Layer):
    """A cell stepped over time in a Python loop (:348-380)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        steps = inputs.shape[0 if self.time_major else 1]
        _check_lengths(sequence_length, steps)
        outputs, states = [], initial_states
        for t in (range(steps - 1, -1, -1) if self.is_reverse
                  else range(steps)):
            out, states = self.cell(inputs[t] if self.time_major
                                    else inputs[:, t], states)
            outputs.append(out)
        if self.is_reverse:
            outputs = outputs[::-1]
        return torch.stack(outputs, 0 if self.time_major else 1), states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        sf = sb = None
        if initial_states is not None:
            sf, sb = initial_states
        yf, stf = self.rnn_fw(inputs, sf, sequence_length)
        yb, stb = self.rnn_bw(inputs, sb, sequence_length)
        return torch.cat([yf, yb], -1), (stf, stb)
