"""Recurrent layers of the port (``paddle_tpu/nn/layer/rnn.py``): the cells
``SimpleRNNCell``, ``LSTMCell`` and ``GRUCell``, the multi-layer
``SimpleRNN``, ``LSTM`` and ``GRU``, and ``RNN``, which runs a cell over
time.

The reference's names, layouts and gate order: a cell's ``weight_ih``
``[gates * hidden, in]`` and ``weight_hh`` ``[gates * hidden, hidden]``
(the transpose of ``Linear``'s ``[in, out]``; LSTM's gates ``i, f, g, o``,
GRU's ``r, z, c`` with the reset gate on the hidden projection), the
multi-layer stacks' ``weight_ih_l{l}_d{d}`` ... per layer and direction,
every weight and bias drawn ``Uniform(-1/sqrt(hidden), 1/sqrt(hidden))``
from ``generator`` (None: the current random stream). The time loop is a
plain loop of tensor ops, step by step as the reference's ``lax.scan``
(``_rnn_scan``) runs it; no TPU kernel is involved, so there is no CUDA
kernel here and no cuDNN RNN.

The reference accepts some arguments and never reads them (ROADMAP.md,
"Faults in the reference"): ``SimpleRNN``/``LSTM``/``GRU`` always start
from zeros (``initial_states`` ignored), run every step of every row
(``sequence_length`` ignored), apply no ``dropout`` between layers, and
drop every other keyword (``activation``, the ``*_attr``s); ``RNN``
ignores ``sequence_length``; a cell's ``*_attr=False`` still makes the
parameter. The port raises ``NotImplementedError`` for each of those
instead of ignoring it, and does not implement what the reference does not.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...framework.device import resolve_device
from .. import initializer as I
from ._attr import param

__all__ = ["SimpleRNNCell", "LSTMCell", "GRUCell", "SimpleRNN", "LSTM", "GRU", "RNN"]

FAULT = ("the reference accepts {} and never reads it (ROADMAP.md, 'Faults in the reference'); "
         "the port raises instead of ignoring it")


def _ignored(what):
    raise NotImplementedError(FAULT.format(what))


def _cell_params(module, gates, input_size, hidden_size, attrs, device, generator):
    std = 1.0 / math.sqrt(hidden_size)
    u = I.Uniform(-std, std)
    shapes = {"weight_ih": (gates * hidden_size, input_size),
              "weight_hh": (gates * hidden_size, hidden_size),
              "bias_ih": (gates * hidden_size,), "bias_hh": (gates * hidden_size,)}
    name = type(module).__name__
    for what, attr in zip(shapes, attrs):
        if attr is False:
            _ignored(f"{name}({what}_attr=False) (it makes the parameter all the same)")
        setattr(module, what, param(shapes[what], attr, u, generator, device, layer=name,
                                    what=what))


def _rnn_step(x, h, wih, whh, bih, bhh, act):
    return act(x @ wih.T + bih + h @ whh.T + bhh)


def _lstm_step(x, h, c, wih, whh, bih, bhh):
    i, f, g, o = (x @ wih.T + bih + h @ whh.T + bhh).chunk(4, dim=-1)
    i, f, o, g = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o), torch.tanh(g)
    c2 = f * c + i * g
    return o * torch.tanh(c2), c2


def _gru_step(x, h, wih, whh, bih, bhh):
    ir, iz, ic = (x @ wih.T + bih).chunk(3, dim=-1)
    hr, hz, hc = (h @ whh.T + bhh).chunk(3, dim=-1)
    r, z = torch.sigmoid(ir + hr), torch.sigmoid(iz + hz)
    c = torch.tanh(ic + r * hc)
    return (1 - z) * c + z * h


class SimpleRNNCell(nn.Module):
    """``h' = act(x W_ih^T + b_ih + h W_hh^T + b_hh)``, ``act`` tanh or relu;
    returns ``(h', h')``."""

    def __init__(self, input_size, hidden_size, activation="tanh", weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 device=None, generator=None):
        super().__init__()
        self.input_size, self.hidden_size, self.activation = input_size, hidden_size, activation
        _cell_params(self, 1, input_size, hidden_size,
                     (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr),
                     resolve_device(device), generator)

    def forward(self, inputs, states=None):
        h = states if states is not None else inputs.new_zeros((inputs.shape[0], self.hidden_size))
        act = torch.tanh if self.activation == "tanh" else torch.relu
        out = _rnn_step(inputs, h, self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh, act)
        return out, out


class LSTMCell(nn.Module):
    """One LSTM step (gates ``i, f, g, o``); ``states`` is ``(h, c)``;
    returns ``(h', (h', c'))``."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *, device=None, generator=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        _cell_params(self, 4, input_size, hidden_size,
                     (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr),
                     resolve_device(device), generator)

    def forward(self, inputs, states=None):
        if states is None:
            zero = inputs.new_zeros((inputs.shape[0], self.hidden_size))
            states = (zero, zero)
        h, c = _lstm_step(inputs, *states, self.weight_ih, self.weight_hh, self.bias_ih,
                          self.bias_hh)
        return h, (h, c)


class GRUCell(nn.Module):
    """One GRU step (gates ``r, z, c``, the reset gate applied to the hidden
    projection with its bias); returns ``(h', h')``."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *, device=None, generator=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        _cell_params(self, 3, input_size, hidden_size,
                     (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr),
                     resolve_device(device), generator)

    def forward(self, inputs, states=None):
        h = states if states is not None else inputs.new_zeros((inputs.shape[0], self.hidden_size))
        out = _gru_step(inputs, h, self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)
        return out, out


class _RNNBase(nn.Module):
    """``num_layers`` layers of one or two directions (``direction``
    ``"bidirect"``/``"bidirectional"``: the backward direction runs over the
    reversed sequence, the two outputs concatenated on the feature dim),
    batch-major unless ``time_major``. Returns ``(outputs, final states)``:
    the final hidden states ``[num_layers * directions, b, hidden]`` (LSTM:
    ``(h, c)``), each layer's directions in turn, every sequence started
    from zeros."""

    MODE = "RNN"
    GATES = {"RNN": 1, "GRU": 3, "LSTM": 4}

    def __init__(self, input_size, hidden_size, num_layers=1, direction="forward",
                 time_major=False, dropout=0.0, *, device=None, generator=None, **kwargs):
        super().__init__()
        name = type(self).__name__
        if dropout:
            _ignored(f"{name}(dropout={dropout}) (it applies no dropout between layers)")
        unread = sorted(k for k, v in kwargs.items()
                        if v is not None and not (k == "activation" and v == "tanh"))
        if unread:
            _ignored(f"{name}({', '.join(unread)}=...) (every keyword past dropout)")
        device = resolve_device(device)
        self.input_size, self.hidden_size, self.num_layers = input_size, hidden_size, num_layers
        self.time_major, self.direction = time_major, direction
        self.bidirect = direction in ("bidirect", "bidirectional")
        self.ndir = 2 if self.bidirect else 1
        g = self.GATES[self.MODE]
        std = 1.0 / math.sqrt(hidden_size)
        u = I.Uniform(-std, std)
        for layer in range(num_layers):
            for d in range(self.ndir):
                in_sz = input_size if layer == 0 else hidden_size * self.ndir
                for what, shape in (("weight_ih", (g * hidden_size, in_sz)),
                                    ("weight_hh", (g * hidden_size, hidden_size)),
                                    ("bias_ih", (g * hidden_size,)),
                                    ("bias_hh", (g * hidden_size,))):
                    self.register_parameter(f"{what}_l{layer}_d{d}",
                                            param(shape, None, u, generator, device))

    def _run(self, seq, wih, whh, bih, bhh):
        """One direction of one layer over time-major ``seq``: the outputs
        ``[T, b, hidden]`` and the final carry."""
        b = seq.shape[1]
        zero = seq.new_zeros((b, self.hidden_size))
        carry = (zero, zero) if self.MODE == "LSTM" else zero
        outs = []
        for xt in seq:
            if self.MODE == "LSTM":
                carry = _lstm_step(xt, *carry, wih, whh, bih, bhh)
                outs.append(carry[0])
            else:
                h = (_gru_step(xt, carry, wih, whh, bih, bhh) if self.MODE == "GRU"
                     else _rnn_step(xt, carry, wih, whh, bih, bhh, torch.tanh))
                carry = h
                outs.append(h)
        return torch.stack(outs), carry

    def forward(self, inputs, initial_states=None, sequence_length=None):
        name = type(self).__name__
        if initial_states is not None:
            _ignored(f"{name}.forward(initial_states=...) (every sequence starts from zeros)")
        if sequence_length is not None:
            _ignored(f"{name}.forward(sequence_length=...) (every step of every row runs)")
        out = inputs if self.time_major else inputs.transpose(0, 1)
        final_h, final_c = [], []
        for layer in range(self.num_layers):
            dir_outs = []
            for d in range(self.ndir):
                w = [getattr(self, f"{n}_l{layer}_d{d}")
                     for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
                seq = out if d == 0 else out.flip(0)
                outs, carry = self._run(seq, *w)
                dir_outs.append(outs if d == 0 else outs.flip(0))
                if self.MODE == "LSTM":
                    final_h.append(carry[0])
                    final_c.append(carry[1])
                else:
                    final_h.append(carry)
            out = dir_outs[0] if self.ndir == 1 else torch.cat(dir_outs, dim=-1)
        out = out if self.time_major else out.transpose(0, 1)
        h = torch.stack(final_h)
        return (out, (h, torch.stack(final_c))) if self.MODE == "LSTM" else (out, h)


class SimpleRNN(_RNNBase):
    """Elman RNN, tanh."""

    MODE = "RNN"


class LSTM(_RNNBase):
    MODE = "LSTM"


class GRU(_RNNBase):
    MODE = "GRU"


class RNN(nn.Module):
    """``cell`` run over time (reversed with ``is_reverse``): returns the
    stacked outputs and the last states; ``initial_states`` are passed to
    the first step. ``sequence_length`` raises (the reference ignores it)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell, self.is_reverse, self.time_major = cell, is_reverse, time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        if sequence_length is not None:
            _ignored("RNN.forward(sequence_length=...) (every step of every row runs)")
        T = inputs.shape[0] if self.time_major else inputs.shape[1]
        states, outs = initial_states, []
        steps = range(T - 1, -1, -1) if self.is_reverse else range(T)
        for t in steps:
            out, states = self.cell(inputs[t] if self.time_major else inputs[:, t], states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return torch.stack(outs, dim=0 if self.time_major else 1), states
