"""Recurrent layers (counterpart of ``paddle_tpu/nn/rnn.py``).

``SimpleRNN``, ``LSTM`` and ``GRU`` run each direction of each layer as
one op: a Python loop over time inside ``apply_op`` (the reference's
``lax.scan``), torch's autograd through it.  The cells are the
reference's, and their gate order and bias layout are torch's too:
LSTM gates ``i, f, g, o``; GRU ``r, z, n`` with ``n = tanh(W_in x + b_in
+ r * (W_hn h + b_hn))``; both biases (``bias_ih``, ``bias_hh``) a layer.
Parameters keep the reference's names (``weight_ih_l0``,
``weight_hh_l0_reverse``, ...).  As in the reference, the multi-layer
classes take no ``sequence_length`` (it raises); the generic ``RNN`` and
``BiRNN`` over a cell do, and the reverse direction then starts at each
example's last valid step.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dispatch import apply_op
from ..core.tensor import Tensor
from ..ops._helpers import targ
from . import initializer as I
from .layer_base import Layer


def _lstm_cell(x_t, carry, wih, whh, bih, bhh):
    h, c = carry
    gates = x_t @ wih.T + bih + h @ whh.T + bhh
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _gru_cell(x_t, h, wih, whh, bih, bhh):
    ir, iz, inew = torch.chunk(x_t @ wih.T + bih, 3, dim=-1)
    hr, hz, hnew = torch.chunk(h @ whh.T + bhh, 3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(inew + r * hnew)
    return (1 - z) * n + z * h


def _uniform_param(layer, shape, std):
    return layer.create_parameter(shape,
                                  default_initializer=I.Uniform(-std, std))


class _RNNBase(Layer):
    GATES = 1
    N_STATE = 1

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirect = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirect else 1
        std = 1.0 / math.sqrt(hidden_size)
        g = self.GATES * hidden_size
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_sz = input_size if layer == 0 \
                    else hidden_size * self.num_directions
                sfx = f"_l{layer}" + ("_reverse" if d else "")
                self.add_parameter("weight_ih" + sfx, _uniform_param(
                    self, [g, in_sz], std))
                self.add_parameter("weight_hh" + sfx, _uniform_param(
                    self, [g, hidden_size], std))
                self.add_parameter("bias_ih" + sfx, _uniform_param(
                    self, [g], std))
                self.add_parameter("bias_hh" + sfx, _uniform_param(
                    self, [g], std))

    def _cell_val(self, x_t, carry, wih, whh, bih, bhh):
        raise NotImplementedError

    def _run_direction(self, x, layer, reverse, init_state):
        sfx = f"_l{layer}" + ("_reverse" if reverse else "")
        params = [getattr(self, n + sfx) for n in
                  ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]

        def fn(xv, wih, whh, bih, bhh, *init):
            seq = xv if self.time_major else xv.transpose(0, 1)
            if reverse:
                seq = torch.flip(seq, (0,))
            carry = init if len(init) > 1 else init[0]
            outs = []
            for t in range(seq.shape[0]):
                carry = self._cell_val(seq[t], carry, wih, whh, bih, bhh)
                outs.append(carry[0] if isinstance(carry, tuple) else carry)
            outs = torch.stack(outs, 0)
            if reverse:
                outs = torch.flip(outs, (0,))
            if not self.time_major:
                outs = outs.transpose(0, 1)
            if isinstance(carry, tuple):
                return (outs,) + carry
            return outs, carry

        return apply_op("rnn" + sfx, fn, (x, *params, *init_state))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        if sequence_length is not None:
            raise NotImplementedError(
                "sequence_length masking is not supported yet; pad-free "
                "batches or mask outputs externally")
        x = inputs
        batch = x.shape[1] if self.time_major else x.shape[0]
        ndir = self.num_directions
        states_out = []
        for layer in range(self.num_layers):
            dir_outs = []
            for d in range(ndir):
                if initial_states is None:
                    init = tuple(torch.zeros(batch, self.hidden_size)
                                 for _ in range(self.N_STATE))
                else:
                    st = initial_states if self.N_STATE > 1 \
                        else (initial_states,)
                    init = tuple(targ(s[layer * ndir + d]) for s in st)
                res = self._run_direction(x, layer, d == 1, init)
                states_out.append(tuple(res[1:]))
                dir_outs.append(res[0])
            if ndir == 2:
                from ..ops.manipulation import concat
                x = concat(dir_outs, axis=-1)
            else:
                x = dir_outs[0]
            if self.dropout > 0 and layer < self.num_layers - 1:
                from . import functional as F
                x = F.dropout(x, self.dropout, training=self.training)
        from ..ops.manipulation import stack
        final = [stack([s[i] for s in states_out], axis=0)
                 for i in range(self.N_STATE)]
        return (x, final[0]) if self.N_STATE == 1 else (x, tuple(final))


class SimpleRNN(_RNNBase):
    GATES = 1

    def __init__(self, *args, activation="tanh", **kwargs):
        super().__init__(*args, **kwargs)
        self._act = torch.tanh if activation == "tanh" else torch.relu

    def _cell_val(self, x_t, h, wih, whh, bih, bhh):
        return self._act(x_t @ wih.T + bih + h @ whh.T + bhh)


class LSTM(_RNNBase):
    GATES = 4
    N_STATE = 2

    def _cell_val(self, x_t, carry, wih, whh, bih, bhh):
        return _lstm_cell(x_t, carry, wih, whh, bih, bhh)


class GRU(_RNNBase):
    GATES = 3

    def _cell_val(self, x_t, h, wih, whh, bih, bhh):
        return _gru_cell(x_t, h, wih, whh, bih, bhh)


class RNNCellBase(Layer):
    """The base of the cells the generic ``RNN``/``BiRNN`` run."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        b = batch_ref.shape[batch_dim_idx]
        h = shape[-1] if shape is not None else self.hidden_size
        d = np.dtype(dtype) if dtype is not None else np.float32
        return Tensor(np.full((b, h), init_value, d))


class _Cell(RNNCellBase):
    GATES = 1

    def __init__(self, input_size, hidden_size):
        super().__init__()
        std = 1.0 / math.sqrt(hidden_size)
        self.hidden_size = hidden_size
        g = self.GATES * hidden_size
        self.weight_ih = _uniform_param(self, [g, input_size], std)
        self.weight_hh = _uniform_param(self, [g, hidden_size], std)
        self.bias_ih = _uniform_param(self, [g], std)
        self.bias_hh = _uniform_param(self, [g], std)

    def _zeros(self, inputs):
        """The zero state, on the inputs' device."""
        return Tensor._from_value(torch.zeros(
            inputs.shape[0], self.hidden_size, device=inputs._value.device))

    def _weights(self):
        return (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)


class SimpleRNNCell(_Cell):
    def __init__(self, input_size, hidden_size, activation="tanh", **kw):
        super().__init__(input_size, hidden_size)
        self._act = torch.tanh if activation == "tanh" else torch.relu

    def forward(self, inputs, states=None):
        from ..ops.linalg import matmul
        h = states if states is not None else self._zeros(inputs)
        pre = matmul(inputs, self.weight_ih, transpose_y=True) \
            + self.bias_ih \
            + matmul(h, self.weight_hh, transpose_y=True) + self.bias_hh
        out = apply_op("rnn_cell_act", self._act, (pre,))
        return out, out


class LSTMCell(_Cell):
    GATES = 4

    def __init__(self, input_size, hidden_size, **kw):
        super().__init__(input_size, hidden_size)

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        h = super().get_initial_states(batch_ref, shape, dtype, init_value,
                                       batch_dim_idx)
        c = super().get_initial_states(batch_ref, shape, dtype, init_value,
                                       batch_dim_idx)
        return (h, c)

    def forward(self, inputs, states=None):
        if states is None:
            states = (self._zeros(inputs), self._zeros(inputs))
        h, c = states
        h_new, c_new = apply_op(
            "lstm_cell", lambda x, hv, cv, *w: _lstm_cell(x, (hv, cv), *w),
            (inputs, targ(h), targ(c)) + self._weights())
        return h_new, (h_new, c_new)


class GRUCell(_Cell):
    GATES = 3

    def __init__(self, input_size, hidden_size, **kw):
        super().__init__(input_size, hidden_size)

    def forward(self, inputs, states=None):
        h = targ(states) if states is not None else self._zeros(inputs)
        h_new = apply_op("gru_cell", _gru_cell,
                         (inputs, h) + self._weights())
        return h_new, h_new


class RNN(Layer):
    """Run any cell over the time axis (a Python loop over the steps).
    With ``sequence_length`` a finished sequence keeps its state and
    emits zeros."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        if sequence_length is not None and self.is_reverse:
            # run forward over each example reversed within its length,
            # then un-reverse: the reverse direction starts at the last
            # valid step, not at the padding
            rev = _reverse_sequence(inputs, sequence_length,
                                    self.time_major)
            out, state = self._run(rev, initial_states, sequence_length,
                                   is_reverse=False)
            return _reverse_sequence(out, sequence_length,
                                     self.time_major), state
        return self._run(inputs, initial_states, sequence_length,
                         is_reverse=self.is_reverse)

    def _run(self, inputs, initial_states, sequence_length, is_reverse):
        from ..ops.creation import zeros_like
        from ..ops.manipulation import stack, where
        x = inputs
        time_axis = 0 if self.time_major else 1
        steps = x.shape[time_axis]
        order = range(steps - 1, -1, -1) if is_reverse else range(steps)
        state = initial_states
        outs = [None] * steps

        def blend(new, old, active):
            if old is None:
                return new
            if isinstance(new, (tuple, list)):
                return type(new)(blend(n, o, active)
                                 for n, o in zip(new, old))
            return where(active, new, old)

        for t in order:
            x_t = x[t] if self.time_major else x[:, t]
            out, new_state = self.cell(x_t, state)
            if sequence_length is not None:
                active = (sequence_length > t).reshape([-1, 1])
                new_state = blend(new_state, state, active)
                out = where(active, out, zeros_like(out))
            state = new_state
            outs[t] = out
        return stack(outs, axis=time_axis), state


def _reverse_sequence(x, lengths, time_major):
    """Each example's first ``lengths[b]`` steps reversed in place; the
    padding steps keep their positions."""
    def fn(xv, lv):
        lv = lv.to(torch.int64)
        steps = xv.shape[0 if time_major else 1]
        t = torch.arange(steps, device=xv.device)
        if time_major:
            idx = torch.where(t[:, None] < lv[None, :],
                              lv[None, :] - 1 - t[:, None], t[:, None])
            idx = idx.reshape((steps, lv.shape[0]) + (1,) * (xv.dim() - 2))
            return torch.gather(xv, 0, idx.expand(xv.shape))
        idx = torch.where(t[None, :] < lv[:, None],
                          lv[:, None] - 1 - t[None, :], t[None, :])
        idx = idx.reshape((lv.shape[0], steps) + (1,) * (xv.dim() - 2))
        return torch.gather(xv, 1, idx.expand(xv.shape))
    return apply_op("reverse_sequence", fn, (x, targ(lengths)))


class BiRNN(Layer):
    """A forward and a backward cell, their outputs concatenated on the
    feature axis."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ..ops.manipulation import concat
        init_fw, init_bw = (initial_states if initial_states is not None
                            else (None, None))
        out_fw, st_fw = self.rnn_fw(inputs, init_fw, sequence_length)
        out_bw, st_bw = self.rnn_bw(inputs, init_bw, sequence_length)
        return concat([out_fw, out_bw], axis=-1), (st_fw, st_bw)
