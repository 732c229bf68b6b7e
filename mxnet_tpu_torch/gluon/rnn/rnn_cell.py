"""Recurrent cells.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py`` (reference
``python/mxnet/gluon/rnn/rnn_cell.py``): the ``RecurrentCell`` base with
``begin_state`` and ``unroll``, ``RNNCell``, ``LSTMCell`` and ``GRUCell``
(gate orders LSTM [i, f, g, o], GRU [r, z, n], as the fused op's), and
the modifiers ``SequentialRNNCell``, ``DropoutCell``, ``ResidualCell``,
``ZoneoutCell`` and ``BidirectionalCell``.  ``DropoutCell`` and
``ZoneoutCell`` draw their masks from ``random.generator`` of the data's
device.

A cell takes its states as a list, so it runs its ``hybrid_forward``
directly (``hybridize()`` on a cell alone is a no-op); a hybridized
block around the cells captures them.
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ...ops.registry import apply_op
from ..block import HybridBlock
from ... import ndarray as nd_mod

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ResidualCell",
           "BidirectionalCell", "ZoneoutCell"]


def _steps(inputs, length, layout):
    """The per-step (N, C) arrays of ``inputs`` (a list of them, or one
    array with a T axis in ``layout``)."""
    if isinstance(inputs, (list, tuple)):
        return list(inputs)
    axis = layout.find("T")
    return [x.squeeze(axis=axis) for x in
            inputs.split(num_outputs=length, axis=axis, squeeze_axis=False)]


class RecurrentCell(HybridBlock):
    """Base of the cells (reference ``RecurrentCell``)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Reset the step counters before a new sequence."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states (reference ``RecurrentCell.begin_state``)."""
        if func is None:
            func = nd_mod.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape=shape, **info, **kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run ``length`` steps (reference ``unroll``); returns (outputs,
        states), the outputs a list of (N, H) arrays, or one array with a
        T axis in ``layout`` when ``merge_outputs``."""
        self.reset()
        steps = _steps(inputs, length, layout)
        if begin_state is None:
            begin_state = self.begin_state(steps[0].shape[0],
                                           ctx=steps[0].context)
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(steps[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = nd_mod.stack(*outputs, axis=layout.find("T"))
        return outputs, states

    def forward(self, inputs, states):
        self._counter += 1
        return self._imperative_forward(inputs, states)


HybridRecurrentCell = RecurrentCell


class _BaseRNNCell(RecurrentCell):
    def __init__(self, hidden_size, num_gates, activation=None,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        ng = num_gates
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(ng * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(ng * hidden_size, hidden_size),
                init=h2h_weight_initializer)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(ng * hidden_size,),
                init=i2h_bias_initializer)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(ng * hidden_size,),
                init=h2h_bias_initializer)
        self._ng = ng

    def infer_shape(self, x, *args):
        self.i2h_weight._finish_deferred_init(
            (self._ng * self._hidden_size, int(x.shape[-1])))

    def state_info(self, batch_size=0):
        n = 2 if self._alias() == "lstm" else 1
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}] * n

    def _projections(self, F, inputs, h, i2h_weight, h2h_weight, i2h_bias,
                     h2h_bias):
        n = self._ng * self._hidden_size
        i2h = F.fully_connected(inputs, i2h_weight, i2h_bias, num_hidden=n,
                                flatten=False)
        h2h = F.fully_connected(h, h2h_weight, h2h_bias, num_hidden=n,
                                flatten=False)
        return i2h, h2h


class RNNCell(_BaseRNNCell):
    """Elman cell: ``act(W_i x + b_i + W_h h + b_h)``."""

    def __init__(self, hidden_size, activation="tanh", **kwargs):
        super().__init__(hidden_size, 1, **kwargs)
        self._activation = activation

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._projections(F, inputs, states[0], i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        output = F.activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(_BaseRNNCell):
    """LSTM cell, gates [i, f, g, o]."""

    def __init__(self, hidden_size, **kwargs):
        super().__init__(hidden_size, 4, **kwargs)

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._projections(F, inputs, states[0], i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        slices = F.split(i2h + h2h, num_outputs=4, axis=-1)
        in_gate = F.sigmoid(slices[0])
        forget_gate = F.sigmoid(slices[1])
        in_transform = F.tanh(slices[2])
        out_gate = F.sigmoid(slices[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(_BaseRNNCell):
    """GRU cell, gates [r, z, n], ``n = tanh(x_n + r · (W_hn h + b_hn))``."""

    def __init__(self, hidden_size, **kwargs):
        super().__init__(hidden_size, 3, **kwargs)

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_h = states[0]
        i2h, h2h = self._projections(F, inputs, prev_h, i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        i2h_r, i2h_z, i2h_n = F.split(i2h, num_outputs=3, axis=-1)
        h2h_r, h2h_z, h2h_n = F.split(h2h, num_outputs=3, axis=-1)
        reset = F.sigmoid(i2h_r + h2h_r)
        update = F.sigmoid(i2h_z + h2h_z)
        new = F.tanh(i2h_n + reset * h2h_n)
        next_h = (1.0 - update) * new + update * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked, each feeding the next (reference
    ``SequentialRNNCell``)."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        infos = []
        for cell in self._children.values():
            infos.extend(cell.state_info(batch_size))
        return infos

    def begin_state(self, batch_size=0, **kwargs):
        return [s for cell in self._children.values()
                for s in cell.begin_state(batch_size, **kwargs)]

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def forward(self, inputs, states):
        self._counter += 1
        next_states = []
        pos = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            inputs, cell_states = cell(inputs, states[pos:pos + n])
            next_states.extend(cell_states)
            pos += n
        return inputs, next_states


class DropoutCell(RecurrentCell):
    """Dropout on the step's input, no state (reference
    ``DropoutCell``)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class _ModifierCell(RecurrentCell):
    def __init__(self, base_cell):
        super().__init__(prefix=base_cell.prefix + self._alias() + "_")
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return self.base_cell.begin_state(batch_size, **kwargs)


class ResidualCell(_ModifierCell):
    """The base cell's output plus its input."""

    def _alias(self):
        return "residual"

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


def _keep_mask(like, keep):
    """A {0, 1} mask in ``like``'s shape and dtype, 1 with probability
    ``keep``, from the generator of its device."""
    from ... import random as mx_random

    def f(a):
        u = torch.rand(a.shape, device=a.device,
                       generator=mx_random.generator(a.device))
        return (u < keep).to(a.dtype)

    return apply_op(f, like, name="bernoulli", no_grad=True)


class ZoneoutCell(_ModifierCell):
    """Zoneout in training: each output and state element keeps its
    previous value with probability ``zoneout_outputs`` /
    ``zoneout_states`` (reference ``ZoneoutCell``)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        self._zo = zoneout_outputs
        self._zs = zoneout_states
        super().__init__(base_cell)
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def hybrid_forward(self, F, inputs, states):
        from ... import autograd as ag

        output, next_states = self.base_cell(inputs, states)
        if ag.is_training():
            if self._zo > 0:
                prev = self._prev_output if self._prev_output is not None \
                    else F.zeros_like(output)
                mask = _keep_mask(output, 1 - self._zo)
                output = mask * output + (1 - mask) * prev
            if self._zs > 0:
                mixed = []
                for new, old in zip(next_states, states):
                    mask = _keep_mask(new, 1 - self._zs)
                    mixed.append(mask * new + (1 - mask) * old)
                next_states = mixed
        self._prev_output = output
        return output, next_states


class BidirectionalCell(RecurrentCell):
    """Two cells over opposite directions, inside ``unroll`` only
    (reference ``BidirectionalCell``)."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")

    def state_info(self, batch_size=0):
        return (self._children["l_cell"].state_info(batch_size) +
                self._children["r_cell"].state_info(batch_size))

    def begin_state(self, batch_size=0, **kwargs):
        return (self._children["l_cell"].begin_state(batch_size, **kwargs) +
                self._children["r_cell"].begin_state(batch_size, **kwargs))

    def __call__(self, inputs, states):
        raise MXNetError(
            "BidirectionalCell cannot be stepped; use unroll()")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        l_cell = self._children["l_cell"]
        r_cell = self._children["r_cell"]
        n_l = len(l_cell.state_info())
        begin = begin_state
        steps = _steps(inputs, length, layout)
        l_out, l_states = l_cell.unroll(
            length, steps, begin[:n_l] if begin else None, layout, False)
        r_out, r_states = r_cell.unroll(
            length, list(reversed(steps)),
            begin[n_l:] if begin else None, layout, False)
        r_out = list(reversed(r_out))
        outputs = [nd_mod.concat(lo, ro, dim=-1)
                   for lo, ro in zip(l_out, r_out)]
        if merge_outputs:
            outputs = nd_mod.stack(*outputs, axis=layout.find("T"))
        return outputs, l_states + r_states
