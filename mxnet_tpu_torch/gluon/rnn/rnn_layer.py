"""Fused RNN layers.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py`` (reference
``python/mxnet/gluon/rnn/rnn_layer.py``): ``_RNNLayer`` over the fused
``rnn`` op (``ops/rnn_ops.py``), with ``RNN``, ``LSTM`` and ``GRU``;
layouts TNC and NTC, bidirectional, states in and out, per-layer
parameters named ``{l,r}{i}_{i2h,h2h}_{weight,bias}`` (the structural
names of ``.params`` files and ``convert.load_numpy_params``).  The
first layer's ``i2h_weight`` is inferred from the input at the first
call (``infer_shape``) when ``input_size`` is 0.

The states are passed to the block's forward one array an argument and
its outputs come back flat, so a hybridized layer captures like any
other block; ``__call__`` gives the reference's ``(output, [states])``.
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock
from ... import ndarray as nd_mod

__all__ = ["RNN", "LSTM", "GRU"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


class _RNNLayer(HybridBlock):
    def __init__(self, mode, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if layout not in ("TNC", "NTC"):
            raise MXNetError(f"layout must be TNC or NTC, got {layout!r}")
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = _GATES[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        with self.name_scope():
            for i in range(num_layers):
                for j in ("l", "r")[:self._dir]:
                    self._register_param(f"{j}{i}_i2h_weight", (ng * nh, ni),
                                         i2h_weight_initializer)
                    self._register_param(f"{j}{i}_h2h_weight", (ng * nh, nh),
                                         h2h_weight_initializer)
                    self._register_param(f"{j}{i}_i2h_bias", (ng * nh,),
                                         i2h_bias_initializer)
                    self._register_param(f"{j}{i}_h2h_bias", (ng * nh,),
                                         h2h_bias_initializer)
                ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)

    def infer_shape(self, x, *args):
        ni = int(x.shape[-1])
        ng, nh = self._gates, self._hidden_size
        for i in range(self._num_layers):
            for j in ("l", "r")[:self._dir]:
                getattr(self, f"{j}{i}_i2h_weight")._finish_deferred_init(
                    (ng * nh, ni))
            ni = nh * self._dir

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size,
                 self._hidden_size)
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": shape, "__layout__": "LNC"}] * n

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states (``func`` makes each from its ``shape``)."""
        if func is None:
            func = nd_mod.zeros
        states = []
        for info in self.state_info(batch_size):
            info = dict(info)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape=shape, **info, **kwargs))
        return states

    def hybrid_forward(self, F, inputs, *states, **params):
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, 0, 1)
        if not states:
            states = self.begin_state(inputs.shape[1], dtype=inputs.dtype,
                                      ctx=inputs.context)
        plist = []
        for i in range(self._num_layers):
            for j in ("l", "r")[:self._dir]:
                plist += [params[f"{j}{i}_i2h_weight"],
                          params[f"{j}{i}_h2h_weight"],
                          params[f"{j}{i}_i2h_bias"],
                          params[f"{j}{i}_h2h_bias"]]
        outs = F.rnn(inputs, list(states), plist, mode=self._mode,
                     state_size=self._hidden_size,
                     num_layers=self._num_layers,
                     bidirectional=self._dir == 2, p=self._dropout)
        output = outs[0]
        if self._layout == "NTC":
            output = F.swapaxes(output, 0, 1)
        return (output,) + tuple(outs[1:])

    def __call__(self, inputs, states=None):
        """``output`` without ``states``; ``(output, [states])`` with
        them (an array or a list), as in the reference."""
        if states is None:
            return super().__call__(inputs)[0]
        if not isinstance(states, (list, tuple)):
            states = [states]
        outs = super().__call__(inputs, *states)
        return outs[0], list(outs[1:])


class RNN(_RNNLayer):
    """Vanilla multi-layer RNN (reference ``gluon.rnn.RNN``)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 input_size=0, **kwargs):
        super().__init__(f"rnn_{activation}", hidden_size, num_layers,
                         layout, dropout, bidirectional, input_size,
                         **kwargs)


class LSTM(_RNNLayer):
    """Multi-layer LSTM (reference ``gluon.rnn.LSTM``)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("lstm", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)


class GRU(_RNNLayer):
    """Multi-layer GRU (reference ``gluon.rnn.GRU``)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("gru", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)
