"""The fused recurrent op ``rnn``/``RNN``.

Counterpart of ``mxnet_tpu/ops/rnn_ops.py`` (reference ``src/operator/
rnn.cc``): vanilla (relu, tanh), LSTM and GRU, multi-layer,
bidirectional, TNC layout, states in and out.  For each (layer,
direction) the input projection of all T steps is one product
(``_run_direction``), and only the h2h product runs inside the loop over
time, a Python loop of torch ops with no host read: under
``hybridize()`` or ``FusedTrainStep`` the T steps capture into one CUDA
graph.  Gate orders are the reference cells': LSTM [i, f, g, o], GRU
[r, z, n] with ``n = tanh(x_n + r · (W_hn h + b_hn))``.  Dropout between
layers draws from ``random.generator`` of the data's device.

``torch.nn.LSTM``/``GRU`` (cuDNN) compute the same function; the port
never calls them (``chip_smoke.py`` times them as a yardstick).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import apply_op, exporter
from .registry import make_exporter  # noqa: F401

__all__ = []
_export = exporter(__all__)

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _cell_step(mode):
    """``step(carry, gates_x, h2h_w, h2h_b) -> (carry, h)`` of one time
    step; ``gates_x`` is the step's input projection with its bias."""
    if mode in ("rnn_relu", "rnn_tanh"):
        act = torch.relu if mode == "rnn_relu" else torch.tanh

        def step(carry, gates_x, h2h_w, h2h_b):
            h_new = act(gates_x + carry[0] @ h2h_w.t() + h2h_b)
            return (h_new,), h_new
    elif mode == "lstm":
        def step(carry, gates_x, h2h_w, h2h_b):
            h, c = carry
            gates = gates_x + h @ h2h_w.t() + h2h_b
            i, f, g, o = gates.chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            return (h_new, c_new), h_new
    elif mode == "gru":
        def step(carry, gates_x, h2h_w, h2h_b):
            h = carry[0]
            gh = h @ h2h_w.t() + h2h_b
            xr, xz, xn = gates_x.chunk(3, dim=-1)
            hr, hz, hn = gh.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h_new = (1 - z) * n + z * h
            return (h_new,), h_new
    else:
        raise MXNetError(f"unknown RNN mode {mode!r}")
    return step


def _run_direction(x, carry, i2h_w, i2h_b, h2h_w, h2h_b, mode, reverse):
    """One (layer, direction) over time: the input projection of every
    step as one product, the h2h product inside the loop.  Returns the
    last carry and the (T, N, H) outputs in time order."""
    gates_x = torch.matmul(x, i2h_w.t()) + i2h_b
    step = _cell_step(mode)
    steps = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
    ys = [None] * x.shape[0]
    for t in steps:
        carry, ys[t] = step(carry, gates_x[t], h2h_w, h2h_b)
    return carry, torch.stack(ys)


def rnn(data, *arrays, mode="lstm", state_size=None, num_layers=1,
        bidirectional=False, p=0.0, **kwargs):
    """Fused multi-layer RNN (reference fused ``RNN`` op).

    ``data``: (T, N, C), then ``states, params``: a list of (L·D, N, H)
    arrays (h, and c for lstm) and a flat list, per layer and direction,
    of ``[i2h_w, h2h_w, i2h_b, h2h_b]``.  The two lists may also come
    flattened into one run of arrays, states first — how a symbol graph's
    ``RNN`` node passes them (the reference's symbol ``RNN`` node cannot
    run: its executor passes the flattened arrays to the two-list
    signature).  Returns (output (T, N, H·D), *out_states)."""
    if mode not in _GATES:
        raise MXNetError(f"unknown RNN mode {mode!r}")
    d_count = 2 if bidirectional else 1
    n_states = 2 if mode == "lstm" else 1
    if len(arrays) == 2 and isinstance(arrays[0], (list, tuple)):
        states, params = arrays
    else:
        states, params = arrays[:n_states], arrays[n_states:]

    def f(x, *flat):
        from .. import autograd as ag
        from .. import random as mx_random

        st, ps = flat[:n_states], flat[n_states:]
        out = x
        new_h, new_c = [], []
        for layer in range(num_layers):
            outs_dir = []
            for d in range(d_count):
                li = layer * d_count + d
                i2h_w, h2h_w, i2h_b, h2h_b = ps[4 * li:4 * li + 4]
                carry = tuple(s[li] for s in st)
                carry, ys = _run_direction(out, carry, i2h_w, i2h_b, h2h_w,
                                           h2h_b, mode, d == 1)
                outs_dir.append(ys)
                new_h.append(carry[0])
                if mode == "lstm":
                    new_c.append(carry[1])
            out = outs_dir[0] if d_count == 1 else torch.cat(outs_dir, -1)
            if p > 0 and layer < num_layers - 1 and ag.is_training():
                u = torch.rand(out.shape, device=out.device,
                               generator=mx_random.generator(out.device))
                out = torch.where(u < 1.0 - p, out / (1.0 - p),
                                  torch.zeros((), dtype=out.dtype,
                                              device=out.device))
        outs = (out, torch.stack(new_h))
        if mode == "lstm":
            outs = outs + (torch.stack(new_c),)
        return outs

    return apply_op(f, data, *states, *params, name=f"rnn_{mode}")


_export(rnn, aliases=("RNN",))
