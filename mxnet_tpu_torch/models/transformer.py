"""Transformer building blocks and the encoder-decoder MT model.

Counterpart of ``mxnet_tpu/models/transformer.py`` (reference GluonNLP
``gluonnlp/model/transformer.py``).  Attention goes through
``F.dot_product_attention`` (``ops/attention.py``): an unmasked call
runs the flash kernels, a masked one (the decoder's causal mask, a
padding mask) the plain route.  Shapes are (B, T, C) throughout.

The sinusoidal position table is computed with numpy
(:func:`positional_encoding`); the encoder and decoder keep it on the
host and copy it once to each device they run on, so a forward never
copies it inside a CUDA graph capture.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import MXNetError
from ..gluon.block import HybridBlock
from ..gluon import nn
from ..ndarray import NDArray

__all__ = ["MultiHeadAttention", "PositionwiseFFN",
           "TransformerEncoderCell", "TransformerDecoderCell",
           "TransformerEncoder", "TransformerDecoder", "Transformer",
           "positional_encoding"]


def _position_table(length, units):
    """The (length, units) sinusoidal table, in float64."""
    position = np.arange(length)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, units, 2) * (-np.log(10000.0) / units))
    table = np.zeros((length, units))
    table[:, 0::2] = np.sin(position * div)
    table[:, 1::2] = np.cos(position * div[:units // 2 + units % 2][
        :table[:, 1::2].shape[1]])
    return table


def positional_encoding(length, units, dtype=np.float32, ctx=None):
    """Sinusoidal position table, (1, length, units), as an NDArray on
    ``ctx`` (default: the current context)."""
    return NDArray(_position_table(length, units)[None].astype(dtype),
                   ctx=ctx)


class _PositionTable:
    """One host table and its copy on each device a forward ran on."""

    def __init__(self, length, units):
        self._host = _position_table(length, units)[None].astype(
            np.float32)
        self._on = {}

    def on(self, device):
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = torch.from_numpy(self._host).to(device)
        return NDArray(t)


class MultiHeadAttention(HybridBlock):
    """Query/key/value projections, ``F.dot_product_attention`` over
    ``num_heads`` heads and the output projection."""

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if units % num_heads != 0:
            raise MXNetError(
                f"units {units} not divisible by heads {num_heads}")
        self._units = units
        self._num_heads = num_heads
        self._dropout = dropout
        with self.name_scope():
            self.proj_query = nn.Dense(units, use_bias=use_bias,
                                       flatten=False, prefix="query_")
            self.proj_key = nn.Dense(units, use_bias=use_bias,
                                     flatten=False, prefix="key_")
            self.proj_value = nn.Dense(units, use_bias=use_bias,
                                       flatten=False, prefix="value_")
            self.proj_out = nn.Dense(units, use_bias=use_bias,
                                     flatten=False, prefix="out_")

    def hybrid_forward(self, F, query, key, value, mask=None):
        b = query.shape[0]
        h = self._num_heads
        d = self._units // h
        q = self.proj_query(query).reshape((b, -1, h, d))
        k = self.proj_key(key).reshape((b, -1, h, d))
        v = self.proj_value(value).reshape((b, -1, h, d))
        out = F.dot_product_attention(q, k, v, mask=mask)
        out = out.reshape((b, -1, self._units))
        out = self.proj_out(out)
        if self._dropout:
            out = F.dropout(out, p=self._dropout)
        return out


class PositionwiseFFN(HybridBlock):
    def __init__(self, units, hidden_size, dropout=0.0, activation="relu",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.ffn_1 = nn.Dense(hidden_size, flatten=False,
                                  activation=activation, prefix="ffn1_")
            self.ffn_2 = nn.Dense(units, flatten=False, prefix="ffn2_")
        self._dropout = dropout

    def hybrid_forward(self, F, x):
        out = self.ffn_2(self.ffn_1(x))
        if self._dropout:
            out = F.dropout(out, p=self._dropout)
        return out


class TransformerEncoderCell(HybridBlock):
    """Post-norm encoder layer (the reference-era arrangement)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 activation="relu", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.attention = MultiHeadAttention(units, num_heads, dropout)
            self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                       activation)
            self.layer_norm_att = nn.LayerNorm(in_channels=units)
            self.layer_norm_ffn = nn.LayerNorm(in_channels=units)
        self._dropout = dropout

    def hybrid_forward(self, F, x, mask=None):
        att = self.attention(x, x, x, mask)
        x = self.layer_norm_att(x + att)
        out = self.ffn(x)
        return self.layer_norm_ffn(x + out)


class TransformerDecoderCell(HybridBlock):
    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 activation="relu", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.self_attention = MultiHeadAttention(units, num_heads,
                                                     dropout)
            self.cross_attention = MultiHeadAttention(units, num_heads,
                                                      dropout)
            self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                       activation)
            self.ln_self = nn.LayerNorm(in_channels=units)
            self.ln_cross = nn.LayerNorm(in_channels=units)
            self.ln_ffn = nn.LayerNorm(in_channels=units)

    def hybrid_forward(self, F, x, memory, self_mask=None, mem_mask=None):
        att = self.self_attention(x, x, x, self_mask)
        x = self.ln_self(x + att)
        att = self.cross_attention(x, memory, memory, mem_mask)
        x = self.ln_cross(x + att)
        return self.ln_ffn(x + self.ffn(x))


def _embed_positions(x, units, pos):
    """x·sqrt(units) plus the first T rows of the position table."""
    t = x.shape[1]
    return x * math.sqrt(units) + pos.on(x._data.device)[:, :t].astype(
        x.dtype)


class TransformerEncoder(HybridBlock):
    def __init__(self, num_layers=6, units=512, hidden_size=2048,
                 num_heads=8, max_length=512, dropout=0.1, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._max_length = max_length
        self._dropout = dropout
        self._pos = _PositionTable(max_length, units)
        with self.name_scope():
            self.cells = nn.HybridSequential(prefix="")
            for _ in range(num_layers):
                self.cells.add(TransformerEncoderCell(
                    units, hidden_size, num_heads, dropout))

    def hybrid_forward(self, F, x, mask=None):
        x = _embed_positions(x, self._units, self._pos)
        if self._dropout:
            x = F.dropout(x, p=self._dropout)
        for cell in self.cells:
            x = cell(x, mask)
        return x


class TransformerDecoder(HybridBlock):
    def __init__(self, num_layers=6, units=512, hidden_size=2048,
                 num_heads=8, max_length=512, dropout=0.1, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._dropout = dropout
        self._pos = _PositionTable(max_length, units)
        with self.name_scope():
            self.cells = nn.HybridSequential(prefix="")
            for _ in range(num_layers):
                self.cells.add(TransformerDecoderCell(
                    units, hidden_size, num_heads, dropout))

    def hybrid_forward(self, F, x, memory, self_mask=None, mem_mask=None):
        x = _embed_positions(x, self._units, self._pos)
        if self._dropout:
            x = F.dropout(x, p=self._dropout)
        for cell in self.cells:
            x = cell(x, memory, self_mask, mem_mask)
        return x


def _causal_mask(t, batch, device):
    """(batch, 1, t, t) boolean lower-triangular mask (True = attend):
    a mask, so the decoder's self-attention takes the masked route, as
    in the reference."""
    m = torch.ones((t, t), dtype=torch.bool, device=device).tril()
    return NDArray(m[None, None].expand(batch, 1, t, t))


class Transformer(HybridBlock):
    """Encoder-decoder MT transformer (reference: GluonNLP
    ``transformer_en_de_512`` config shape)."""

    def __init__(self, src_vocab_size, tgt_vocab_size, num_layers=6,
                 units=512, hidden_size=2048, num_heads=8, max_length=512,
                 dropout=0.1, share_embed=False, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.src_embed = nn.Embedding(src_vocab_size, units)
            if share_embed and src_vocab_size == tgt_vocab_size:
                self.tgt_embed = self.src_embed
            else:
                self.tgt_embed = nn.Embedding(tgt_vocab_size, units)
            self.encoder = TransformerEncoder(
                num_layers, units, hidden_size, num_heads, max_length,
                dropout)
            self.decoder = TransformerDecoder(
                num_layers, units, hidden_size, num_heads, max_length,
                dropout)
            self.proj = nn.Dense(tgt_vocab_size, flatten=False,
                                 prefix="proj_")

    def encode(self, src, src_mask=None):
        return self.encoder(self.src_embed(src), src_mask)

    def decode(self, tgt, memory, self_mask=None, mem_mask=None):
        return self.proj(self.decoder(self.tgt_embed(tgt), memory,
                                      self_mask, mem_mask))

    def hybrid_forward(self, F, src, tgt):
        memory = self.encode(src)
        causal = _causal_mask(tgt.shape[1], tgt.shape[0], tgt._data.device)
        return self.decode(tgt, memory, causal)
