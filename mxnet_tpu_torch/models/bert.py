"""BERT model family.

Counterpart of ``mxnet_tpu/models/bert.py`` (reference GluonNLP
``gluonnlp/model/bert.py``): the post-norm encoder over
``MultiHeadAttention`` (``models/transformer.py``), token, segment and
position embeddings, the pooler, and the MLM and NSP heads, each a
HybridBlock, so one ``hybridize()`` runs the whole forward as CUDA
graphs.  LayerNorm keeps its statistics in f32 under bf16.

Attention: without ``valid_length`` every layer's attention is unmasked
and runs the flash kernels (``ops/attention.py``); with it, the
(B, 1, 1, T) padding mask sends every layer to the plain masked route.

``bert_to_symbol`` rebuilds the inference forward as a ``Symbol`` graph
(dense attention), and ``export_bert_onnx`` writes it as ONNX.
"""
from __future__ import annotations

import numpy as np

from ..gluon.block import HybridBlock
from ..gluon import nn
from .transformer import MultiHeadAttention
from ..base import MXNetError  # noqa: F401

__all__ = ["BERTEncoder", "BERTModel", "bert_base", "bert_large",
           "bert_tiny", "BERTClassifier", "BERT_CONFIGS", "bert_to_symbol",
           "export_bert_onnx"]

BERT_CONFIGS = {
    "bert_base": dict(num_layers=12, units=768, hidden_size=3072,
                      num_heads=12, max_length=512),
    "bert_large": dict(num_layers=24, units=1024, hidden_size=4096,
                       num_heads=16, max_length=512),
    "bert_tiny": dict(num_layers=2, units=128, hidden_size=512,
                      num_heads=2, max_length=128),
}


class BERTEncoderCell(HybridBlock):
    """Post-norm encoder layer with a GELU FFN (BERT arrangement)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.1,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.attention = MultiHeadAttention(units, num_heads, dropout)
            self.ffn_1 = nn.Dense(hidden_size, flatten=False,
                                  prefix="ffn1_")
            self.ffn_2 = nn.Dense(units, flatten=False, prefix="ffn2_")
            self.layer_norm_att = nn.LayerNorm(in_channels=units)
            self.layer_norm_ffn = nn.LayerNorm(in_channels=units)
        self._dropout = dropout

    def hybrid_forward(self, F, x, mask=None):
        att = self.attention(x, x, x, mask)
        x = self.layer_norm_att(x + att)
        h = F.leaky_relu(self.ffn_1(x), act_type="gelu")
        h = self.ffn_2(h)
        if self._dropout:
            h = F.dropout(h, p=self._dropout)
        return self.layer_norm_ffn(x + h)


class BERTEncoder(HybridBlock):
    """Position embedding (a learned ``position_weight``), LayerNorm,
    dropout and ``num_layers`` encoder cells."""

    def __init__(self, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, max_length=512, dropout=0.1, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._max_length = max_length
        self._units = units
        with self.name_scope():
            self.position_weight = self.params.get(
                "position_weight", shape=(max_length, units))
            self.layer_norm = nn.LayerNorm(in_channels=units)
            self.transformer_cells = nn.HybridSequential(prefix="")
            for _ in range(num_layers):
                self.transformer_cells.add(BERTEncoderCell(
                    units, hidden_size, num_heads, dropout))
        self._dropout = dropout

    def hybrid_forward(self, F, x, mask=None, position_weight=None):
        t = x.shape[1]
        x = x + F.slice_axis(position_weight, axis=0, begin=0,
                             end=t).expand_dims(0)
        x = self.layer_norm(x)
        if self._dropout:
            x = F.dropout(x, p=self._dropout)
        for cell in self.transformer_cells:
            x = cell(x, mask)
        return x


class BERTModel(HybridBlock):
    """Token + segment embeddings → encoder → (sequence output, pooled,
    NSP logits, MLM logits), as far as the heads are present (reference:
    gluonnlp BERTModel)."""

    def __init__(self, vocab_size=30522, token_type_vocab_size=2,
                 num_layers=12, units=768, hidden_size=3072, num_heads=12,
                 max_length=512, dropout=0.1, use_pooler=True,
                 use_decoder=True, use_classifier=True, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._use_pooler = use_pooler
        self._use_decoder = use_decoder
        self._use_classifier = use_classifier
        with self.name_scope():
            self.word_embed = nn.Embedding(vocab_size, units)
            self.token_type_embed = nn.Embedding(token_type_vocab_size,
                                                 units)
            self.encoder = BERTEncoder(num_layers, units, hidden_size,
                                       num_heads, max_length, dropout)
            if use_pooler:
                self.pooler = nn.Dense(units, activation="tanh",
                                       flatten=False, prefix="pooler_")
            if use_decoder:
                self.decoder = nn.HybridSequential(prefix="decoder_")
                with self.decoder.name_scope():
                    self.decoder.add(nn.Dense(units, flatten=False))
                    self.decoder.add(nn.GELU())
                    self.decoder.add(nn.LayerNorm(in_channels=units))
                    self.decoder.add(nn.Dense(vocab_size, flatten=False))
            if use_classifier:
                self.classifier = nn.Dense(2, flatten=False,
                                           prefix="nsp_")

    def _make_mask(self, F, valid_length, t, batch):
        """(B,) lengths → the (B, 1, 1, T) attend-mask, 1 where the key
        position is below the row's length (None without lengths)."""
        if valid_length is None:
            return None
        ar = F.arange(0, t, ctx=valid_length.context).reshape((1, 1, 1, t))
        vl = valid_length.reshape((-1, 1, 1, 1))
        return F.broadcast_lesser(ar, vl)

    def hybrid_forward(self, F, inputs, token_types=None, valid_length=None):
        x = self.word_embed(inputs)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        mask = self._make_mask(F, valid_length, inputs.shape[1],
                               inputs.shape[0])
        seq = self.encoder(x, mask)
        outputs = [seq]
        if self._use_pooler:
            pooled = self.pooler(F.slice_axis(seq, axis=1, begin=0,
                                              end=1).squeeze(axis=1))
            outputs.append(pooled)
            if self._use_classifier:
                outputs.append(self.classifier(pooled))
        if self._use_decoder:
            outputs.append(self.decoder(seq))
        return outputs[0] if len(outputs) == 1 else tuple(outputs)


class BERTClassifier(HybridBlock):
    """Fine-tuning head on the pooled output (reference: gluonnlp
    BERTClassifier)."""

    def __init__(self, bert, num_classes=2, dropout=0.0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self.bert = bert
        with self.name_scope():
            self.classifier = nn.HybridSequential(prefix="cls_")
            if dropout:
                self.classifier.add(nn.Dropout(rate=dropout))
            self.classifier.add(nn.Dense(num_classes, flatten=False))

    def hybrid_forward(self, F, inputs, token_types=None, valid_length=None):
        outs = self.bert(inputs, token_types, valid_length)
        pooled = outs[1]
        return self.classifier(pooled)


def _make(config, **kwargs):
    cfg = dict(BERT_CONFIGS[config])
    cfg.update(kwargs)
    return BERTModel(**cfg)


def bert_base(**kwargs):
    return _make("bert_base", **kwargs)


def bert_large(**kwargs):
    return _make("bert_large", **kwargs)


def bert_tiny(**kwargs):
    return _make("bert_tiny", **kwargs)


def bert_to_symbol(net, batch, seq_len):
    """Rebuild a trained :class:`BERTModel`'s INFERENCE forward as an
    ``Symbol`` graph whose variable names are the net's own
    parameter names, so ``net.collect_params()`` binds it directly —
    the bridge from Gluon to the op-graph consumers (``Executor``, ONNX
    via :func:`export_bert_onnx`; GluonNLP exported its BERT through the
    symbol API the same way).  Attention is a dense ``batch_dot`` graph,
    as in the reference.

    Matches ``BERTModel.hybrid_forward`` with ``token_types`` given and
    ``valid_length=None`` (full attention), dropout=identity
    (inference).  Returns ``(symbol_group, param_dict)`` where the
    group outputs are (sequence, pooled, nsp_logits, mlm_logits) — the
    heads present on ``net``.
    """
    from .. import symbol as S

    params = net.collect_params()
    pname = {}
    for name, p in params.items():
        pname[p] = name

    def var(p):
        return S.var(pname[p])

    enc = net.encoder
    units = enc._units
    cells = list(enc.transformer_cells)
    heads = cells[0].attention._num_heads
    d = units // heads

    ids = S.var("data0")
    seg = S.var("data1")
    x = S.Embedding(ids, var(net.word_embed.weight),
                    input_dim=net.word_embed._input_dim,
                    output_dim=units, name="word_embed")
    x = S.broadcast_add(
        x, S.Embedding(seg, var(net.token_type_embed.weight),
                       input_dim=net.token_type_embed._input_dim,
                       output_dim=units, name="seg_embed"),
        name="embed_sum")
    pos = S.slice_axis(var(enc.position_weight), axis=0, begin=0,
                       end=seq_len, name="pos_slice")
    x = S.broadcast_add(x, S.expand_dims(pos, axis=0), name="pos_add")
    x = S.LayerNorm(x, var(enc.layer_norm.gamma),
                    var(enc.layer_norm.beta), name="embed_ln")

    def dense(t, layer, tag):
        return S.FullyConnected(t, var(layer.weight), var(layer.bias),
                                num_hidden=layer.weight.shape[0],
                                flatten=False, name=tag)

    for i, cell in enumerate(cells):
        att = cell.attention

        def split(t, tag):
            t = S.Reshape(t, shape=(batch, seq_len, heads, d),
                          name=f"{tag}_split")
            return S.transpose(t, axes=(0, 2, 1, 3), name=f"{tag}_bhtd")

        q = split(dense(x, att.proj_query, f"l{i}_q"), f"l{i}_qh")
        k = split(dense(x, att.proj_key, f"l{i}_k"), f"l{i}_kh")
        v = split(dense(x, att.proj_value, f"l{i}_v"), f"l{i}_vh")
        kt = S.transpose(k, axes=(0, 1, 3, 2), name=f"l{i}_kT")
        scores = S.batch_dot(q, kt, name=f"l{i}_scores") / float(
            np.sqrt(d))
        prob = S.softmax(scores, axis=-1, name=f"l{i}_att")
        ctx = S.batch_dot(prob, v, name=f"l{i}_ctx")
        ctx = S.transpose(ctx, axes=(0, 2, 1, 3), name=f"l{i}_bthd")
        ctx = S.Reshape(ctx, shape=(batch, seq_len, units),
                        name=f"l{i}_merge")
        proj = dense(ctx, att.proj_out, f"l{i}_attout")
        x = S.LayerNorm(S.broadcast_add(x, proj, name=f"l{i}_res1"),
                        var(cell.layer_norm_att.gamma),
                        var(cell.layer_norm_att.beta), name=f"l{i}_ln1")
        h = S.LeakyReLU(dense(x, cell.ffn_1, f"l{i}_ffn1"),
                        act_type="gelu", name=f"l{i}_gelu")
        h = dense(h, cell.ffn_2, f"l{i}_ffn2")
        x = S.LayerNorm(S.broadcast_add(x, h, name=f"l{i}_res2"),
                        var(cell.layer_norm_ffn.gamma),
                        var(cell.layer_norm_ffn.beta), name=f"l{i}_ln2")

    outs = [x]
    if net._use_pooler:
        first = S.Reshape(S.slice_axis(x, axis=1, begin=0, end=1,
                                       name="cls_slice"),
                          shape=(batch, units), name="cls_tok")
        pooled = S.tanh(dense(first, net.pooler, "pooler_fc"),
                        name="pooled")
        outs.append(pooled)
        if net._use_classifier:
            outs.append(dense(pooled, net.classifier, "nsp"))
    if net._use_decoder:
        dec = list(net.decoder)
        hme = dense(x, dec[0], "mlm_fc")
        hme = S.LeakyReLU(hme, act_type="gelu", name="mlm_gelu")
        hme = S.LayerNorm(hme, var(dec[2].gamma), var(dec[2].beta),
                          name="mlm_ln")
        outs.append(dense(hme, dec[3], "mlm_logits"))

    pdict = {name: p.data() for name, p in params.items()}
    return S.Group(outs), pdict


def export_bert_onnx(net, path, batch, seq_len):
    """Export a trained BERTModel to ONNX (opset 13) via
    :func:`bert_to_symbol` and ``contrib.onnx.export_model``."""
    from ..contrib.onnx import export_model

    sym, params = bert_to_symbol(net, batch, seq_len)
    return export_model(
        sym, params, [(batch, seq_len), (batch, seq_len)],
        input_types=[np.int32, np.int32], onnx_file_path=path)
