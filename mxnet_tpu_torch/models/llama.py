"""Llama model family: inference.

Counterpart of ``mxnet_tpu/models/llama.py``.  The Gluon blocks
(``LlamaForCausalLM`` and its parts) run the prompt/scoring forward with
the hand-written CUDA flash-attention kernel (``attn_mode="flash"``, the
default) or dense attention (``"sdpa"``); ``generate`` runs the
KV-cached ``LlamaDecoder``: one batched prefill, then greedy decode
steps, with dense attention as in the reference.

Numerics follow the reference: RMSNorm statistics in f32 cast back to
the input dtype; RoPE tables computed in float64, stored f32, applied to
interleaved pairs (x[..., ::2], x[..., 1::2]) in f32 and cast back; GQA
heads repeated with ``repeat_interleave``; attention scores in f32 with
P cast to the activation dtype before the PV product.

Not ported in this slice, each raising ``MXNetError`` that names the
ROADMAP item: MoE (``num_experts``, the mixtral configs),
``scan_layers``/``set_remat``, ring/ulysses attention, packed
``segment_ids`` and ``packed_lm_loss``, sampling (``do_sample=True``),
the pipeline and sharding functions, and the decoder's paged and
speculative serving programs.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import autograd
from .. import ndarray as nd
from ..base import MXNetError
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ndarray import NDArray
from ..ops.flash_attention import _sdpa_ref, flash_attention_raw
from ..ops.registry import apply_op

__all__ = ["LlamaConfig", "RMSNorm", "LlamaAttention", "LlamaMLP",
           "LlamaDecoderLayer", "LlamaModel", "LlamaForCausalLM",
           "LlamaDecoder", "llama3_8b", "llama_tiny", "mixtral_8x7b",
           "mixtral_tiny", "shard_llama", "llama_param_pspecs",
           "llama_pipeline_forward", "llama_pipeline_train_step",
           "packed_lm_loss", "LLAMA_CONFIGS"]

_LATER = ("is not ported yet (ROADMAP.md, Queue 1, \"Left out of slice "
          "1\")")


def _not_ported(what):
    """A function or method of the reference that a later slice ports:
    calling it raises ``MXNetError`` naming the ROADMAP item."""
    def refuse(*args, **kwargs):
        raise MXNetError(f"{what} {_LATER}")

    refuse.__name__ = what.rsplit(".", 1)[-1]
    return refuse


class LlamaConfig:
    def __init__(self, hidden_size=4096, intermediate_size=14336,
                 num_layers=32, num_heads=32, num_kv_heads=8,
                 vocab_size=128256, max_seq_len=8192, rope_theta=500000.0,
                 rms_eps=1e-5, tie_embeddings=False, attn_mode="flash",
                 num_experts=0, scan_layers=False):
        if attn_mode not in ("flash", "sdpa"):
            raise MXNetError(f"attn_mode={attn_mode!r} (ring/ulysses "
                             f"sequence parallelism) {_LATER}")
        if num_experts:
            raise MXNetError(f"MoE (num_experts > 0) {_LATER}")
        if scan_layers:
            raise MXNetError(f"scan_layers {_LATER}")
        if hidden_size % num_heads:
            raise MXNetError("num_heads must evenly divide hidden_size")
        if num_heads % num_kv_heads:
            raise MXNetError("num_kv_heads must evenly divide num_heads")
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.vocab_size = vocab_size
        self.max_seq_len = max_seq_len
        self.rope_theta = rope_theta
        self.rms_eps = rms_eps
        self.tie_embeddings = tie_embeddings
        self.attn_mode = attn_mode
        self.head_dim = hidden_size // num_heads


LLAMA_CONFIGS = {
    "llama3_8b": dict(hidden_size=4096, intermediate_size=14336,
                      num_layers=32, num_heads=32, num_kv_heads=8,
                      vocab_size=128256, rope_theta=500000.0),
    "llama_tiny": dict(hidden_size=64, intermediate_size=176,
                       num_layers=2, num_heads=4, num_kv_heads=2,
                       vocab_size=256, max_seq_len=128),
}


def _rms(x, w, eps):
    """RMSNorm with f32 statistics, cast back to x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf / torch.sqrt(var + eps) * w.float()).to(x.dtype)


class RMSNorm(HybridBlock):
    """Root-mean-square LayerNorm (no mean subtraction, no bias); stats in
    f32 even under bf16 params."""

    def __init__(self, units, eps=1e-5, **kwargs):
        super().__init__(**kwargs)
        self._eps = eps
        with self.name_scope():
            self.weight = self.params.get("weight", shape=(units,),
                                          init="ones")

    def hybrid_forward(self, F, x, weight):
        return apply_op(lambda xr, wr: _rms(xr, wr, self._eps), x, weight,
                        name="rms_norm")


def _rope_tables(t, head_dim, theta):
    """cos/sin tables (T, head_dim/2): float64 math, stored float32."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2,
                                     dtype=np.float64) / head_dim))
    pos = np.arange(t, dtype=np.float64)
    ang = np.outer(pos, inv)
    return (np.cos(ang).astype(np.float32),
            np.sin(ang).astype(np.float32))


def _apply_rope(x, cos, sin):
    """x (..., T, D) with D even; rotate interleaved pairs
    (x[..., ::2], x[..., 1::2]).  x·cos promotes to f32; the result is
    cast back to x's dtype."""
    x1 = x[..., ::2]
    x2 = x[..., 1::2]
    xr1 = x1 * cos - x2 * sin
    xr2 = x1 * sin + x2 * cos
    return torch.stack([xr1, xr2], dim=-1).reshape(x.shape).to(x.dtype)


class _RopeCache:
    """f32 RoPE tables per (length, device): numpy once, then one
    host→device copy per device."""

    def __init__(self, head_dim, theta):
        self._head_dim, self._theta = head_dim, theta
        self._tables = {}

    def get(self, t, device):
        key = (t, device)
        if key not in self._tables:
            cos, sin = _rope_tables(t, self._head_dim, self._theta)
            self._tables[key] = (torch.from_numpy(cos).to(device),
                                 torch.from_numpy(sin).to(device))
        return self._tables[key]


class LlamaAttention(HybridBlock):
    """GQA self-attention with RoPE and the flash kernel."""

    def __init__(self, cfg: LlamaConfig, **kwargs):
        super().__init__(**kwargs)
        self._cfg = cfg
        hd = cfg.head_dim
        with self.name_scope():
            self.q_proj = nn.Dense(cfg.num_heads * hd, use_bias=False,
                                   flatten=False, in_units=cfg.hidden_size,
                                   prefix="q_")
            self.k_proj = nn.Dense(cfg.num_kv_heads * hd, use_bias=False,
                                   flatten=False, in_units=cfg.hidden_size,
                                   prefix="k_")
            self.v_proj = nn.Dense(cfg.num_kv_heads * hd, use_bias=False,
                                   flatten=False, in_units=cfg.hidden_size,
                                   prefix="v_")
            self.o_proj = nn.Dense(cfg.hidden_size, use_bias=False,
                                   flatten=False,
                                   in_units=cfg.num_heads * hd, prefix="o_")
        self._rope = _RopeCache(hd, cfg.rope_theta)

    def hybrid_forward(self, F, x, segment_ids=None):
        cfg = self._cfg
        if segment_ids is not None:
            raise MXNetError(f"packed segment_ids {_LATER}")
        b, t = x.shape[0], x.shape[1]
        hd = cfg.head_dim
        scale = 1.0 / math.sqrt(hd)

        def _attend(qr, kr, vr):
            cos, sin = self._rope.get(t, qr.device)
            qh = qr.reshape(b, t, cfg.num_heads, hd).transpose(1, 2)
            kh = kr.reshape(b, t, cfg.num_kv_heads, hd).transpose(1, 2)
            vh = vr.reshape(b, t, cfg.num_kv_heads, hd).transpose(1, 2)
            qh = _apply_rope(qh, cos, sin)
            kh = _apply_rope(kh, cos, sin)
            rep = cfg.num_heads // cfg.num_kv_heads
            if rep > 1:
                kh = kh.repeat_interleave(rep, dim=1)
                vh = vh.repeat_interleave(rep, dim=1)
            if cfg.attn_mode == "flash":
                out = flash_attention_raw(qh.contiguous(), kh.contiguous(),
                                          vh.contiguous(), True, scale)
            else:
                out = _sdpa_ref(qh, kh, vh, True, scale)
            return out.transpose(1, 2).reshape(b, t, -1)

        ctx = apply_op(_attend, self.q_proj(x), self.k_proj(x),
                       self.v_proj(x), name="llama_attention")
        return self.o_proj(ctx)


class LlamaMLP(HybridBlock):
    """SwiGLU feed-forward: down(silu(gate(x)) * up(x))."""

    def __init__(self, cfg: LlamaConfig, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.gate_proj = nn.Dense(cfg.intermediate_size, use_bias=False,
                                      flatten=False,
                                      in_units=cfg.hidden_size,
                                      prefix="gate_")
            self.up_proj = nn.Dense(cfg.intermediate_size, use_bias=False,
                                    flatten=False, in_units=cfg.hidden_size,
                                    prefix="up_")
            self.down_proj = nn.Dense(cfg.hidden_size, use_bias=False,
                                      flatten=False,
                                      in_units=cfg.intermediate_size,
                                      prefix="down_")

    def hybrid_forward(self, F, x):
        g = self.gate_proj(x)
        return self.down_proj(g * F.sigmoid(g) * self.up_proj(x))


class LlamaDecoderLayer(HybridBlock):
    def __init__(self, cfg: LlamaConfig, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps,
                                           prefix="ln_in_")
            self.self_attn = LlamaAttention(cfg, prefix="attn_")
            self.post_attention_layernorm = RMSNorm(
                cfg.hidden_size, cfg.rms_eps, prefix="ln_post_")
            self.mlp = LlamaMLP(cfg, prefix="mlp_")

    def hybrid_forward(self, F, x):
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(HybridBlock):
    def __init__(self, cfg: LlamaConfig, **kwargs):
        super().__init__(**kwargs)
        self._cfg = cfg
        with self.name_scope():
            self.embed_tokens = nn.Embedding(cfg.vocab_size,
                                             cfg.hidden_size,
                                             prefix="embed_")
            self.layers = nn.HybridSequential(prefix="layers_")
            for _ in range(cfg.num_layers):
                self.layers.add(LlamaDecoderLayer(cfg))
            self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps,
                                prefix="norm_")

    def hybrid_forward(self, F, input_ids):
        h = self.embed_tokens(input_ids)
        for layer in self.layers:
            h = layer(h)
        return self.norm(h)


class LlamaForCausalLM(HybridBlock):
    """Decoder + LM head; the forward returns logits (B, T, V)."""

    def __init__(self, cfg: LlamaConfig, **kwargs):
        super().__init__(**kwargs)
        self._cfg = cfg
        with self.name_scope():
            self.model = LlamaModel(cfg, prefix="model_")
            self.lm_head = nn.Dense(cfg.vocab_size, use_bias=False,
                                    flatten=False,
                                    in_units=cfg.hidden_size,
                                    prefix="lm_head_")

    @property
    def config(self):
        return self._cfg

    def hybrid_forward(self, F, input_ids, segment_ids=None):
        if segment_ids is not None:
            raise MXNetError(f"packed segment_ids {_LATER}")
        return _lm_head(self, self.model(input_ids))

    set_remat = _not_ported("LlamaForCausalLM.set_remat")

    def generate(self, input_ids, max_new_tokens=16, use_cache=True,
                 do_sample=False):
        """Greedy decoding.  ``use_cache=True`` (default) runs the
        KV-cached ``LlamaDecoder``; ``use_cache=False`` re-forwards the
        whole sequence per token (the reference's oracle path)."""
        if do_sample:
            raise MXNetError(f"do_sample=True (sampling) {_LATER}")
        need = input_ids.shape[1] + max_new_tokens
        max_ctx = self._cfg.max_seq_len
        if need > max_ctx:
            raise MXNetError(
                f"generate: prompt ({input_ids.shape[1]}) + max_new_tokens "
                f"({max_new_tokens}) = {need} exceeds the model's "
                f"max_seq_len ({max_ctx}); RoPE tables and KV caches are "
                f"only valid inside the trained context window")
        if use_cache:
            return self._generate_cached(input_ids, max_new_tokens)
        cur = input_ids
        with autograd.pause():
            for _ in range(max_new_tokens):
                logits = self(cur)
                nxt = nd.argmax(logits, axis=-1)[:, -1:]
                cur = nd.concat(cur, nxt.astype(cur.dtype), dim=1)
        return cur

    def _generate_cached(self, input_ids, max_new_tokens):
        if max_new_tokens < 1:  # n=0: prompt unchanged (oracle parity)
            return input_ids
        b, t0 = input_ids.shape
        # max_len bucketed to a power of two (min 64, capped at
        # max_seq_len), so nearby lengths share one decoder and the same
        # padded shapes as the reference
        bucket = 64
        while bucket < t0 + max_new_tokens:
            bucket *= 2
        bucket = min(bucket, self._cfg.max_seq_len)
        cache = self.__dict__.setdefault("_kv_decoders", {})
        dec = cache.get(bucket)
        if dec is None:
            dec = cache[bucket] = LlamaDecoder(self, max_len=bucket)
        ids = dec.generate(input_ids._data, max_new_tokens)
        return NDArray(ids).astype(input_ids.dtype)


class LlamaDecoder:
    """Incremental decoder with a static-shape KV cache.

    ``generate`` runs one batched prefill over the padded prompt, which
    writes the prompt's K/V into (B, Hkv, max_len, D) caches, then greedy
    decode steps; each step writes its K/V row into the caches in place
    (the reference's functional update, done in place to keep one copy of
    the cache) and attends the whole cache under a ``t <= pos`` mask.
    Weights are read from the net's Parameters on every call.  Attention
    is dense (``_attend``), as in the reference.
    """

    def __init__(self, net: "LlamaForCausalLM", max_len: int):
        cfg = net.config
        self.cfg = cfg
        self.max_len = int(max_len)
        self._net = net
        self._rope = _RopeCache(cfg.head_dim, cfg.rope_theta)

    def _weights(self):
        """Raw-weight tree from the net's Parameters."""
        net = self._net
        raw = lambda p: p.data()._data  # noqa: E731
        layers = [
            dict(ln_in=raw(lr.input_layernorm.weight),
                 q=raw(lr.self_attn.q_proj.weight),
                 k=raw(lr.self_attn.k_proj.weight),
                 v=raw(lr.self_attn.v_proj.weight),
                 o=raw(lr.self_attn.o_proj.weight),
                 ln_post=raw(lr.post_attention_layernorm.weight),
                 gate=raw(lr.mlp.gate_proj.weight),
                 up=raw(lr.mlp.up_proj.weight),
                 down=raw(lr.mlp.down_proj.weight))
            for lr in net.model.layers]
        emb = raw(net.model.embed_tokens.weight)
        head = emb if self.cfg.tie_embeddings else raw(net.lm_head.weight)
        return dict(layers=layers, emb=emb,
                    norm=raw(net.model.norm.weight), head=head)

    def init_cache(self, batch):
        cfg = self.cfg
        emb = self._net.model.embed_tokens.weight.data()._data
        shape = (batch, cfg.num_kv_heads, self.max_len, cfg.head_dim)
        return [(torch.zeros(shape, dtype=emb.dtype, device=emb.device),
                 torch.zeros(shape, dtype=emb.dtype, device=emb.device))
                for _ in range(cfg.num_layers)]

    def _attend(self, q, k, v, mask):
        """f32 scores, masked softmax, P cast to q's dtype, context.
        q (B, H, Q, D); k/v (B, Hkv, T, D); mask (Q, T) bool shared across
        the batch, or broadcastable to (B, H, Q, T)."""
        cfg = self.cfg
        rep = cfg.num_heads // cfg.num_kv_heads
        if rep > 1:
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores / math.sqrt(cfg.head_dim)
        scores = scores.masked_fill(~mask, float("-inf"))
        attn = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.matmul(attn, v)

    def _layer(self, L, x, ctx_fn):
        """Residual wiring: x + attn(ln(x)), then + mlp(ln(x))."""
        eps = self.cfg.rms_eps
        x = x + ctx_fn(_rms(x, L["ln_in"], eps))
        h2 = _rms(x, L["ln_post"], eps)
        g = h2 @ L["gate"].t()
        return x + (g * torch.sigmoid(g) * (h2 @ L["up"].t())) @ \
            L["down"].t()

    def _step_impl(self, w, caches, ids_t, pos):
        """ids_t (B,) int, pos int → logits (B, V); writes position
        ``pos`` of every layer's caches in place."""
        cfg = self.cfg
        hd = cfg.head_dim
        b = ids_t.shape[0]
        cos, sin = self._rope.get(self.max_len, ids_t.device)
        cos, sin = cos[pos:pos + 1], sin[pos:pos + 1]
        x = w["emb"][ids_t.long()]                              # (B, H)
        mask = (torch.arange(self.max_len, device=x.device) <= pos)[None]
        for L, (kc, vc) in zip(w["layers"], caches):

            def ctx_fn(h, L=L, kc=kc, vc=vc):
                q = (h @ L["q"].t()).reshape(b, cfg.num_heads, 1, hd)
                k = (h @ L["k"].t()).reshape(b, cfg.num_kv_heads, 1, hd)
                v = (h @ L["v"].t()).reshape(b, cfg.num_kv_heads, 1, hd)
                q = _apply_rope(q, cos, sin)
                kc[:, :, pos:pos + 1] = _apply_rope(k, cos, sin)
                vc[:, :, pos:pos + 1] = v
                ctx = self._attend(q, kc, vc, mask)
                return ctx.reshape(b, cfg.num_heads * hd) @ L["o"].t()

            x = self._layer(L, x, ctx_fn)
        return _rms(x, w["norm"], cfg.rms_eps) @ w["head"].t()

    def _prefill_rows_impl(self, w, ids, t0):
        """Batched prompt pass over padded ids (B, Lp) → (each layer's
        post-RoPE K/V rows (B, Hkv, Lp, D), logits (B, V) at the last real
        position ``t0 - 1``).  The reference's per-row ``t0`` vector
        belongs to the serving engine and ports with it."""
        cfg = self.cfg
        hd = cfg.head_dim
        b, lp = ids.shape
        cos, sin = self._rope.get(self.max_len, ids.device)
        cos, sin = cos[:lp], sin[:lp]
        x = w["emb"][ids.long()]                                # (B, Lp, H)
        causal = torch.ones((lp, lp), dtype=torch.bool,
                            device=x.device).tril()
        rows = []
        for L in w["layers"]:

            def ctx_fn(h, L=L):
                q = (h @ L["q"].t()).reshape(b, lp, cfg.num_heads, hd) \
                    .transpose(1, 2)
                k = (h @ L["k"].t()).reshape(b, lp, cfg.num_kv_heads, hd) \
                    .transpose(1, 2)
                v = (h @ L["v"].t()).reshape(b, lp, cfg.num_kv_heads, hd) \
                    .transpose(1, 2)
                q = _apply_rope(q, cos, sin)
                k = _apply_rope(k, cos, sin)
                rows.append((k, v))
                ctx = self._attend(q, k, v, causal)
                return ctx.transpose(1, 2) \
                    .reshape(b, lp, cfg.num_heads * hd) @ L["o"].t()

            x = self._layer(L, x, ctx_fn)
        return rows, _rms(x[:, t0 - 1], w["norm"], cfg.rms_eps) @ \
            w["head"].t()

    def _prefill_impl(self, w, ids, t0):
        """Prompt pass + full-length caches: K/V rows land at [0:Lp] of
        fresh (B, Hkv, max_len, D) caches; pad rows are overwritten by the
        decode steps starting at ``t0`` and hidden from real rows by the
        causal mask."""
        cfg = self.cfg
        rows, logits = self._prefill_rows_impl(w, ids, t0)
        shape = (ids.shape[0], cfg.num_kv_heads, self.max_len, cfg.head_dim)
        caches = []
        for k, v in rows:
            kc = torch.zeros(shape, dtype=k.dtype, device=k.device)
            vc = torch.zeros(shape, dtype=v.dtype, device=v.device)
            kc[:, :, :k.shape[2]] = k
            vc[:, :, :v.shape[2]] = v
            caches.append((kc, vc))
        return caches, logits

    _step_slots_impl = _not_ported("LlamaDecoder._step_slots_impl")
    _step_blocks_impl = _not_ported("LlamaDecoder._step_blocks_impl")
    _verify_blocks_impl = _not_ported("LlamaDecoder._verify_blocks_impl")
    _prefill_suffix_impl = _not_ported("LlamaDecoder._prefill_suffix_impl")

    def logits_at(self, ids):
        """Teacher-forced per-step decode over ``ids`` (B, T) returning
        logits at every position as a float32 numpy array (B, T, V)."""
        emb = self._net.model.embed_tokens.weight.data()._data
        ids = torch.as_tensor(np.asarray(ids), device=emb.device)
        b, t = ids.shape
        with torch.no_grad():
            w = self._weights()
            caches = self.init_cache(b)
            outs = [self._step_impl(w, caches, ids[:, p], p).float()
                    for p in range(t)]
        return torch.stack(outs, dim=1).cpu().numpy()

    @staticmethod
    def _pick(logits):
        """Greedy choice from last-position logits (B, V)."""
        return logits.argmax(dim=-1).to(torch.int32)

    def _generate_impl(self, w, ids, t0, n_steps):
        """Padded ids (B, Lp) + true length ``t0`` → (B, n_steps) tokens:
        batched prefill, then n_steps - 1 decode steps (the first token
        comes from the prefill logits)."""
        caches, logits = self._prefill_impl(w, ids, t0)
        cur = self._pick(logits)
        toks = [cur]
        for pos in range(t0, t0 + n_steps - 1):
            cur = self._pick(self._step_impl(w, caches, cur, pos))
            toks.append(cur)
        return torch.stack(toks, dim=1)

    @staticmethod
    def _bucket(n, quantum=16):
        b = quantum
        while b < n:
            b *= 2
        return b

    def _prompt_len(self, t0, n):
        """Padded prompt length for ``t0`` prompt and ``n`` new tokens:
        the reference's power-of-two bucket, or ``t0`` itself when the
        bucketed prompt and steps do not fit in ``max_len``."""
        lp = min(self._bucket(t0), self.max_len)
        nb = min(self._bucket(n), self.max_len - lp)
        return t0 if nb < n else lp

    def generate(self, ids, max_new_tokens, do_sample=False):
        """Greedy decode of ``ids`` (B, t0) → (B, t0 + max_new_tokens)
        int32 tensor on the weights' device.  The prompt is padded to the
        reference's power-of-two bucket (exact shapes when the bucketed
        padding does not fit), so the prefill sees the same shapes; only
        the ``max_new_tokens`` steps that are returned are run."""
        if do_sample:
            raise MXNetError(f"do_sample=True (sampling) {_LATER}")
        emb = self._net.model.embed_tokens.weight.data()._data
        ids = torch.as_tensor(ids).to(device=emb.device, dtype=torch.int32)
        b, t0 = ids.shape
        n = int(max_new_tokens)
        if n < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        if t0 + n > self.max_len:
            raise MXNetError("max_len exceeded; build a larger decoder")
        lp = self._prompt_len(t0, n)
        ids_pad = torch.zeros((b, lp), dtype=torch.int32, device=emb.device)
        ids_pad[:, :t0] = ids
        with torch.no_grad():
            toks = self._generate_impl(self._weights(), ids_pad, t0, n)
        return torch.cat([ids, toks], dim=1)


def llama3_8b(**overrides):
    """Llama-3-8B architecture."""
    return LlamaForCausalLM(LlamaConfig(**{**LLAMA_CONFIGS["llama3_8b"],
                                           **overrides}))


def llama_tiny(**overrides):
    """Tiny config for tests."""
    return LlamaForCausalLM(LlamaConfig(**{**LLAMA_CONFIGS["llama_tiny"],
                                           **overrides}))


mixtral_8x7b = _not_ported("mixtral_8x7b (MoE)")
mixtral_tiny = _not_ported("mixtral_tiny (MoE)")
shard_llama = _not_ported("shard_llama")
llama_param_pspecs = _not_ported("llama_param_pspecs")
llama_pipeline_forward = _not_ported("llama_pipeline_forward")
llama_pipeline_train_step = _not_ported("llama_pipeline_train_step")
packed_lm_loss = _not_ported("packed_lm_loss")


def _lm_head(net, h):
    """Hidden states → vocab logits: tied configs reuse the embedding
    matrix, untied ones (``llama3_8b``) use the ``lm_head`` Dense."""
    if net._cfg.tie_embeddings:
        w = net.model.embed_tokens.weight.data()
        return apply_op(lambda hr, wr: hr @ wr.t(), h, w,
                        name="tied_lm_head")
    return net.lm_head(h)
