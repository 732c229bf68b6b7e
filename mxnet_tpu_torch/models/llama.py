"""Llama model family: inference and training.

Counterpart of ``mxnet_tpu/models/llama.py``.  The Gluon blocks
(``LlamaForCausalLM`` and its parts) run the prompt/scoring forward with
the hand-written CUDA flash-attention kernels (``attn_mode="flash"``, the
default) or dense attention (``"sdpa"``); under ``autograd.record()``
both are differentiable, the flash route through the backward kernels
(GQA heads are repeated before the call, so the repeat's backward sums
dK/dV over each group).  ``generate`` runs the KV-cached
``LlamaDecoder``: one batched prefill, then greedy decode steps, with
dense attention as in the reference; ``do_sample=True`` draws from the
temperature / top-k / nucleus-filtered distribution (``_pick``).  The
decoder also carries the serving programs the continuous-batching
engine (``serving/generative.py``) runs: the per-slot decode step over
slot caches (``_step_slots_impl``) or a paged block pool
(``_step_blocks_impl``), the speculative verify window
(``_verify_blocks_impl``), the batched prefill with a per-row true
length (``_prefill_rows_impl``) and the radix-hit suffix prefill
(``_prefill_suffix_impl``), all dense torch ops with f32 scores, as the
reference's are jnp outside any Pallas kernel.

Numerics follow the reference: RMSNorm statistics in f32 cast back to
the input dtype; RoPE tables computed in float64, stored f32, applied to
interleaved pairs (x[..., ::2], x[..., 1::2]) in f32 and cast back; GQA
heads repeated with ``repeat_interleave``; attention scores in f32 with
P cast to the activation dtype before the PV product.

On a CUDA card ``generate`` replays one captured CUDA graph per decode
signature (batch, sampling settings) for its decode steps
(``LlamaDecoder.generate``); the prefill runs eagerly.

``attn_mode="ring"``/``"ulysses"`` route attention through
``parallel.ring`` (sequence parallelism over the mesh's ``sp`` axis;
without one, the flash call), and ``shard_llama``/``llama_param_pspecs``
place the weights in the Megatron layout over a mesh.

``llama_pipeline_forward`` (GPipe) and ``llama_pipeline_train_step``
(1F1B) cut the decoder stack into the ``pp`` axis's stages
(``parallel.pipeline``), each stage running layer 0's own code with its
layers' weights swapped in.

MoE (``num_experts > 0``: ``mixtral_8x7b``, ``mixtral_tiny``) builds
each layer's MLP as ``models.moe.MoEMLP``; ``generate`` then takes the
uncached greedy oracle route whatever ``use_cache`` says (the KV-cached
``LlamaDecoder``, and so the serving engine, runs dense MLPs only, as
the reference's), and ``shard_llama`` places the expert banks over
``ep`` by ``MIXTRAL_RULES``.

The numerics taps of the reference (``telemetry.numerics``): ``embed``,
``decoder.<i>`` after every decoder layer, ``norm`` and ``logits``; with
the tier off each is one boolean test.

``LlamaConfig(scan_layers=True)`` runs the decoder stack layer by layer,
each layer on its own parameters under ``memory.policy.checkpoint_wrap``
at the tier ``set_remat`` chose (default ``"layer"``; ``"auto"`` asks the
planner at the live activation's size), with the ``decoder.<i>`` taps as
on the plain route.  The reference scans one traced layer over stacked
parameters, XLA's compile-once device; here the layers stay as they are
(stacking would copy every layer's weights a step).  As in the
reference, ``set_remat`` acts on the ``scan_layers`` route only: the
plain layer loop keeps every activation.  Packed ``segment_ids`` and
``packed_lm_loss`` (slice 10) take the dense masked route on both.

Sampling cannot reproduce the reference's draws (JAX's PRNG is not
torch's): the filters are the reference's arithmetic on the same
logits, and the draw is ``torch.multinomial`` from a ``torch.Generator``
on the logits' device, seeded by ``seed`` or, without one, the
package's per-device generator (``mxnet_tpu_torch.random``).  Greedy
decoding never touches a generator.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch

from .. import autograd
from .. import cuda_graph as cuda_graph_mod
from .. import engine
from .. import ndarray as nd
from .. import random as mx_random
from ..base import MXNetError
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ndarray import NDArray
from ..ops.flash_attention import _sdpa_ref, flash_attention_raw
from ..ops.registry import apply_op
from ..parallel.local import as_global, is_dtensor
from ..telemetry import numerics as _numerics

__all__ = ["LlamaConfig", "RMSNorm", "LlamaAttention", "LlamaMLP",
           "LlamaDecoderLayer", "LlamaModel", "LlamaForCausalLM",
           "LlamaDecoder", "llama3_8b", "llama_tiny", "mixtral_8x7b",
           "mixtral_tiny", "shard_llama", "llama_param_pspecs",
           "llama_pipeline_forward", "llama_pipeline_train_step",
           "packed_lm_loss", "LLAMA_CONFIGS"]

# batch sizes whose decode graph states (caches included) a decoder keeps,
# and sampling keys whose graphs each of them keeps
_DECODE_BATCHES_KEPT = 4


class LlamaConfig:
    def __init__(self, hidden_size=4096, intermediate_size=14336,
                 num_layers=32, num_heads=32, num_kv_heads=8,
                 vocab_size=128256, max_seq_len=8192, rope_theta=500000.0,
                 rms_eps=1e-5, tie_embeddings=False, attn_mode="flash",
                 num_experts=0, num_experts_per_tok=2,
                 capacity_factor=1.25, moe_router="topk",
                 scan_layers=False):
        if attn_mode not in ("flash", "sdpa", "ring", "ulysses"):
            raise MXNetError(f"unknown attn_mode {attn_mode!r}")
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
        # MoE (Mixtral-style): 0 experts = dense SwiGLU MLP; the router
        # is topk or expert_choice (models/moe.py)
        self.num_experts = num_experts
        self.num_experts_per_tok = num_experts_per_tok
        self.capacity_factor = capacity_factor
        self.moe_router = moe_router
        # scan_layers: the decoder stack under the remat tier of
        # set_remat (default "layer"), one checkpoint a layer
        self.scan_layers = scan_layers
        self.head_dim = hidden_size // num_heads


LLAMA_CONFIGS = {
    "llama3_8b": dict(hidden_size=4096, intermediate_size=14336,
                      num_layers=32, num_heads=32, num_kv_heads=8,
                      vocab_size=128256, rope_theta=500000.0),
    "llama_tiny": dict(hidden_size=64, intermediate_size=176,
                       num_layers=2, num_heads=4, num_kv_heads=2,
                       vocab_size=256, max_seq_len=128),
    # Mixtral-8x7B architecture (sparse MoE decoder, top-2 of 8 experts)
    "mixtral_8x7b": dict(hidden_size=4096, intermediate_size=14336,
                         num_layers=32, num_heads=32, num_kv_heads=8,
                         vocab_size=32000, rope_theta=1e6,
                         num_experts=8, num_experts_per_tok=2),
    "mixtral_tiny": dict(hidden_size=64, intermediate_size=176,
                         num_layers=2, num_heads=4, num_kv_heads=2,
                         vocab_size=256, max_seq_len=128,
                         num_experts=4, num_experts_per_tok=2),
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
    if is_dtensor(x):  # the tables are the same on every rank
        cos, sin = as_global(cos, x.device_mesh), as_global(sin,
                                                           x.device_mesh)
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
        """``segment_ids`` (B, T) int: a packed batch
        (``data.SequencePacker``).  Attention is then causal AND
        same-segment, through the dense ``_sdpa_segmented`` in either
        ``attn_mode`` (the flash kernels take no mask, as the
        reference's)."""
        cfg = self._cfg
        b, t = x.shape[0], x.shape[1]
        hd = cfg.head_dim
        scale = 1.0 / math.sqrt(hd)

        def _heads(qr, kr, vr):
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
            return qh, kh, vh

        def _attend(qr, kr, vr):
            qh, kh, vh = _heads(qr, kr, vr)
            if cfg.attn_mode in ("ring", "ulysses"):
                from ..parallel import ring as _ring

                fn = (_ring.ring_attention_raw if cfg.attn_mode == "ring"
                      else _ring.ulysses_attention_raw)
                out = fn(qh, kh, vh, causal=True, scale=scale)
            elif cfg.attn_mode == "flash":
                out = flash_attention_raw(qh.contiguous(), kh.contiguous(),
                                          vh.contiguous(), True, scale)
            else:
                out = _sdpa_ref(qh, kh, vh, True, scale)
            return out.transpose(1, 2).reshape(b, t, -1)

        def _attend_packed(qr, kr, vr, segr):
            out = _sdpa_segmented(*_heads(qr, kr, vr), segr, scale)
            return out.transpose(1, 2).reshape(b, t, -1)

        if segment_ids is None:
            ctx = apply_op(_attend, self.q_proj(x), self.k_proj(x),
                           self.v_proj(x), name="llama_attention")
        else:
            ctx = apply_op(_attend_packed, self.q_proj(x), self.k_proj(x),
                           self.v_proj(x), segment_ids,
                           name="llama_attention_packed")
        return self.o_proj(ctx)


def _segment_causal_mask(seg):
    """(B, T) int segment ids → (B, 1, T, T) bool mask: causal AND
    same-segment (reference ``_segment_causal_mask``).  The diagonal is
    always kept, so no row is fully masked and the softmax has no NaN
    even on padding rows (segment 0), which see only padding and whose
    loss ``PackedBatch.loss_mask`` drops."""
    t = seg.shape[1]
    same = seg[:, :, None] == seg[:, None, :]
    causal = torch.ones(t, t, dtype=torch.bool, device=seg.device).tril()
    return (same & causal[None])[:, None]


def _sdpa_segmented(q, k, v, seg, scale):
    """Dense attention under the segment-causal mask (reference
    ``_sdpa_segmented``): f32 scores and softmax, P cast to v's dtype
    before the PV product.  q/k/v (B, H, T, D) after the GQA repeat, seg
    (B, T) int."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s.masked_fill(~_segment_causal_mask(seg), float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


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
            if cfg.num_experts > 0:
                from .moe import MoEMLP

                self.mlp = MoEMLP(cfg.hidden_size, cfg.intermediate_size,
                                  cfg.num_experts, cfg.num_experts_per_tok,
                                  cfg.capacity_factor, cfg.moe_router,
                                  prefix="moe_")
            else:
                self.mlp = LlamaMLP(cfg, prefix="mlp_")

    def hybrid_forward(self, F, x, segment_ids=None):
        if segment_ids is None:
            x = x + self.self_attn(self.input_layernorm(x))
        else:
            x = x + self.self_attn(self.input_layernorm(x), segment_ids)
        return x + self.mlp(self.post_attention_layernorm(x))


def _resolve_model_remat(model, h):
    """The decoder stack's remat tier: ``set_remat()``'s choice, the
    planner's pick for "auto" (cheapest tier that fits, sized at the
    live activation ``h``), or the "layer" default."""
    from .. import parallel
    from ..memory import policy as _mem_policy

    tier = _mem_policy.normalize(getattr(model, "_remat", "layer"))
    if tier != "auto":
        if tier != "none":
            _mem_policy.record_policy(tier, "forced")
        return tier
    raw = h._data
    batch_b = raw.numel() * raw.element_size()
    tier, _plan = _mem_policy.auto_tier(
        model, mesh=parallel.current_mesh(), batch_bytes=batch_b)
    return tier


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

    def hybrid_forward(self, F, input_ids, segment_ids=None):
        h = self.embed_tokens(input_ids)
        _numerics.tap("embed", h)
        if self._cfg.scan_layers and len(self.layers) > 1:
            from ..memory.policy import checkpoint_wrap

            tier = _resolve_model_remat(self, h)
            for i, layer in enumerate(self.layers):
                run = checkpoint_wrap(layer, tier)
                h = run(h) if segment_ids is None else run(h, segment_ids)
                _numerics.tap(f"decoder.{i}", h)
        else:
            for i, layer in enumerate(self.layers):
                h = layer(h) if segment_ids is None \
                    else layer(h, segment_ids)
                _numerics.tap(f"decoder.{i}", h)
        h = self.norm(h)
        _numerics.tap("norm", h)
        return h


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
        """``segment_ids`` (B, T) int: packed pretraining
        (``data.SequencePacker``); attention is masked to causal AND
        same-segment so packed documents never see each other."""
        if segment_ids is None:
            out = _lm_head(self, self.model(input_ids))
        else:
            out = _lm_head(self, self.model(input_ids, segment_ids))
        _numerics.tap("logits", out)
        return out

    def set_remat(self, tier):
        """Set the decoder-stack remat tier ("none" / "dots" / "layer"
        / "auto"; see ``mxnet_tpu_torch.memory.policy``) of the
        ``scan_layers`` route.  "auto" asks the planner for the cheapest
        tier that fits the device budget at each forward.  Default is
        "layer": one checkpoint a decoder layer."""
        from ..memory import policy as _mem_policy

        self.model._remat = _mem_policy.normalize(tier)
        return self

    def generate(self, input_ids, max_new_tokens=16, use_cache=True,
                 do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                 seed=None):
        """Decoding.  ``use_cache=True`` (default) runs the KV-cached
        ``LlamaDecoder``; ``use_cache=False``, and any MoE config,
        re-forwards the whole sequence per token (the reference's greedy
        oracle path).  ``do_sample=True`` draws from the temperature /
        top-k / top-p filtered distribution (cached path only)."""
        need = input_ids.shape[1] + max_new_tokens
        max_ctx = self._cfg.max_seq_len
        if need > max_ctx:
            raise MXNetError(
                f"generate: prompt ({input_ids.shape[1]}) + max_new_tokens "
                f"({max_new_tokens}) = {need} exceeds the model's "
                f"max_seq_len ({max_ctx}); RoPE tables and KV caches are "
                f"only valid inside the trained context window")
        if use_cache and self._cfg.num_experts == 0:
            return self._generate_cached(
                input_ids, max_new_tokens, do_sample=do_sample,
                temperature=temperature, top_k=top_k, top_p=top_p,
                seed=seed)
        if do_sample:
            raise MXNetError("do_sample requires the KV-cache path "
                             "(use_cache=True, dense MLP config)")
        cur = input_ids
        with autograd.pause():
            for _ in range(max_new_tokens):
                logits = self(cur)
                nxt = nd.argmax(logits, axis=-1)[:, -1:]
                cur = nd.concat(cur, nxt.astype(cur.dtype), dim=1)
        return cur

    def _generate_cached(self, input_ids, max_new_tokens, **sample_kw):
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
        ids = dec.generate(input_ids._data, max_new_tokens, **sample_kw)
        return NDArray(ids).astype(input_ids.dtype)


def _dequantize(leaf):
    """An int8 weight of the serving engine's int8 tree (``{"q8": int8
    rows, "scale": f32 per-row scales}``) as f32: rows × their scales."""
    return leaf["q8"].to(leaf["scale"].dtype) * leaf["scale"]


def _mm(x, w):
    """``x @ w.T`` with JAX's type promotion: the dequantized f32 weights
    of an int8-served net promote bf16 activations to f32, as jnp's ``@``
    does.  An int8 leaf is dequantized here, one matrix at a time just
    before its product, and freed after it (the reference's jit fuses
    the same dequantization into the matmul)."""
    if isinstance(w, dict):
        w = _dequantize(w)
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w.t()


def _filter_logits(logits, temperature, top_k, top_p):
    """The reference's sampling filters (its ``_pick``) on (B, V) logits,
    in f32: divide by ``max(temperature, 1e-6)``; keep the ``top_k``
    largest (ties with the k-th kept); then the nucleus: sorted
    descending, drop every token whose EXCLUSIVE cumulative probability
    reaches ``top_p`` (the top token always survives).  Dropped entries
    are -inf.  ``temperature`` and ``top_p`` may be 0-d f32 tensors (a
    captured graph's static inputs): the temperature is then already
    clamped, and a tensor ``top_p`` always filters."""
    if not torch.is_tensor(temperature):
        temperature = max(float(temperature), 1e-6)
    lg = logits.float() / temperature
    if top_k and top_k < lg.shape[-1]:
        kth = torch.sort(lg, dim=-1).values[:, -top_k][:, None]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    if torch.is_tensor(top_p) or top_p < 1.0:
        srt = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1) - probs
        count = (cum < top_p).sum(-1).clamp_min(1)
        thresh = srt.gather(1, (count - 1)[:, None])
        lg = lg.masked_fill(lg < thresh, float("-inf"))
    return lg


class LlamaDecoder:
    """Incremental decoder with a static-shape KV cache, and the serving
    programs of the continuous-batching engine.

    ``generate`` runs one batched prefill over the padded prompt, which
    writes the prompt's K/V into (B, Hkv, max_len, D) caches, then decode
    steps (greedy, or sampled); each step writes its K/V row into the
    caches in place (the reference's functional update, done in place to
    keep one copy of the cache) and attends the whole cache under a
    ``t <= pos`` mask.  Weights are read from the net's Parameters on
    every call.  Attention is dense (``_attend``), as in the reference.

    The serving programs write their caches and pools in place too (the
    reference donates them).  A paged pool (``_step_blocks_impl``,
    ``_verify_blocks_impl``) is ``(num_blocks + 1, Hkv, block_size, D)``:
    the reference writes vacant slots and over-budget columns at the
    out-of-bounds sentinel id ``num_blocks``, and XLA drops those
    writes; torch has no dropping scatter, so the pool carries one trash
    block at that index, which those writes hit and the clamped gathers
    (``min(tables, num_blocks - 1)``) never read.
    """

    def __init__(self, net: "LlamaForCausalLM", max_len: int):
        cfg = net.config
        if cfg.num_experts:
            raise MXNetError("LlamaDecoder supports dense MLP configs")
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
        return torch.matmul(attn, v.to(q.dtype))

    def _embed(self, w, ids):
        """Token ids (any shape) → their embedding rows."""
        return w["emb"][ids.long()]

    @staticmethod
    def _reduce(t):
        """The sum of a row-parallel product's partial results over the
        tensor-parallel ranks: one rank holds it whole (the serving
        engine's tensor-parallel decoder sums over its group)."""
        return t

    def _layer(self, L, x, ctx_fn):
        """Residual wiring: x + attn(ln(x)), then + mlp(ln(x))."""
        eps = self.cfg.rms_eps
        x = x + ctx_fn(_rms(x, L["ln_in"], eps))
        h2 = _rms(x, L["ln_post"], eps)
        g = _mm(h2, L["gate"])
        return x + self._reduce(_mm(g * torch.sigmoid(g) * _mm(h2, L["up"]),
                                    L["down"]))

    def _qkv(self, L, h, cos, sin):
        """RoPE'd q, k and v of ``h`` (*lead, T, hidden) as (*lead, heads,
        T, D); ``cos``/``sin`` broadcast against (*lead, heads, T, D/2)."""
        cfg = self.cfg
        lead = h.shape[:-1]

        def split(t, heads):
            return t.reshape(*lead, heads, cfg.head_dim).transpose(-3, -2)

        q = split(_mm(h, L["q"]), cfg.num_heads)
        k = split(_mm(h, L["k"]), cfg.num_kv_heads)
        v = split(_mm(h, L["v"]), cfg.num_kv_heads)
        return _apply_rope(q, cos, sin), _apply_rope(k, cos, sin), v

    def _out(self, L, ctx):
        """Context (*lead, H, T, D) → o_proj of (*lead, T, H·D)."""
        ctx = ctx.transpose(-3, -2)
        return self._reduce(_mm(ctx.reshape(*ctx.shape[:-2], -1), L["o"]))

    def _logits(self, w, x):
        return _mm(_rms(x, w["norm"], self.cfg.rms_eps), w["head"])

    def _step_impl(self, w, caches, ids_t, pos):
        """ids_t (B,) int, pos an int or a (1,) int64 tensor on the
        device → logits (B, V); writes position ``pos`` of every layer's
        caches in place.  With a tensor ``pos`` the step reads nothing on
        the host, so it can be captured in a CUDA graph."""
        dev = ids_t.device
        if not isinstance(pos, torch.Tensor):
            pos = torch.tensor([pos], device=dev)
        pos = pos.reshape(1).long()
        cos, sin = self._rope.get(self.max_len, dev)
        cos, sin = cos.index_select(0, pos), sin.index_select(0, pos)
        x = self._embed(w, ids_t)[:, None]                     # (B, 1, H)
        mask = (torch.arange(self.max_len, device=dev) <= pos)[None]
        for L, (kc, vc) in zip(w["layers"], caches):

            def ctx_fn(h, L=L, kc=kc, vc=vc):
                q, k, v = self._qkv(L, h, cos, sin)
                kc.index_copy_(2, pos, k.to(kc.dtype))
                vc.index_copy_(2, pos, v.to(vc.dtype))
                return self._out(L, self._attend(q, kc, vc, mask))

            x = self._layer(L, x, ctx_fn)
        return self._logits(w, x[:, 0])

    def _step_slots_impl(self, w, caches, ids_t, pos):
        """Per-slot decode step for continuous batching: ids_t (S,) and
        pos (S,) int tensors → logits (S, V); writes each slot's K/V row
        at its own ``pos`` of its own cache row, in place.  RoPE rows are
        gathered per slot and the causal mask is ``t <= pos[s]`` per slot.
        Vacant slots run at pos 0 with token 0: their write lands in their
        own slot row only, which admission's prefill replaces."""
        s = ids_t.shape[0]
        pos = pos.long()
        cos, sin = self._rope.get(self.max_len, ids_t.device)
        cos, sin = cos[pos][:, None, None], sin[pos][:, None, None]
        x = self._embed(w, ids_t)[:, None]                     # (S, 1, H)
        mask = (torch.arange(self.max_len, device=x.device)[None]
                <= pos[:, None])[:, None, None]                 # (S,1,1,T)
        rows = torch.arange(s, device=x.device)
        for L, (kc, vc) in zip(w["layers"], caches):

            def ctx_fn(h, L=L, kc=kc, vc=vc):
                q, k, v = self._qkv(L, h, cos, sin)
                kc[rows, :, pos] = k[:, :, 0].to(kc.dtype)
                vc[rows, :, pos] = v[:, :, 0].to(vc.dtype)
                return self._out(L, self._attend(q, kc, vc, mask))

            x = self._layer(L, x, ctx_fn)
        return self._logits(w, x[:, 0])

    def _step_blocks_impl(self, w, pools, tables, ids_t, pos):
        """Per-slot decode step against a paged KV pool: the contract of
        ``_step_slots_impl`` with block-granular storage.  ``pools[l]`` is
        ``(kp, vp)``, each ``(num_blocks + 1, Hkv, block_size, D)`` shared
        by every slot (the last block is the trash block); ``tables``
        (S, MB) holds each slot's block ids in logical order, vacant
        entries ``num_blocks``.  Each slot's new K/V lands at
        ``(tables[s, pos // bs], pos % bs)`` (a vacant slot's in the trash
        block), and each slot attends its logical view (S, Hkv, MB·bs, D)
        gathered through the clamped table; rows read through clamped
        sentinel entries sit where the mask ``t <= pos`` never looks."""
        s = ids_t.shape[0]
        nb, hkv, bs, hd = pools[0][0].shape
        nb -= 1
        tables = tables.long()
        t = tables.shape[1] * bs
        pos = pos.long()
        cos, sin = self._rope.get(self.max_len, ids_t.device)
        cos, sin = cos[pos][:, None, None], sin[pos][:, None, None]
        x = self._embed(w, ids_t)[:, None]                     # (S, 1, H)
        mask = (torch.arange(t, device=x.device)[None]
                <= pos[:, None])[:, None, None]                 # (S,1,1,T)
        blk = tables.gather(1, (pos // bs)[:, None])[:, 0]      # (S,)
        off = pos % bs
        gat = tables.clamp(max=nb - 1)
        for L, (kp, vp) in zip(w["layers"], pools):

            def ctx_fn(h, L=L, kp=kp, vp=vp):
                q, k, v = self._qkv(L, h, cos, sin)
                kp[blk, :, off] = k[:, :, 0].to(kp.dtype)
                vp[blk, :, off] = v[:, :, 0].to(vp.dtype)
                kc = kp[gat].transpose(1, 2).reshape(s, hkv, t, hd)
                vc = vp[gat].transpose(1, 2).reshape(s, hkv, t, hd)
                return self._out(L, self._attend(q, kc, vc, mask))

            x = self._layer(L, x, ctx_fn)
        return self._logits(w, x[:, 0])

    def _verify_blocks_impl(self, w, pools, tables, toks, pos0):
        """Speculative verify against the paged pool: the paged step
        widened to K = k + 1 positions a slot in one forward.  ``toks``
        (S, K) is ``[last_committed, draft_1 .. draft_k]`` a slot and
        ``pos0`` (S,) each slot's committed write cursor, so column j sits
        at ``pos0[s] + j``.  Returns logits (S, K, V): column j is the
        target's next-token distribution after ``toks[s, :j + 1]``.

        All K columns' K/V land in the slot's own blocks at their
        absolute positions (columns at or past ``max_len``, and vacant
        slots, in the trash block).  Rejected columns need no cleanup:
        they sit past the rolled-back cursor, where the mask never looks,
        until the next window overwrites them.  The mask is per column,
        ``t <= pos0[s] + j`` (explicit: Tq = K differs from Tk, and the
        alignment must be the reference's, not top-left)."""
        s, kk = toks.shape
        nb, hkv, bs, hd = pools[0][0].shape
        nb -= 1
        tables = tables.long()
        mb = tables.shape[1]
        t = mb * bs
        dev = toks.device
        pw = pos0.long()[:, None] + torch.arange(kk, device=dev)[None]
        cos, sin = self._rope.get(self.max_len, dev)
        pwc = pw.clamp(max=self.max_len - 1)   # RoPE rows of real columns
        cos, sin = cos[pwc][:, None], sin[pwc][:, None]         # (S,1,K,·)
        x = self._embed(w, toks)                               # (S, K, H)
        mask = (torch.arange(t, device=dev)[None, None]
                <= pw[:, :, None])[:, None]                     # (S,1,K,T)
        blk = tables.gather(1, (pw // bs).clamp(max=mb - 1))
        blk = torch.where(pw < self.max_len, blk, torch.full_like(blk, nb))
        off = pw % bs
        gat = tables.clamp(max=nb - 1)
        for L, (kp, vp) in zip(w["layers"], pools):

            def ctx_fn(h, L=L, kp=kp, vp=vp):
                q, k, v = self._qkv(L, h, cos, sin)
                kp[blk, :, off] = k.transpose(1, 2).to(kp.dtype)
                vp[blk, :, off] = v.transpose(1, 2).to(vp.dtype)
                kc = kp[gat].transpose(1, 2).reshape(s, hkv, t, hd)
                vc = vp[gat].transpose(1, 2).reshape(s, hkv, t, hd)
                return self._out(L, self._attend(q, kc, vc, mask))

            x = self._layer(L, x, ctx_fn)
        return self._logits(w, x)

    def _prefill_rows_impl(self, w, ids, t0):
        """Batched prompt pass over padded ids (B, Lp) → (each layer's
        post-RoPE K/V rows (B, Hkv, Lp, D), logits (B, V) at each row's
        last real position).  ``t0`` is the true length: one int for the
        batch, or a (B,) tensor, one a row (serving admits prompts of
        several lengths in one padded prefill)."""
        b, lp = ids.shape
        cos, sin = self._rope.get(self.max_len, ids.device)
        cos, sin = cos[:lp], sin[:lp]
        x = self._embed(w, ids)                                # (B, Lp, H)
        causal = torch.ones((lp, lp), dtype=torch.bool,
                            device=x.device).tril()
        rows = []
        for L in w["layers"]:

            def ctx_fn(h, L=L):
                q, k, v = self._qkv(L, h, cos, sin)
                rows.append((k, v))
                return self._out(L, self._attend(q, k, v, causal))

            x = self._layer(L, x, ctx_fn)
        if isinstance(t0, torch.Tensor) and t0.dim() == 1:
            x_last = x[torch.arange(b, device=x.device), t0.long() - 1]
        else:
            x_last = x[:, int(t0) - 1]
        return rows, self._logits(w, x_last)

    def _prefill_impl(self, w, ids, t0, caches=None):
        """Prompt pass + full-length caches: K/V rows land at [0:Lp] of
        (B, Hkv, max_len, D) caches, zero elsewhere (fresh ones, or
        ``caches`` given, overwritten in place); pad rows are overwritten
        by the decode steps starting at ``t0`` and hidden from real rows
        by the causal mask."""
        rows, logits = self._prefill_rows_impl(w, ids, t0)
        if caches is None:
            caches = self.init_cache(ids.shape[0])
        for (kc, vc), (k, v) in zip(caches, rows):
            kc.zero_()
            vc.zero_()
            kc[:, :, :k.shape[2]] = k
            vc[:, :, :v.shape[2]] = v
        return caches, logits

    def _prefill_suffix_impl(self, w, prefix_kv, ids, t0, s0):
        """Prompt-suffix prefill over a reused prefix (the radix cache):
        ``prefix_kv[l] = (K, V)``, each (B, Hkv, Lpre, D), holds each row's
        leading ``s0[b]`` tokens of K/V (dense copies of shared pool
        blocks; garbage past ``s0[b]``), and only the novel suffix ``ids``
        (B, Ls) runs through the layers.  Suffix row j sits at position
        ``s0[b] + j`` (RoPE and mask) and attends every real prefix column
        (``t < s0[b]``) and the suffix causally: the attention of a full
        prefill, at the suffix's projection and MLP cost.  Returns the
        suffix rows' post-RoPE K/V and logits at each row's last real
        suffix position ``t0[b] - 1``; a row with no hit has ``s0 = 0``
        (every prefix column masked: a plain prefill)."""
        b, ls = ids.shape
        lpre = prefix_kv[0][0].shape[2]
        dev = ids.device
        s0 = s0.long()
        pw = (s0[:, None] + torch.arange(ls, device=dev)[None]).clamp(
            max=self.max_len - 1)
        cos, sin = self._rope.get(self.max_len, dev)
        cos, sin = cos[pw][:, None], sin[pw][:, None]           # (B,1,Ls,·)
        x = self._embed(w, ids)                                # (B, Ls, H)
        mask_pre = (torch.arange(lpre, device=dev)[None, None, None]
                    < s0[:, None, None, None]).expand(b, 1, ls, lpre)
        mask_suf = torch.ones((ls, ls), dtype=torch.bool, device=dev) \
            .tril()[None, None].expand(b, 1, ls, ls)
        mask = torch.cat([mask_pre, mask_suf], dim=-1)
        rows = []
        for L, (pk, pv) in zip(w["layers"], prefix_kv):

            def ctx_fn(h, L=L, pk=pk, pv=pv):
                q, k, v = self._qkv(L, h, cos, sin)
                rows.append((k, v))
                kc = torch.cat([pk, k.to(pk.dtype)], dim=2)
                vc = torch.cat([pv, v.to(pv.dtype)], dim=2)
                return self._out(L, self._attend(q, kc, vc, mask))

            x = self._layer(L, x, ctx_fn)
        x_last = x[torch.arange(b, device=dev), t0.long() - 1]
        return rows, self._logits(w, x_last)

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
    def _pick(logits, generator=None, temperature=1.0, top_k=0, top_p=1.0,
              do_sample=False):
        """Greedy choice, or a draw from the filtered distribution
        (``_filter_logits``) with ``generator``, from last-position
        logits (B, V) → (B,) int32."""
        if not do_sample:
            return logits.argmax(dim=-1).to(torch.int32)
        probs = torch.softmax(_filter_logits(logits, temperature, top_k,
                                             top_p), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0] \
            .to(torch.int32)

    def _generate_impl(self, w, ids, t0, n_steps, pick):
        """Padded ids (B, Lp) + true length ``t0`` → (B, n_steps) tokens:
        batched prefill, then n_steps - 1 decode steps (the first token
        comes from the prefill logits); ``pick`` maps logits to tokens."""
        caches, logits = self._prefill_impl(w, ids, t0)
        cur = pick(logits)
        toks = [cur]
        for pos in range(t0, t0 + n_steps - 1):
            cur = pick(self._step_impl(w, caches, cur, pos))
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

    def generate(self, ids, max_new_tokens, do_sample=False,
                 temperature=1.0, top_k=0, top_p=1.0, seed=None):
        """Decode ``ids`` (B, t0) → (B, t0 + max_new_tokens) int32 tensor
        on the weights' device: greedy, or sampled with ``do_sample``
        (a generator seeded with ``seed``, else the package's generator of
        the weights' device).  The prompt is padded to the reference's
        power-of-two bucket (exact shapes when the bucketed padding does
        not fit), so the prefill sees the same shapes; only the
        ``max_new_tokens`` steps that are returned are run.  On a CUDA
        card the decode steps replay a captured graph
        (``_generate_graphed``) unless the NaiveEngine is chosen
        (``engine.set_engine_type``), which takes eager steps."""
        emb = self._net.model.embed_tokens.weight.data()._data
        ids = torch.as_tensor(ids).to(device=emb.device, dtype=torch.int32)
        b, t0 = ids.shape
        n = int(max_new_tokens)
        if n < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        if t0 + n > self.max_len:
            raise MXNetError("max_len exceeded; build a larger decoder")
        graphed = emb.is_cuda and n > 1 and not engine.is_naive()
        gen = None
        if do_sample and seed is not None:
            # a graph replays with the generator it registered: keep one
            # a decoder and re-seed it
            gen = self.__dict__.get("_seeded_gen") if graphed else None
            if gen is None:
                gen = torch.Generator(device=emb.device)
                if graphed:
                    self._seeded_gen = gen
            gen.manual_seed(int(seed))
        elif do_sample:
            gen = mx_random.generator(emb.device)
        # temperature and top_p as device scalars on both routes: a graph
        # reads them from its static copies, and a CUDA division by a host
        # scalar would round otherwise (it multiplies by the reciprocal)
        temp = torch.tensor(max(float(temperature), 1e-6),
                            dtype=torch.float32, device=emb.device)
        nucleus = float(top_p) < 1.0
        top_p = torch.tensor(float(top_p), dtype=torch.float32,
                             device=emb.device) if nucleus else 1.0
        lp = self._prompt_len(t0, n)
        ids_pad = torch.zeros((b, lp), dtype=torch.int32, device=emb.device)
        ids_pad[:, :t0] = ids
        with torch.no_grad():
            w = self._weights()
            if graphed:
                toks = self._generate_graphed(
                    w, ids_pad, t0, n, (bool(do_sample), int(top_k), nucleus,
                                        gen), temp, top_p, seed)
            else:
                toks = self._generate_impl(
                    w, ids_pad, t0, n, lambda logits: self._pick(
                        logits, gen, temp, top_k, top_p, do_sample))
        return torch.cat([ids, toks], dim=1)

    def _decode_state(self, w, b):
        """The static state of batch ``b``'s decode graphs for the weights
        ``w``: the caches, the current token ``cur`` (B,), the position
        ``pos`` (1,), ``out`` (B, max_len), where a step writes its token
        at ``pos``, the sampling scalars, and ``graphs``, one a sampling
        key.  When a weight has moved (``cast``, a forced
        re-initialization) every graph is dropped; the states of the
        ``_DECODE_BATCHES_KEPT`` batch sizes used last are kept."""
        states = self.__dict__.setdefault("_decode_states", OrderedDict())
        # a freed weight's address can come back with another dtype
        ptrs = tuple((t.data_ptr(), t.dtype) for t in _leaves(w))
        if self.__dict__.get("_decode_ptrs") != ptrs:
            states.clear()
            self._decode_ptrs = ptrs
        st = states.pop(b, None)
        if st is None:
            dev = w["emb"].device
            st = dict(caches=self.init_cache(b),
                      cur=torch.zeros(b, dtype=torch.int32, device=dev),
                      pos=torch.zeros(1, dtype=torch.int64, device=dev),
                      out=torch.zeros((b, self.max_len), dtype=torch.int32,
                                      device=dev),
                      temp=torch.ones((), dtype=torch.float32, device=dev),
                      top_p=torch.ones((), dtype=torch.float32, device=dev),
                      graphs=OrderedDict())
        states[b] = st
        while len(states) > _DECODE_BATCHES_KEPT:
            states.popitem(last=False)
        return st

    def _decode_graph(self, w, st, key):
        """The captured decode step of the state ``st`` for the sampling
        key ``(do_sample, top_k, top_p < 1, generator)``: one replay
        decodes one token at ``pos`` and advances it."""
        graph = st["graphs"].pop(key, None)
        if graph is None:
            do_sample, top_k, nucleus, gen = key
            top_p = st["top_p"] if nucleus else 1.0
            cur, pos, out = st["cur"], st["pos"], st["out"]

            def step():
                tok = self._pick(self._step_impl(w, st["caches"], cur, pos),
                                 gen, st["temp"], top_k, top_p, do_sample)
                out.index_copy_(1, pos, tok[:, None])
                cur.copy_(tok)
                pos.add_(1)

            # a step first (torch's warm-up before a capture); what it
            # writes at ``pos`` lies past the next prefill's rows and is
            # overwritten before a step reads it
            cuda_graph_mod.warmup(step)
            if "_pool" not in self.__dict__:
                self._pool = torch.cuda.graph_pool_handle()
            graph = cuda_graph_mod.capture(
                step, pool=self._pool,
                generators=() if gen is None else (gen,))
        st["graphs"][key] = graph
        while len(st["graphs"]) > _DECODE_BATCHES_KEPT:
            st["graphs"].popitem(last=False)
        return graph

    def _generate_graphed(self, w, ids, t0, n_steps, key, temp, top_p,
                          seed):
        """``_generate_impl`` with the decode steps replayed from the
        batch's captured graph: the prefill (eager) writes the graph's
        caches, the first token comes from its logits, and each of the
        ``n_steps - 1`` replays decodes one token."""
        st = self._decode_state(w, ids.shape[0])
        graph = self._decode_graph(w, st, key)
        do_sample, top_k, nucleus, gen = key
        if gen is not None and seed is not None:
            gen.manual_seed(int(seed))  # the capture's warm-up drew
        st["temp"].copy_(temp)
        if nucleus:
            st["top_p"].copy_(top_p)
        _, logits = self._prefill_impl(w, ids, t0, st["caches"])
        first = self._pick(logits, gen, st["temp"], top_k,
                           st["top_p"] if nucleus else 1.0, do_sample)
        st["cur"].copy_(first)
        st["pos"].fill_(t0)
        for _ in range(n_steps - 1):
            graph.replay()
        return torch.cat([first[:, None],
                          st["out"][:, t0:t0 + n_steps - 1]], dim=1)

    def decode_graph_bytes(self):
        """Device bytes the decode graphs hold: (their static states —
        caches, tokens, positions — and the pool their captures grew)."""
        states = self.__dict__.get("_decode_states", {})
        static = sum(t.numel() * t.element_size() for st in states.values()
                     for t in _leaves([st["caches"], st["cur"], st["pos"],
                                       st["out"]]))
        pool = sum(g.pool_bytes for st in states.values()
                   for g in st["graphs"].values())
        return static, pool


def _leaves(tree):
    """The tensors of a weight tree (dicts, lists and int8 leaves)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [t for item in tree for t in _leaves(item)]


def llama3_8b(**overrides):
    """Llama-3-8B architecture."""
    return LlamaForCausalLM(LlamaConfig(**{**LLAMA_CONFIGS["llama3_8b"],
                                           **overrides}))


def llama_tiny(**overrides):
    """Tiny config for tests."""
    return LlamaForCausalLM(LlamaConfig(**{**LLAMA_CONFIGS["llama_tiny"],
                                           **overrides}))


def mixtral_8x7b(**overrides):
    """Mixtral-8x7B architecture (sparse MoE decoder, top-2 of 8)."""
    return LlamaForCausalLM(LlamaConfig(**{**LLAMA_CONFIGS["mixtral_8x7b"],
                                           **overrides}))


def mixtral_tiny(**overrides):
    """Tiny MoE config for tests."""
    return LlamaForCausalLM(LlamaConfig(**{**LLAMA_CONFIGS["mixtral_tiny"],
                                           **overrides}))


def llama_param_pspecs(net, mesh, tp_axis="tp", ep_axis="ep"):
    """{structural param name: partition spec} for the Megatron TP/EP
    layout over ``mesh`` (reference ``llama_param_pspecs``): the rules of
    ``parallel.partition.MIXTRAL_RULES`` (the llama table plus the MoE
    bank rows, which match nothing on a dense net) resolved against the
    net's parameter paths, with the canonical ``tp``/``ep`` axes renamed
    when asked.  Parameters not listed replicate."""
    from ..parallel import partition as _pt

    rename = {"tp": tp_axis, "ep": ep_axis}
    rules = _pt.PartitionRules(
        [(pat, tuple(rename.get(a, a) if isinstance(a, str) else a
                     for a in spec))
         for pat, spec in _pt.MIXTRAL_RULES])
    shapes = {name: p.shape
              for name, p in net._collect_params_with_prefix().items()}
    specs = rules.specs(shapes, mesh)
    if net._cfg.tie_embeddings:
        # the tied head reads the embedding matrix; its own weight stays
        # replicated
        specs.pop("lm_head.weight", None)
    return specs


def shard_llama(net, mesh=None, tp_axis="tp", dp_axis="dp", ep_axis="ep"):
    """Place the net's initialized parameters in the Megatron layout over
    ``mesh`` (reference ``shard_llama``): q/k/v/gate/up column-parallel,
    o/down row-parallel, embed/lm_head vocab-parallel (weights are stored
    (out, in)), everything else replicated; each becomes a ``DTensor``
    with rank 0's values."""
    from .. import parallel

    mesh = mesh if mesh is not None else parallel.current_mesh()
    if mesh is None:
        raise MXNetError("no active mesh; call parallel.set_mesh first")
    specs = llama_param_pspecs(net, mesh, tp_axis=tp_axis, ep_axis=ep_axis)
    for name, p in net._collect_params_with_prefix().items():
        if p._data is not None:
            parallel.shard_param(p, specs.get(name, ()), mesh)
    return net


def packed_lm_loss(logits, labels, loss_mask):
    """Mean next-token cross entropy over a packed batch, masked to the
    real targets (reference ``packed_lm_loss``; ``data.PackedBatch``:
    padding and each document's last position carry ``loss_mask`` 0).
    f32 log-softmax.  logits (B, T, V), labels (B, T) int, loss_mask
    (B, T) float."""
    def f(lg, lb, m):
        lp = torch.log_softmax(lg.float(), dim=-1)
        ll = torch.gather(lp, -1, lb.long()[..., None])[..., 0]
        mf = m.float()
        return -(ll * mf).sum() / mf.sum().clamp_min(1.0)

    return apply_op(f, logits, labels, loss_mask, name="packed_lm_loss")


def _lm_head(net, h):
    """Hidden states → vocab logits: tied configs reuse the embedding
    matrix, untied ones (``llama3_8b``) use the ``lm_head`` Dense."""
    if net._cfg.tie_embeddings:
        w = net.model.embed_tokens.weight.data()
        return apply_op(lambda hr, wr: hr @ wr.t(), h, w,
                        name="tied_lm_head")
    return net.lm_head(h)


# -- pipeline parallelism -------------------------------------------------------

def _check_microbatches(batch, n_microbatches):
    if batch % n_microbatches:
        raise MXNetError(f"batch {batch} not divisible by {n_microbatches} "
                         "microbatches")


def _layer_template(layers):
    """(layer-0 Block, its sorted parameter names, their NDArrays): the
    handle-swap machinery's ingredients.  The stage function points each
    NDArray at a layer's tensor and runs layer 0's own code."""
    template = layers[0]
    tparams = template._collect_params_with_prefix()
    names = sorted(tparams)
    shells = [tparams[n].data() for n in names]
    return template, names, shells


def _pipeline_machinery(net, n_stages):
    """Per-(net, n_stages) pipeline plumbing, cached on the net so the
    stage function keeps its identity from step to step: the template
    layer, its parameter shells and the stage function (tensors in and
    out; hybridized layers run inline).  Shared by the GPipe forward and
    the 1F1B step."""
    cache = getattr(net, "_pp_machinery", None)
    if cache is not None and cache["n_stages"] == n_stages:
        return cache
    layers = list(net.model.layers)
    if len(layers) % n_stages:
        raise MXNetError(f"{len(layers)} decoder layers not divisible into "
                         f"{n_stages} pipeline stages")
    lps = len(layers) // n_stages
    template, names, shells = _layer_template(layers)

    def stage_fn(ptree, x_raw):
        out = x_raw
        with cuda_graph_mod.scope():
            for i in range(lps):
                for sh, name in zip(shells, names):
                    sh._data = ptree[name][i]
                out = template(NDArray(out))._data
        return out

    cache = {"n_stages": n_stages, "names": names, "shells": shells,
             "template": template, "lps": lps, "stage_fn": stage_fn,
             "loss_fn": None}
    object.__setattr__(net, "_pp_machinery", cache)
    return cache


def _stacked_layer_params(net, names, n_stages, lps):
    """{name: (S, L/S, *shape)} stacks of the per-layer parameters through
    recorded ops, so gradients through a stack reach each layer's own
    Parameter."""
    from ..ops import tensor as tops

    per_layer = [ly._collect_params_with_prefix() for ly in net.model.layers]
    stacked = {}
    for name in names:
        flat = tops.stack(*[lp[name].data() for lp in per_layer], axis=0)
        stacked[name] = flat.reshape((n_stages, lps) + tuple(flat.shape[1:]))
    return stacked


def llama_pipeline_forward(net, input_ids, n_microbatches, mesh=None,
                           axis_name="pp"):
    """Forward the same ``LlamaForCausalLM`` over a GPipe pipeline
    (``parallel.pipeline_apply``; reference ``llama_pipeline_forward``).

    The decoder stack is cut into ``mesh[axis_name]`` equal stages, each
    applying its layers with layer 0's own code; the embedding, the final
    norm and the LM head run outside the pipeline.  The per-layer stacks
    are recorded ops, so ``backward()`` reaches every layer's own
    ``Parameter.grad()`` and ``gluon.Trainer`` works unchanged.
    ``input_ids`` (B, T) with ``B % n_microbatches == 0`` → logits (B, T,
    vocab)."""
    from .. import parallel

    mesh, n_stages = parallel.pipeline.stage_count(mesh, axis_name)
    batch = input_ids.shape[0]
    _check_microbatches(batch, n_microbatches)
    mach = _pipeline_machinery(net, n_stages)
    h = net.model.embed_tokens(input_ids)
    t_len, hidden = h.shape[1], h.shape[2]
    mbs = h.reshape((n_microbatches, batch // n_microbatches, t_len,
                     hidden))
    stacked = _stacked_layer_params(net, mach["names"], n_stages,
                                    mach["lps"])
    saved = [sh._data for sh in mach["shells"]]
    try:
        out = parallel.pipeline_apply(mach["stage_fn"], stacked, mbs,
                                      mesh=mesh, axis_name=axis_name)
    finally:
        for sh, raw in zip(mach["shells"], saved):
            sh._data = raw
    h_out = net.model.norm(out.reshape((batch, t_len, hidden)))
    return _lm_head(net, h_out)


class _FusedGradStep(autograd.Function):
    """A fused train step (the loss and its precomputed gradients, e.g.
    the 1F1B schedule's) as one node of the tape: the forward runs the
    runner, the backward returns the stashed gradients times the incoming
    cotangent (scaled in place: the runner's gradients are its own)."""

    def __init__(self, runner):
        super().__init__()
        self._runner = runner
        self._grads = None

    def forward(self, *inputs):
        loss, self._grads = self._runner(*inputs)
        return loss

    def backward(self, dloss):
        grads, self._grads = self._grads, None
        scale = dloss._data
        out = []
        for g in grads:
            if g is not None:
                g.mul_(scale.to(g.dtype))
            out.append(None if g is None else NDArray(g))
        return tuple(out)


def _pipeline_loss_fn(eps):
    """The 1F1B step's loss on the last stage (the reference's inline
    ``loss_fn``): RMSNorm in f32 cast back to the activation dtype, the
    head product, log-softmax in f32, the summed NLL."""
    def loss_fn(out, lab, tail):
        nw, hw = tail
        xf = out.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        hn = (xf * torch.rsqrt(var + eps) * nw.float()).to(out.dtype)
        ls = torch.log_softmax((hn @ hw.t()).float(), dim=-1)
        return -ls.gather(-1, lab.long()[..., None]).sum()

    return loss_fn


def llama_pipeline_train_step(net, input_ids, labels, n_microbatches,
                              mesh=None, axis_name="pp"):
    """One 1F1B pipeline train step of a ``LlamaForCausalLM``
    (``parallel.pipeline_train_1f1b``; reference
    ``llama_pipeline_train_step``): each microbatch's backward right
    behind its forward, with the final RMSNorm, the LM head and the token
    cross entropy on the last stage and the embedding outside the
    schedule.  Returns the MEAN token loss as a recorded NDArray:
    ``loss.backward()`` deposits every gradient (the layers from the
    schedule's stage gradients, the embedding through the input
    cotangent, the norm and the head from the tail gradients; a tied
    embedding gets both), so ``gluon.Trainer`` works unchanged.  On
    several ranks the schedule's gradients are summed over ``pp``, so
    every rank holds every layer's gradient."""
    from .. import parallel

    mesh, n_stages = parallel.pipeline.stage_count(mesh, axis_name)
    batch = input_ids.shape[0]
    _check_microbatches(batch, n_microbatches)
    cfg = net.config
    mach = _pipeline_machinery(net, n_stages)
    names, shells, lps = mach["names"], mach["shells"], mach["lps"]
    if mach["loss_fn"] is None:
        mach["loss_fn"] = _pipeline_loss_fn(float(cfg.rms_eps))
    h = net.model.embed_tokens(input_ids)
    t_len, hidden = h.shape[1], h.shape[2]
    mbs = h.reshape((n_microbatches, batch // n_microbatches, t_len,
                     hidden))
    lab_mbs = labels.reshape((n_microbatches, batch // n_microbatches,
                              t_len))
    per_layer = [ly._collect_params_with_prefix() for ly in net.model.layers]
    layer_nds = [lp[name].data() for name in names for lp in per_layer]
    norm_w = net.model.norm.weight.data()
    head_w = net.model.embed_tokens.weight.data() if cfg.tie_embeddings \
        else net.lm_head.weight.data()
    n_layers = len(per_layer)

    def runner(mbs_nd, lab_nd, *leaf_nds):
        # stage s's tree: {name: its layers' own tensors}, no stacked copy
        k = len(names) * n_layers
        stages = [{name: [leaf_nds[a * n_layers + s * lps + i]._data
                          for i in range(lps)]
                   for a, name in enumerate(names)}
                  for s in range(n_stages)]
        saved = [sh._data for sh in shells]
        try:
            loss, grads, tgrads, dxs = parallel.pipeline.train_1f1b_stages(
                mach["stage_fn"], mach["loss_fn"], stages, mbs_nd, lab_nd,
                tail_params=tuple(leaf_nds[k:]), mesh=mesh,
                axis_name=axis_name)
        finally:
            for sh, raw in zip(shells, saved):
                sh._data = raw
        layer_grads = [g for name in names for gs in grads
                       for g in gs[name]]
        return NDArray(loss), [dxs, None, *layer_grads, *tgrads]

    loss_sum = _FusedGradStep(runner)(mbs, lab_mbs, *layer_nds, norm_w,
                                      head_w)
    return loss_sum / float(batch * t_len)
