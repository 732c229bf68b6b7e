"""Continuous-batching decode engine for the llama generative path.

Counterpart of ``mxnet_tpu/serving/generative.py``.  The engine owns the
device half of serving: weights (optionally int8), the KV storage, and
the programs of ``LlamaDecoder`` it runs.  Two storage modes share one
surface (``kv_mode=``):

* **paged** (the default) — K/V lives in a shared block pool per layer,
  ``(num_blocks + 1, Hkv, block_size, head_dim)``; each slot carries a
  block-table row (vacant entries = ``num_blocks``).  The reference's
  sentinel id ``num_blocks`` is out of bounds and XLA drops the writes
  made there; here the pool holds one more block at that index, the
  trash block, which those writes hit and no gather reads
  (``LlamaDecoder``'s docstring).  The usable block count and
  ``kv_pool_bytes`` are the reference's.  Programs: **step**
  (``_step_blocks_impl``), **prefill** (``_prefill_rows_impl``, raw K/V
  rows), **scatter** (the rows chunked into blocks and written at the
  admitted block ids: the prefill→decode KV handoff), **verify**
  (``_verify_blocks_impl``), **gather** (dense prefix copies) and
  **suffix prefill** (``_prefill_suffix_impl``) for the radix cache.
* **slots** — one ``(num_slots, Hkv, max_len, head_dim)`` cache per
  layer, kept for A/B (``ServerConfig(kv_mode="slots")``) and as the
  speculative draft's storage.

The reference's donated pools become in-place ``index_put_`` writes under
``dev_lock``: no copy of the pool a step.  Thread discipline: the prefill
lane and the decode lane share one engine and one CUDA stream.
``dev_lock`` serializes every call that MUTATES the KV storage (decode
step, verify, handoff scatter, prefix gather, slot clears); the prefill
forward runs outside the lock, so a long prompt does not hold up decode
dispatch — only its block scatter briefly takes the lock.  Every public
call runs under ``torch.inference_mode()`` (a lane thread starts with
grad mode on), and every tensor names the weights' device.

``int8=True`` stores the matmul weights as per-output-channel symmetric
int8 (scale = max|row|/127); ``LlamaDecoder``'s matmuls take the int8
leaves and dequantize each to f32 just before its product, so only one
f32 matrix exists at a time (the reference's jit fuses the same
dequantization into each matmul).

On a CUDA card every program is a CUDA graph (``cuda_graph.py``) unless
the NaiveEngine is chosen (``engine.set_engine_type``), which runs them
eagerly.  The decode step is captured when the engine is built (before
any lane thread runs, under ``dev_lock``), also with a speculative
draft: each tick copies the slots' last tokens, positions and block
tables into the graph's static input in one host-to-device copy (from
pinned memory, so the host does not wait) and replays it.  Its key,
``("step", kv_mode, num_slots, table width, dtype)`` (the table width is
``max_blocks`` paged, ``max_len`` in the slots mode; a trailing
``"numerics"`` when the taps are on), is what ``compiled_signatures``
reports for the step.  The other programs are captured at their first
call, one graph a shape as the reference compiles one program a shape
(``_program``): ``prefill`` per (batch, prompt bucket), ``prefill_sfx``
per (batch, prefix, suffix bucket), ``gather`` per (batch, prefix
bucket), ``scatter`` (the handoff) per (batch, prompt bucket) and
``verify`` once, at (num_slots, spec_k + 1); ``capture_buckets(policy)``
(``ServerConfig(capture_buckets=True)``) captures every program of a
bucket table when the server is built, so that no capture waits in
front of a request.

The graphs' memory is bounded by the largest program, not by the number
of shapes: every graph of the engine (the tick's too) allocates from ONE
memory pool, and a program's inputs and outputs are views of two arenas
(device buffers outside the pool, shared by every program, as large as
the largest program's inputs and outputs).  A replay copies its inputs
into the input arena, replays and copies its outputs out of the output
arena under ``_graph_lock``; both lanes enqueue on one stream, so no
replay begins before the previous one's outputs are copied out.  What a
capture adds is in ``graph_pool_bytes``; once the pool and the arenas
hold ``cuda_graph.budget`` bytes, a new shape runs eagerly
(``serving.graph_over_budget``).  A program whose capture fails (one
that reads a value back) runs eagerly from then on.

With the numerics tier on when the engine is built, the decode and
verify programs also return ``stats_of(logits)`` (``serving.logits``):
inside the graphed tick it is an extra graph output, and each replay
queues one copy of it for the stride harvest, never the static tensor
itself.  The mode is fixed at construction (one graph a mode; rebuild
the engine to toggle), and the tokens do not depend on it.  Each
program shape's first call counts ``serving.engine_compile`` and goes
to ``telemetry.retrace.observe``.

``mesh=`` places the engine (``ReplicaMesh``: where one replica runs).
The reference is one controller over the whole mesh; torch runs one
process a tensor-parallel rank, so a replica with tp > 1 is SPMD:

* every rank of the replica holds its shards of the weights and the KV
  pool, placed by ``partition_rules`` (default ``SERVING_RULES``: q/k/v/
  gate/up split by output rows, o/down by input columns, the embedding
  and head by vocabulary rows, the pool's KV heads over ``tp``; int8
  leaves keep the reference's layout, the q8 rows sharded like the
  weight and the scales following the output dim), and runs the
  decoder on them (``_TPDecoder``: o and down summed over the group, a
  vocab-sharded embedding gathered by mask and sum, a vocab-sharded
  head's logits gathered whole);
* the replica's leader rank (its lowest) runs the lanes; each device
  program call first sends its host inputs (token ids, lengths, block
  ids, slot state) to the peers over a gloo channel, and each peer runs
  the same call on its shards (``follow``), so every rank issues the
  collectives in one order (all such calls take the channel's lock);
* the graphed decode tick holds the group's collectives (the group is
  warmed by an eager collective before the capture).

A replica with tp = 1 runs in one process on its own device.  With tp >
1 the speculative draft is a second engine on the same ranks and the
same channel (its slot-cache programs mirrored as the target's are), and
the radix cache's trie and block ids stay with the leader, which sends
the ids of each gather, suffix prefill and commit.  Traces, records and
statistics come from the leader alone.  ``compiled_signatures`` keeps
the reference's signature keys: here the set of program shapes that ran.
"""
from __future__ import annotations

import copy
import datetime
import functools
import threading
import time
from collections import deque

import numpy as np
import torch

from .. import cuda_graph, engine
from .. import telemetry
from ..base import MXNetError
from ..telemetry import numerics as _numerics
from ..telemetry import retrace as _retrace
from ..telemetry import tracing
from ..models.llama import LlamaDecoder, _dequantize
from .bucketing import BucketPolicy, pad_batch
from .kv_cache import KVCacheManager
from .protocol import ServerClosedError
from .scheduler import _materialize

__all__ = ["LlamaServingEngine", "GenerativeScheduler"]


#: matmul weights that the int8 option quantizes (per-output-channel);
#: embeddings and the RMSNorm scales stay in the load dtype
_QUANT_KEYS = ("q", "k", "v", "o", "gate", "up", "down")
_LAYER_KEYS = ("ln_in", "q", "k", "v", "o", "ln_post", "gate", "up",
               "down")


def _quantize_mat(m):
    """Per-output-channel symmetric int8: rows of the (out, in) weight
    each get scale = max|row| / 127."""
    m32 = m.float()
    scale = (m32.abs().amax(dim=1, keepdim=True) / 127.0).clamp_min(1e-8)
    q8 = torch.round(m32 / scale).clamp(-127, 127).to(torch.int8)
    return {"q8": q8, "scale": scale}


def _quantize_tree(w):
    layers = []
    for L in w["layers"]:
        layers.append({k: _quantize_mat(L[k]) if k in _QUANT_KEYS
                       else L[k] for k in _LAYER_KEYS})
    return dict(layers=layers, emb=w["emb"], norm=w["norm"],
                head=_quantize_mat(w["head"]))


def _dequantize_tree(w):
    """Inverse of ``_quantize_tree``: int8 rows × their f32 scales.  The
    engine never builds this tree: ``_mm`` dequantizes each int8 leaf
    just before its product."""
    def dq(leaf):
        return _dequantize(leaf) if isinstance(leaf, dict) else leaf

    layers = [{k: dq(L[k]) for k in _LAYER_KEYS} for L in w["layers"]]
    return dict(layers=layers, emb=w["emb"], norm=w["norm"],
                head=dq(w["head"]))


def _named_weight_items(w):
    """(rule-matchable name, path) of every leaf of the decoder's weight
    tree: ``layers.0.q_weight`` meets the column-parallel rule as
    ``...q_proj.weight`` does in training (reference
    ``_named_weight_items``)."""
    items = []
    for i, L in enumerate(w["layers"]):
        for key in L:
            items.append((f"layers.{i}.{key}_weight", ("layers", i, key)))
    items.append(("embed_weight", ("emb",)))
    items.append(("norm_weight", ("norm",)))
    items.append(("lm_head_weight", ("head",)))
    return items


def _leaf(tree, path):
    return tree["layers"][path[1]][path[2]] if len(path) == 3 \
        else tree[path[0]]


def _set_leaf(tree, path, value):
    if len(path) == 3:
        tree["layers"][path[1]][path[2]] = value
    else:
        tree[path[0]] = value


#: the Megatron layout a tensor-parallel replica's decoder runs
_TP_LAYOUT = {"q": ("tp", None), "k": ("tp", None), "v": ("tp", None),
              "gate": ("tp", None), "up": ("tp", None),
              "o": (None, "tp"), "down": (None, "tp"),
              "ln_in": (), "ln_post": ()}


class ReplicaMesh:
    """Where one serving replica runs: ``device`` (a card of this process,
    or the CPU) and, for tp > 1, its tensor-parallel ranks (``ranks``,
    global; the leader is the first), this rank's place ``tp_rank``, the
    group of its collectives (``group``) and the gloo group of its
    command channel (``channel_group``).  ``local``: this process holds a
    rank of it."""

    def __init__(self, device=None, tp=1, ranks=None, tp_rank=0, group=None,
                 channel_group=None, local=True):
        self.device = device
        self.tp = int(tp)
        self.ranks = tuple(ranks) if ranks is not None else None
        self.tp_rank = int(tp_rank)
        self.group = group
        self.channel_group = channel_group
        self.local = bool(local)

    @property
    def leader(self):
        return self.ranks[0] if self.ranks else 0

    @property
    def is_leader(self):
        from .. import parallel

        return self.ranks is None or parallel.rank() == self.leader

    def __repr__(self):
        return (f"ReplicaMesh(device={self.device}, tp={self.tp}, "
                f"ranks={self.ranks}, local={self.local})")


#: how long a peer's channel waits for its leader's next call (a server
#: may idle that long between requests)
CHANNEL_TIMEOUT = datetime.timedelta(days=1)


def _split_mesh(mesh, dp_axis="dp", device=None):
    """One ``ReplicaMesh`` a dp replica (reference ``server._split_mesh``):
    no mesh → ``[None]`` (one replica on the net's device); no dp axis →
    the whole mesh is one replica; a dict mesh (or a mesh of one process)
    → in-process replicas with tp = 1, dp slice i on card i of this
    process (or the CPU, with ``device`` a CPU device); a ``DeviceMesh``
    over ranks → each dp slice's tp ranks, with the groups made
    collectively (every rank calls this, in one order)."""
    from .. import parallel

    if mesh is None:
        return [None]
    if not isinstance(mesh, dict) and not hasattr(mesh, "mesh_dim_names"):
        raise MXNetError("a serving mesh is a dict of axis sizes or a "
                         f"parallel.make_mesh, got {type(mesh).__name__}")
    axes = parallel.mesh_axes(mesh)
    other = {k: v for k, v in axes.items() if k not in (dp_axis, "tp")}
    if any(v > 1 for v in other.values()):
        raise MXNetError(f"a serving mesh has dp and tp axes only: {axes}")
    dp, tp = int(axes.get(dp_axis, 1)), int(axes.get("tp", 1))
    if not hasattr(mesh, "get_group") or parallel.world_size() == 1:
        if tp > 1:
            raise MXNetError(
                f"tensor parallelism inside a replica (tp={tp}) runs one "
                "process a tp rank: start dp·tp ranks (python -m "
                "mxnet_tpu_torch.launch) and pass a parallel.make_mesh")
        device = torch.device(device) if device is not None else None
        if device is not None and device.type == "cuda":
            if dp > torch.cuda.device_count():
                raise MXNetError(f"{dp} dp replicas need {dp} cards; this "
                                 f"process sees {torch.cuda.device_count()}")
            return [ReplicaMesh(torch.device("cuda", i)) for i in range(dp)]
        return [ReplicaMesh(device) for _ in range(dp)]
    names = list(mesh.mesh_dim_names)
    ranks = mesh.mesh
    if dp_axis in names:
        ranks = ranks.movedim(names.index(dp_axis), 0)
    else:
        ranks = ranks.unsqueeze(0)
    ranks = ranks.reshape(dp, -1)
    me = parallel.rank()
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")
    out = []
    for i in range(dp):
        members = [int(r) for r in ranks[i]]
        channel = None
        if tp > 1:
            # every rank makes every slice's channel group, in one order
            channel = torch.distributed.new_group(
                members, backend="gloo", timeout=CHANNEL_TIMEOUT)
        local = me in members
        out.append(ReplicaMesh(
            dev, tp, members, members.index(me) if local else 0,
            mesh.get_group("tp") if local and "tp" in names and tp > 1
            else None, channel, local))
    return out


def _as_replica_mesh(mesh, device):
    """The engine's ``mesh=``: None, a ``ReplicaMesh``, a dict or a
    ``DeviceMesh`` (this rank's dp slice of it)."""
    if mesh is None or isinstance(mesh, ReplicaMesh):
        return mesh
    reps = [r for r in _split_mesh(mesh, device=device) if r.local]
    if len(reps) != 1:
        raise MXNetError(f"one engine serves one replica; mesh {mesh} "
                         f"holds {len(reps)} here (split it with dp)")
    return reps[0]


class _Channel:
    """A tensor-parallel replica's command channel: the leader broadcasts
    each device program call (its engine's tag, the program's name, the
    host arguments) to its peers.  A replica's engines share it (the
    target and the speculative draft), each under the tag ``register``
    gives it; they are built in one order on every rank."""

    def __init__(self, rm):
        self.group = rm.channel_group
        self.leader = rm.leader
        self.lock = threading.RLock()
        self.engines = []

    def register(self, engine):
        self.engines.append(engine)
        return len(self.engines) - 1

    def send(self, msg):
        torch.distributed.broadcast_object_list([msg], src=self.leader,
                                                group=self.group)

    def recv(self):
        box = [None]
        torch.distributed.broadcast_object_list(box, src=self.leader,
                                                group=self.group)
        return box[0]


def _mirrored(fn):
    """A device program of the engine.  Over a tensor-parallel replica
    the leader sends the call (name and host arguments) to its peers
    before running it, and each peer runs the same program on its shards
    (``follow``); the channel's lock makes every rank issue the
    collectives in one order."""
    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        ch = self._channel
        if ch is None:
            return fn(self, *args, **kwargs)
        with ch.lock:
            ch.send((self._tag, fn.__name__, args, kwargs))
            return fn(self, *args, **kwargs)

    return call


def _tree(fn, x):
    """``fn`` over every tensor of ``x`` (a tensor, or lists and tuples
    of them), keeping the structure."""
    if isinstance(x, (list, tuple)):
        return type(x)(_tree(fn, v) for v in x)
    return fn(x)


def _tree_copy(dst, src):
    """Copy every tensor of ``src`` into the tensor of ``dst`` at its
    place (a graph's static inputs)."""
    if isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _tree_copy(d, s)
    else:
        dst.copy_(src)


class _Held:
    """A handle to device state a program left on every rank of a
    tensor-parallel replica (the prefilled rows), passed to the program
    that consumes it in their place."""

    __slots__ = ("key",)

    def __init__(self, key):
        self.key = key


class _TPDecoder(LlamaDecoder):
    """The decoder on one tensor-parallel rank's shards (the Megatron
    layout): its heads and MLP columns are this rank's, the row-parallel
    products (o, down) are summed over the group, a vocab-sharded
    embedding gathers its rows by mask and sum, and a vocab-sharded
    head's logits are gathered whole."""

    def __init__(self, net, max_len, rm):
        super().__init__(net, max_len)
        cfg = copy.copy(net.config)
        for what, n in (("num_heads", cfg.num_heads),
                        ("num_kv_heads", cfg.num_kv_heads),
                        ("intermediate_size", cfg.intermediate_size)):
            if n % rm.tp:
                raise MXNetError(f"tensor-parallel serving: {what}={n} is "
                                 f"not divisible by tp={rm.tp}")
        cfg.num_heads //= rm.tp
        cfg.num_kv_heads //= rm.tp
        self.cfg = cfg
        self._rm = rm
        self.emb_rows = None      # (first row, rows) of a sharded embedding
        self.head_sharded = False

    def _reduce(self, t):
        torch.distributed.all_reduce(t, group=self._rm.group)
        return t

    def _embed(self, w, ids):
        if self.emb_rows is None:
            return super()._embed(w, ids)
        lo, n = self.emb_rows
        ids = ids.long() - lo
        hit = (ids >= 0) & (ids < n)
        x = w["emb"][ids.clamp(0, n - 1)] * hit[..., None].to(
            w["emb"].dtype)
        return self._reduce(x)

    def _logits(self, w, x):
        part = super()._logits(w, x)
        if not self.head_sharded:
            return part
        rm = self._rm
        flat = part.reshape(-1, part.shape[-1]).contiguous()
        if torch.distributed.get_backend(rm.group) == "nccl":
            out = torch.empty((rm.tp,) + tuple(flat.shape), dtype=flat.dtype,
                              device=flat.device)
            torch.distributed.all_gather_into_tensor(out, flat,
                                                     group=rm.group)
        else:
            parts = [torch.empty_like(flat) for _ in range(rm.tp)]
            torch.distributed.all_gather(parts, flat, group=rm.group)
            out = torch.stack(parts)
        return out.permute(1, 0, 2).reshape(*part.shape[:-1],
                                            rm.tp * part.shape[-1])


class LlamaServingEngine:
    """Device-side half of continuous batching for a LlamaForCausalLM."""

    @torch.inference_mode()
    def __init__(self, net, max_len=None, num_slots=4, int8=False,
                 kv_mode="slots", block_size=16, num_blocks=None,
                 mesh=None, partition_rules=None, replica_id=0,
                 spec_k=0, channel=None):
        if kv_mode not in ("paged", "slots"):
            raise MXNetError(f"unknown kv_mode {kv_mode!r}; "
                             "expected 'paged' or 'slots'")
        self.spec_k = int(spec_k)
        if self.spec_k and kv_mode != "paged":
            raise MXNetError("speculative verify (spec_k > 0) requires "
                             "kv_mode='paged'")
        self.max_len = int(max_len or net.config.max_seq_len)
        self.num_slots = int(num_slots)
        self.int8 = bool(int8)
        self.kv_mode = kv_mode
        self.replica_id = int(replica_id)
        self.dev_lock = threading.RLock()
        self.partition_rules = partition_rules
        rm = self.mesh = _as_replica_mesh(
            mesh, net.model.embed_tokens.weight.data()._data.device)
        tp = rm is not None and rm.tp > 1
        self._dec = _TPDecoder(net, self.max_len, rm) if tp \
            else LlamaDecoder(net, self.max_len)
        w = self._dec._weights()
        w = _quantize_tree(w) if self.int8 else w
        self._w = w if rm is None else self._place(w, rm)
        self.device = self._w["emb"].device
        self._channel = None
        if tp:
            # a draft engine shares its target's channel (``channel``)
            self._channel = channel if channel is not None else _Channel(rm)
            self._tag = self._channel.register(self)
        self._held = {}
        self._held_seq = 0
        self._follower = None
        cfg = self._dec.cfg
        dt = w["emb"].dtype
        if kv_mode == "paged":
            self.block_size = int(block_size)
            if self.block_size < 1:
                raise MXNetError("block_size must be >= 1")
            #: static block-table width — the step gathers this many
            #: blocks per slot regardless of actual ownership
            self.max_blocks = -(-self.max_len // self.block_size)
            self.num_blocks = int(num_blocks or
                                  self.num_slots * self.max_blocks)
            # one block more than the usable ones: the trash block at
            # index num_blocks, where writes to vacant entries land
            pshape = (self.num_blocks + 1, cfg.num_kv_heads,
                      self.block_size, cfg.head_dim)
            self._pool = [(torch.zeros(pshape, dtype=dt, device=self.device),
                           torch.zeros(pshape, dtype=dt, device=self.device))
                          for _ in range(cfg.num_layers)]
            self._tables = np.full((self.num_slots, self.max_blocks),
                                   self.num_blocks, np.int32)
            self._caches = None
        else:
            self.block_size = self.num_blocks = self.max_blocks = None
            shape = (self.num_slots, cfg.num_kv_heads, self.max_len,
                     cfg.head_dim)
            self._caches = [(torch.zeros(shape, dtype=dt, device=self.device),
                             torch.zeros(shape, dtype=dt, device=self.device))
                            for _ in range(cfg.num_layers)]
            self._pool = self._tables = None
        # host mirrors: last emitted token + next write position per slot
        self._last = np.zeros(self.num_slots, np.int32)
        self._pos = np.zeros(self.num_slots, np.int32)
        self.steps = 0
        self._signatures = set()
        width = self.max_blocks if kv_mode == "paged" else self.max_len
        # the logits' statistics ride the decode and verify programs in
        # one mode, fixed here: one graph a mode (rebuild to toggle)
        self._numerics = _numerics.trace_enabled()
        self._step_key = ("step", kv_mode, self.num_slots, width,
                          str(dt).removeprefix("torch.")) \
            + (("numerics",) if self._numerics else ())
        self._step_graph = None
        #: program key -> (input views, graph, output views) or "eager";
        #: None: every program eager
        self._graphs = None
        self._graph_pool = None
        self._graph_lock = threading.Lock()
        self._arenas = {"in": None, "out": None}
        self._arena_bytes = 0  # every arena made, kept by its graphs
        self._graph_budget = cuda_graph.budget(self.device)
        if self.device.type == "cuda" and not engine.is_naive():
            self._graphs = {}
            self._graph_pool = torch.cuda.graph_pool_handle()
            with self.dev_lock, torch.cuda.device(self.device):
                self._capture_step()

    # -- placement ------------------------------------------------------------
    def _place(self, w, rm):
        """The weight tree on ``rm``: each leaf on the replica's device,
        and over tp > 1 cut to this rank's shard by ``partition_rules``
        (default ``SERVING_RULES``; an int8 leaf's q8 rows like the weight,
        its scales along the output dim), in the layout ``_TPDecoder``
        runs (reference ``_place_on_mesh_locked``)."""
        from ..parallel.partition import as_rules

        rules = as_rules(self.partition_rules
                         if self.partition_rules is not None
                         else "llama_serving")
        cfg = self._dec.cfg
        items = _named_weight_items(w)
        shapes = {}
        for name, path in items:
            leaf = _leaf(w, path)
            shapes[name] = tuple((leaf["q8"] if isinstance(leaf, dict)
                                  else leaf).shape)
        for i in range(len(w["layers"])):
            shapes[f"layers.{i}.kv_pool"] = (
                1, cfg.num_kv_heads * rm.tp, 1, cfg.head_dim)
        specs = rules.specs(shapes, {"tp": rm.tp})
        if rm.tp > 1:
            self._check_layout(specs, len(w["layers"]), rm.tp)

        def cut(t, spec):
            for d, ax in enumerate(spec or ()):
                if ax == "tp":
                    t = t.chunk(rm.tp, d)[rm.tp_rank]
            return t.to(rm.device).contiguous()

        out = {"layers": [dict(L) for L in w["layers"]], "emb": w["emb"],
               "norm": w["norm"], "head": w["head"]}
        done = {}
        for name, path in items:
            leaf, spec = _leaf(w, path), specs.get(name, ())
            if id(leaf) not in done:  # a tied head is the embedding
                if isinstance(leaf, dict):
                    done[id(leaf)] = {
                        "q8": cut(leaf["q8"], spec),
                        "scale": cut(leaf["scale"],
                                     ((spec[0] if spec else None), None))}
                else:
                    done[id(leaf)] = cut(leaf, spec)
            _set_leaf(out, path, done[id(leaf)])
        if rm.tp > 1:
            emb = specs.get("embed_weight", ())
            if emb and emb[0] == "tp":
                n = out["emb"].shape[0]
                self._dec.emb_rows = (rm.tp_rank * n, n)
            head = specs.get("lm_head_weight", ())
            self._dec.head_sharded = bool(head and head[0] == "tp")
        return out

    @staticmethod
    def _check_layout(specs, n_layers, tp):
        """A tensor-parallel replica runs the Megatron layout: refuse rules
        that resolve to another."""
        want = {f"layers.{i}.{k}_weight": v for i in range(n_layers)
                for k, v in _TP_LAYOUT.items()}
        want.update({f"layers.{i}.kv_pool": (None, "tp", None, None)
                     for i in range(n_layers)})
        want["norm_weight"] = ()
        bad = [(n, specs.get(n, ())) for n, v in want.items()
               if tuple(specs.get(n, ())) != v]
        for n in ("embed_weight", "lm_head_weight"):
            if tuple(specs.get(n, ())) not in ((), ("tp", None)):
                bad.append((n, specs.get(n)))
        if bad:
            raise MXNetError(
                f"tensor-parallel serving runs the Megatron layout of "
                f"SERVING_RULES (heads, KV heads and the MLP width divisible "
                f"by tp={tp}); these resolved otherwise: {bad[:4]}")

    # -- tensor-parallel peers ------------------------------------------------
    def follow_in_background(self):
        """A peer's ``follow`` on a thread of its own (between a server's
        start and stop); ``join_follower`` waits for its release."""
        self._follower = threading.Thread(
            target=self.follow, name=f"mxt-follow-{self.replica_id}",
            daemon=True)
        self._follower.start()

    def join_follower(self):
        if self._follower is not None:
            self._follower.join()
            self._follower = None

    def follow(self):
        """A tensor-parallel peer's loop: run each program its leader
        sends, on this rank's shards, until the leader releases it."""
        ch = self._channel
        while True:
            tag, name, args, kwargs = ch.recv()
            if name is None:
                return
            eng = ch.engines[tag]
            getattr(type(eng), name).__wrapped__(eng, *args, **kwargs)

    def release(self):
        """The leader's last word to its peers: their ``follow`` ends."""
        if self._channel is not None and self.mesh.is_leader:
            with self._channel.lock:
                self._channel.send((None, None, (), {}))

    def _hold(self, value):
        """Keep device state for a later program (on every rank alike) and
        return its handle; without peers, the state itself."""
        if self._channel is None:
            return value
        self._held_seq += 1
        self._held[self._held_seq] = value
        return _Held(self._held_seq)

    def _serial(self):
        """The channel's lock over a tensor-parallel replica (no lock
        otherwise)."""
        import contextlib

        return self._channel.lock if self._channel is not None \
            else contextlib.nullcontext()

    def _take(self, value):
        return self._held.pop(value.key) if isinstance(value, _Held) \
            else value

    def _step_program(self, state):
        """The decode step over all slots from one int64 (S, 2 [+ width])
        array: column 0 the last tokens, 1 the positions, then (paged) the
        block tables → the next tokens (S,)."""
        last, pos = state[:, 0], state[:, 1]
        if self.kv_mode == "paged":
            logits = self._dec._step_blocks_impl(
                self._w, self._pool, state[:, 2:], last, pos)
        else:
            logits = self._dec._step_slots_impl(self._w, self._caches,
                                                last, pos)
        if self._numerics:
            return logits.argmax(dim=-1), _numerics.stats_of(logits)
        return logits.argmax(dim=-1)

    def _host_state(self):
        cols = [self._last[:, None], self._pos[:, None]]
        if self.kv_mode == "paged":
            cols.append(self._tables)
        return np.concatenate(cols, axis=1).astype(np.int64)

    def _capture_step(self):
        """Capture the decode step on a static copy of the (vacant) slot
        state: every slot at position 0 with token 0 (their writes land
        in their own slot rows or the trash block, as vacant slots'
        do)."""
        host = self._host_state()
        self._state = torch.from_numpy(host).to(self.device)
        # each tick's state goes through pinned memory without a host wait
        self._pinned = torch.from_numpy(host).pin_memory()
        if self.mesh is not None and self.mesh.group is not None:
            cuda_graph.warm_groups(groups=[self.mesh.group])
        cuda_graph.warmup(lambda: self._step_program(self._state))
        with self._graph_lock:
            self._step_graph = cuda_graph.capture(
                lambda: self._step_program(self._state),
                pool=self._graph_pool, mode="thread_local")

    def _dev(self, a):
        """Host integer array → int64 tensor on the engine's device."""
        return torch.from_numpy(np.asarray(a, np.int64)).to(self.device)

    def _program(self, key, fn, *inputs):
        """``fn(*inputs)`` (tensors, or lists and tuples of them).  On a
        card the replay of the graph captured for ``key`` at its first
        call (``_capture_program``): the inputs are copied into the
        input arena, and the outputs copied out of the output arena."""
        if self._graphs is None:
            return fn(*inputs)
        with self._graph_lock:
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._graphs[key] = self._capture_program(
                    fn, inputs)
            if entry != "eager":
                statics, graph, outs = entry
                _tree_copy(statics, inputs)
                graph.replay()
                return _tree(torch.clone, outs)
        return fn(*inputs)

    def _capture_program(self, fn, inputs):
        """A program's graph (under ``_graph_lock``): an eager warm-up on
        the input arena's views (over a tensor-parallel replica after a
        warm collective on its group; every rank captures at the same
        call), then the capture into the engine's pool of ``fn`` and a
        copy of its outputs into the output arena.  ``"eager"`` past the
        budget or when the capture fails."""
        if self._graph_bytes() >= self._graph_budget:
            telemetry.count("serving.graph_over_budget")
            return "eager"
        try:
            with torch.cuda.device(self.device):
                statics = self._arena_views("in", inputs)
                _tree_copy(statics, inputs)
                if self.mesh is not None and self.mesh.group is not None:
                    cuda_graph.warm_groups(groups=[self.mesh.group])
                outs = self._arena_views(
                    "out", cuda_graph.warmup(lambda: fn(*statics)))

                def run():
                    _tree_copy(outs, fn(*statics))
                    return ()

                graph = cuda_graph.capture(run, pool=self._graph_pool,
                                           mode="thread_local")
        except Exception:
            telemetry.count("serving.graph_capture_failed")
            return "eager"
        return statics, graph, outs

    def _arena_views(self, side, like):
        """Views of the ``side`` arena shaped as the tensors of ``like``
        (each at a 256-byte boundary).  An arena too small for them is
        replaced by one twice as large (or as large as they need); the
        graphs captured on the old one keep it."""
        leaves = []
        _tree(leaves.append, like)
        if not leaves:
            return like
        sizes = [-(-t.numel() * t.element_size() // 256) * 256
                 for t in leaves]
        arena = self._arenas[side]
        if arena is None or arena.numel() < sum(sizes):
            n = max(sum(sizes), 2 * (0 if arena is None else arena.numel()))
            arena = self._arenas[side] = torch.empty(
                n, dtype=torch.uint8, device=self.device)
            self._arena_bytes += n
        views, off = {}, 0
        for t, size in zip(leaves, sizes):
            n = t.numel() * t.element_size()
            views[id(t)] = arena[off:off + n].view(t.dtype).view(t.shape)
            off += size
        return _tree(lambda t: views[id(t)], like)

    def _graph_bytes(self):
        """What the engine's graphs hold: the pool's growth at each
        capture and the arenas."""
        return sum(self.graph_pool_bytes().values())

    @torch.inference_mode()
    def capture_buckets(self, policy, prefix=False):
        """Capture now, under the device lock, the prefill program of
        every (batch bucket, length bucket) of ``policy`` (a
        ``BucketPolicy``) up to ``max_len``, the scatter program of each
        (paged), with ``prefix`` (a radix cache) the gather program of
        every (batch, prefix bucket) and the suffix prefill of every
        (batch, prefix bucket, suffix bucket), and verify (with a
        speculative window), on vacant rows whose writes land in the
        trash block.  The largest programs go first, so that the smaller
        ones reuse their memory: ``graph_pool_bytes`` then holds about
        the largest program's.  On the CPU, under the NaiveEngine and
        over a tensor-parallel replica (whose ranks capture at the calls
        they share) it does nothing."""
        if self._graphs is None or self._channel is not None:
            return
        lens = [lb for lb in policy.length_buckets() if lb <= self.max_len]
        work = [(kb * lb, kb, lb, None) for kb in policy.batch_buckets()
                for lb in lens]
        if prefix and self.kv_mode == "paged":
            work += [(kb * (lp + lb), kb, lb, lp)
                     for kb in policy.batch_buckets() for lp in lens
                     for lb in lens]
        vacant = np.full(max(policy.batch_buckets()), self.num_slots,
                         np.int32)
        with self.dev_lock:
            for _, kb, lb, lp in sorted(work, key=lambda w: w[0],
                                        reverse=True):
                ids = np.zeros((kb, lb), np.int32)
                t0s = np.full(kb, lb, np.int32)
                if self.kv_mode == "slots":
                    self.admit(ids, t0s, vacant[:kb])
                    continue
                skip = None
                if lp is None:
                    _, rows = self.prefill_rows(ids, t0s)
                else:
                    pre = self.gather_prefix(np.full(
                        (kb, -(-lp // self.block_size)), self.num_blocks,
                        np.int32))
                    # from position 0: the positions stay in range
                    _, rows = self.prefill_suffix(pre, ids, t0s,
                                                  np.zeros(kb, np.int32))
                    skip = np.zeros(kb, np.int32)
                self.commit_rows(rows, vacant[:kb], [None] * kb, t0s,
                                 np.zeros(kb, np.int32), skip_blocks=skip)
            if self.spec_k:
                self._note(("verify",))
                self._verify_state(
                    np.zeros((self.num_slots, self.spec_k + 1), np.int32),
                    self._tables, self._pos)

    def graph_pool_bytes(self):
        """Device memory the engine's graphs hold: by program key, what
        the shared pool grew by at its capture (the decode step under its
        own key), and under ``("arena",)`` the input and output arenas;
        empty on the CPU and under the NaiveEngine."""
        out = {}
        if self._step_graph is not None:
            out[self._step_key] = self._step_graph.pool_bytes
        for key, entry in (self._graphs or {}).items():
            if entry != "eager":
                out[key] = entry[1].pool_bytes
        if self._graphs is not None and self._arena_bytes:
            out[("arena",)] = self._arena_bytes
        return out

    def _note(self, key):
        """A program shape ran: its first call counts a compile and goes
        to the retrace sanitizer (a prefill bucket first seen after the
        warmup is a retrace)."""
        if key in self._signatures:
            return
        self._signatures.add(key)
        telemetry.count("serving.engine_compile")
        if _retrace._enabled:
            if len(key) == 4 and key[0] == "prefill_sfx":
                comps = {"batch": key[1], "prefix_len": key[2],
                         "suffix_len": key[3]}
            elif len(key) == 3:
                comps = {"batch": key[1], "prompt_len": key[2]}
            else:
                comps = {"program": key[0]}
            _retrace.observe(
                "serving_" + str(key[0]), id(self), comps,
                site="mxnet_tpu_torch.serving.generative:"
                     "LlamaServingEngine (%s)" % (key[0],))

    def compiled_signatures(self):
        """Every (program, *bucket) shape this engine has run — the
        reference's compile keys; the decode step's is its CUDA graph's
        key."""
        return sorted(self._signatures)

    def kv_pool_bytes(self):
        """Bytes of the KV storage (pool or slot caches) on this device,
        summed over layers and both of K/V — the paged pool's usable
        blocks only, as in the reference (the trash block is not
        counted): the figure ``memory.planner.plan_kv_pool`` predicts
        before the engine is built."""
        with self.dev_lock:
            if self.kv_mode == "paged":
                return int(sum(2 * k[:self.num_blocks].nbytes
                               for k, _ in self._pool))
            return int(sum(k.nbytes + v.nbytes for k, v in self._caches))

    # -- transitions (slots mode) ---------------------------------------------
    @_mirrored
    @torch.inference_mode()
    def admit(self, prompts_pad, t0s, slots):
        """Prefill ``prompts_pad`` (kb, lp) with true lengths ``t0s``
        (kb,) and write the resulting cache rows into ``slots`` (kb,) —
        vacant padding rows carry slot index ``num_slots`` and are not
        written.  Returns each row's first generated token (kb,) on
        host."""
        if self.kv_mode != "slots":
            raise MXNetError("admit() is the slot-ledger path; the paged "
                             "engine admits via prefill_rows/commit_rows")
        kb, lp = prompts_pad.shape
        self._note(("prefill", kb, lp))
        toks, rows = self._program(("prefill", kb, lp), self._prefill_fn,
                                   self._dev(prompts_pad), self._dev(t0s))
        keep = [i for i, s in enumerate(slots) if s < self.num_slots]
        dst = self._dev([slots[i] for i in keep])
        src = self._dev(keep)
        with self.dev_lock:
            # rows past lp keep a previous tenant's values: the decode
            # steps overwrite them before the mask t <= pos exposes them
            for (kc, vc), (k, v) in zip(self._caches, rows):
                kc[dst, :, :lp] = k[src].to(kc.dtype)
                vc[dst, :, :lp] = v[src].to(vc.dtype)
        first = _materialize([toks])[0]
        with self.dev_lock:
            for i, s in enumerate(slots):
                if s < self.num_slots:
                    self._last[s] = first[i]
                    self._pos[s] = t0s[i]
        return first

    # -- transitions (paged mode: disaggregated lanes) ------------------------
    @_mirrored
    @torch.inference_mode()
    def prefill_rows(self, prompts_pad, t0s):
        """Prefill lane, phase 1: the prompt forward, WITHOUT the device
        lock.  Returns (first-token device tensor, per-layer raw K/V
        rows) for :meth:`commit_rows` (over a tensor-parallel replica a
        handle to the rows each rank keeps)."""
        if self.kv_mode != "paged":
            raise MXNetError("prefill_rows() requires kv_mode='paged'")
        kb, lp = prompts_pad.shape
        self._note(("prefill", kb, lp))
        toks, rows = self._program(("prefill", kb, lp), self._prefill_fn,
                                   self._dev(prompts_pad), self._dev(t0s))
        return toks, self._hold(rows)

    def _prefill_fn(self, ids, t0):
        rows, logits = self._dec._prefill_rows_impl(self._w, ids, t0)
        return logits.argmax(dim=-1), rows

    @_mirrored
    @torch.inference_mode()
    def commit_rows(self, rows, slots, block_lists, t0s, first,
                    skip_blocks=None):
        """Prefill lane, phase 2: the KV handoff.  Under the device lock,
        write the prefilled rows into each admitted request's blocks and
        install the block tables and decode mirrors, after which the
        decode lane's next step adopts the slots.  ``first`` is the
        materialized first-token vector (kb,); vacant rows carry slot id
        ``num_slots`` and write the trash block.

        ``skip_blocks`` (radix path): per-row count of leading SHARED
        prefix blocks already holding K/V — ``rows`` then carry only the
        novel suffix, the scatter targets the block list past the shared
        prefix, and ``t0s`` stays the FULL prompt length (the decode
        cursor).  Shared blocks are never written."""
        rows = self._take(rows)
        kb = len(slots)
        bs = self.block_size
        lp = rows[0][0].shape[2]
        nbp = -(-lp // bs)
        flat = np.full(kb * nbp, self.num_blocks, np.int32)
        for r, blocks in enumerate(block_lists):
            if blocks is None:
                continue
            skip = 0 if skip_blocks is None else int(skip_blocks[r])
            tail = blocks[skip:]
            take = min(nbp, len(tail))
            flat[r * nbp: r * nbp + take] = tail[:take]
        idx = self._dev(flat)

        def chunk(a):
            # (kb, Hkv, lp, D) → (kb·nbp, Hkv, bs, D) block-sized pieces
            kb_, hkv, _, hd = a.shape
            a = torch.nn.functional.pad(a, (0, 0, 0, nbp * bs - lp))
            return a.reshape(kb_, hkv, nbp, bs, hd).transpose(1, 2) \
                .reshape(kb_ * nbp, hkv, bs, hd)

        def scatter(idx, rows):
            for (kp, vp), (k, v) in zip(self._pool, rows):
                kp[idx] = chunk(k).to(kp.dtype)
                vp[idx] = chunk(v).to(vp.dtype)
            return ()

        with self.dev_lock:
            self._program(("scatter", kb, lp), scatter, idx, rows)
            for i, s in enumerate(slots):
                if s < self.num_slots:
                    row = np.full(self.max_blocks, self.num_blocks,
                                  np.int32)
                    blocks = block_lists[i]
                    row[:len(blocks)] = blocks
                    self._tables[s] = row
                    self._last[s] = first[i]
                    self._pos[s] = t0s[i]

    @_mirrored
    @torch.inference_mode()
    def gather_prefix(self, rows_idx):
        """Radix-hit prefill, phase 0: dense per-request copies of the
        shared prefix blocks' K/V, ``rows_idx`` (kb, nbp) physical ids
        sentinel-padded (clamped to garbage rows the suffix mask never
        exposes).  Under the device lock; the copies are fresh tensors,
        safe to use outside it (over a tensor-parallel replica a handle
        to the copies each rank keeps).  The radix trie and the block
        ids are the leader's: a peer gets the ids with the call."""
        if self.kv_mode != "paged":
            raise MXNetError("gather_prefix() requires kv_mode='paged'")
        kb, nbp = rows_idx.shape
        self._note(("gather", kb, nbp * self.block_size))
        g = self._dev(rows_idx).clamp(max=self.num_blocks - 1)

        def gather(g):
            return [tuple(p[g].transpose(1, 2).reshape(
                kb, p.shape[1], nbp * self.block_size, p.shape[3])
                for p in kv) for kv in self._pool]

        with self.dev_lock:
            return self._hold(self._program(
                ("gather", kb, nbp * self.block_size), gather, g))

    @_mirrored
    @torch.inference_mode()
    def prefill_suffix(self, prefix_kv, prompts_pad, t0s, s0s):
        """Radix-hit prefill, phase 1: the novel-suffix forward against
        the gathered prefix K/V, WITHOUT the device lock.
        ``prompts_pad`` (kb, ls) carries only suffix tokens, ``t0s``
        their true suffix lengths, ``s0s`` each row's reused prefix
        length (block-aligned; 0 = no hit).  Returns (first-token device
        tensor, suffix K/V rows) for ``commit_rows(..., skip_blocks=)``."""
        if self.kv_mode != "paged":
            raise MXNetError("prefill_suffix() requires kv_mode='paged'")
        prefix_kv = self._take(prefix_kv)
        kb, ls = prompts_pad.shape
        lpre = prefix_kv[0][0].shape[2]
        self._note(("prefill_sfx", kb, lpre, ls))

        def suffix(prefix_kv, ids, t0, s0):
            rows, logits = self._dec._prefill_suffix_impl(
                self._w, prefix_kv, ids, t0, s0)
            return logits.argmax(dim=-1), rows

        toks, rows = self._program(
            ("prefill_sfx", kb, lpre, ls), suffix, prefix_kv,
            self._dev(prompts_pad), self._dev(t0s), self._dev(s0s))
        return toks, self._hold(rows)

    # -- transitions (both modes) ---------------------------------------------
    @torch.inference_mode()
    def step(self, active):
        """One decode step over ALL slots; returns the (num_slots,)
        next-token vector on host and advances the ``active`` slots'
        mirrors.  Vacant slots run at pos 0 with token 0 — their output
        is never read, and their K/V write lands in their own slot row
        (slots mode) or the trash block (paged).  The device lock covers
        dispatch and mirror updates, NOT the host materialization wait."""
        self._note(self._step_key)
        # the channel's lock before the device lock, as the other
        # programs take them
        with self._serial(), self.dev_lock:
            toks = self._step_state(self._host_state())
            self.steps += 1
        if self._numerics:
            toks, lstats = toks
            # the tick's logit statistics (a copy), for the stride harvest
            _numerics.record_compiled(("serving.logits",), (lstats,))
        out = _materialize([toks])[0]
        with self.dev_lock:
            for s in active:
                self._last[s] = out[s]
                self._pos[s] += 1
        return out

    @_mirrored
    @torch.inference_mode()
    def _step_state(self, state):
        """The decode program on the slot state ``state`` (``_host_state``'s
        array) → the next tokens on the device: the graph's replay, or the
        eager step."""
        if self._step_graph is None:
            return self._step_program(torch.from_numpy(state).to(
                self.device))
        # the previous tick's copy has run: its tokens were read
        self._pinned.numpy()[:] = state
        with self._graph_lock:
            self._state.copy_(self._pinned, non_blocking=True)
            self._step_graph.replay()
            out = self._step_graph.outputs
            # one copy of each static output: the next replay overwrites
            return _tree(torch.clone, out)

    @torch.inference_mode()
    def verify(self, drafts):
        """Speculative decode: ONE multi-position target forward over the
        window ``[last_committed, draft_1..draft_k]`` per slot.
        ``drafts`` is (num_slots, k) int32 (vacant rows write the trash
        block).  Returns the (num_slots, k+1) greedy verdict matrix on
        host: column j is the target's next token after the window's
        first j+1 tokens.  The mirrors are NOT advanced here: the decode
        lane rolls the manager back and commits them with
        :meth:`set_mirror`."""
        if self.kv_mode != "paged":
            raise MXNetError("verify() requires kv_mode='paged'")
        self._note(("verify",))
        # the channel's lock before the device lock, as everywhere
        with self._serial(), self.dev_lock:
            toks_mat = np.concatenate(
                [self._last[:, None], np.asarray(drafts, np.int32)],
                axis=1)
            out = self._verify_state(toks_mat, self._tables, self._pos)
            self.steps += 1
        if self._numerics:
            out, lstats = out
            _numerics.record_compiled(("serving.logits",), (lstats,))
        return _materialize([out])[0]

    @_mirrored
    @torch.inference_mode()
    def _verify_state(self, toks_mat, tables, pos):
        """The verify program on host state (the windows, the block
        tables, the write cursors) → the greedy verdicts on the
        device."""
        def verify(tables, toks, pos):
            logits = self._dec._verify_blocks_impl(
                self._w, self._pool, tables, toks, pos)
            if self._numerics:
                return logits.argmax(dim=-1), _numerics.stats_of(logits)
            return logits.argmax(dim=-1)

        return self._program(("verify",), verify, self._dev(tables),
                             self._dev(toks_mat), self._dev(pos))

    def last_tokens(self):
        """Snapshot of the per-slot last-committed-token mirror."""
        with self.dev_lock:
            return self._last.copy()

    def positions(self):
        """Snapshot of the per-slot committed write cursors."""
        with self.dev_lock:
            return self._pos.copy()

    def set_mirror(self, slot, last, pos):
        """Commit a slot's decode mirror (speculative acceptance, or
        aligning a draft engine's cursor with the target's)."""
        with self.dev_lock:
            self._last[slot] = int(last)
            self._pos[slot] = int(pos)

    def clear_slot(self, slot):
        with self.dev_lock:
            self._last[slot] = 0
            self._pos[slot] = 0
            if self._tables is not None:
                self._tables[slot] = self.num_blocks


class GenerativeScheduler:
    """Admit/step/evict loop: continuous batching over the slots engine.

    The single-thread loop of ``ServerConfig(kv_mode="slots")``: one
    thread interleaves admission (prefill + cache write) with decode
    steps; the paged default runs the lanes of :mod:`.lanes` instead.
    Admission happens between decode steps whenever slots are free — a
    late request joins the in-flight batch without stopping anyone
    else's decode (its ``joined_step``/``done_step`` land in its
    record).  Finished requests' records are kept in ``records`` and
    emitted as ``serving.request`` JSONL records; every ``summary_every``
    completions it emits ``serving.latency``.
    """

    def __init__(self, engine, queue, policy=None, summary_every=16,
                 poll_s=0.02, max_records=4096, slo=None):
        if engine.kv_mode != "slots":
            raise MXNetError(
                "GenerativeScheduler drives the slot-ledger engine; "
                "paged engines are driven by serving.lanes")
        self.engine = engine
        self.queue = queue
        self.policy = policy or BucketPolicy(
            max_batch=engine.num_slots, max_length=engine.max_len,
            min_batch=1, min_length=8)
        self.mgr = KVCacheManager(engine.num_slots, engine.max_len)
        self.summary_every = int(summary_every)
        self.slo = slo   # the server's SLOTracker, or None
        self.poll_s = float(poll_s)
        self.completed = 0
        self.failed = 0
        self.batches = 0
        self.records = deque(maxlen=int(max_records))
        self._seqs = {}       # slot -> (request, [generated tokens])
        self._stop = threading.Event()
        self._thread = None
        self.error = None

    # -- lifecycle ------------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="mxt-serving-decode",
                                        daemon=True)
        self._thread.start()

    def stop(self, drain=True):
        self._stop.set()
        self.queue.close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if drain:
            while self._seqs or len(self.queue):
                self._admit_pending()
                if not self._seqs:
                    break
                self._decode_step()
        for r in self.queue.take_group(lambda r: 0, 1 << 30):
            r.future.set_exception(
                ServerClosedError("server stopped before execution"))
        if self.error is not None:
            raise self.error

    # -- the loop -------------------------------------------------------------
    def _loop(self):
        # per-request failures are handled below; this catches loop bugs
        # so the thread never dies silently (re-raised at stop())
        try:
            while not self._stop.is_set():
                admitted = self._admit_pending()
                if self._seqs:
                    self._decode_step()
                elif not admitted:
                    self.queue.wait_for_item(self.poll_s)
        except Exception as exc:
            self.error = exc

    def _prompt_bucket(self, req):
        return self.policy.length_bucket(len(req.prompt_ids))

    def _admit_pending(self):
        """Admit queued requests into free slots (one prompt-length
        bucket group per call, the FIFO head's)."""
        free = self.mgr.free_slots()
        if not free or not len(self.queue):
            return False
        group = self.queue.take_group(
            self._prompt_bucket, min(free, self.policy.max_batch))
        if not group:
            return False
        t_start = time.perf_counter()
        lb = self._prompt_bucket(group[0])
        kb = self.policy.batch_bucket(len(group))
        try:
            prompts = pad_batch([np.asarray(r.prompt_ids, np.int32)
                                 for r in group], kb, lb)
            t0s = np.full(kb, len(group[0].prompt_ids), np.int32)
            slots = np.full(kb, self.engine.num_slots, np.int32)
            for i, r in enumerate(group):
                t0s[i] = len(r.prompt_ids)
                slot = self.mgr.admit(r.id, t0s[i], r.max_new_tokens,
                                      step=self.engine.steps)
                slots[i] = slot
                r.slot = int(slot)
                r.replica = self.engine.replica_id
                r.joined_step = self.engine.steps
                r.t_start = t_start
                r.bucket = (kb, lb)
                r.batch_size = len(group)
            first = self.engine.admit(prompts, t0s, slots)
        except Exception as exc:
            for r in group:
                if r.slot is not None and r.slot in self.mgr._active:
                    self.mgr.evict(r.slot)
                r.replica = self.engine.replica_id
                r.future.set_exception(exc)
                self._fail(r, exc, lane="prefill")
            tracing.incident("replica_exception",
                             context={"replica": self.engine.replica_id,
                                      "lane": "prefill",
                                      "error": repr(exc)})
            return False
        t_first = time.perf_counter()
        mates = [r.id for r in group]
        for i, r in enumerate(group):
            r.t_first = t_first
            if r.trace is not None:
                r.trace.add("queue", r.t_submit, t_start,
                            replica=r.replica)
                r.trace.add("prefill", t_start, t_first,
                            replica=r.replica, slot=r.slot,
                            bucket=list(r.bucket),
                            mates=[m for m in mates if m != r.id])
            self._seqs[r.slot] = (r, [int(first[i])])
            if self.mgr.consume(r.slot):
                self._finish(r.slot)
        telemetry.count("serving.admitted", len(group))
        return True

    def _decode_step(self):
        active = self.mgr.active_slots()
        t0 = time.perf_counter()
        try:
            toks = self.engine.step(active)
        except Exception as exc:
            for slot in list(active):
                req, _ = self._seqs.pop(slot)
                self.mgr.evict(slot)
                self.engine.clear_slot(slot)
                req.future.set_exception(exc)
                self._fail(req, exc, lane="decode")
            tracing.incident("replica_exception",
                             context={"replica": self.engine.replica_id,
                                      "lane": "decode",
                                      "error": repr(exc)})
            return
        t1 = time.perf_counter()
        self.batches += 1
        telemetry.hist("serving.batch_size", len(active))
        step_idx = self.engine.steps
        for slot in active:
            self.mgr.advance(slot)   # the step wrote K/V at slot's pos
            req, tokens = self._seqs[slot]
            tokens.append(int(toks[slot]))
            if req.trace is not None:
                req.trace.add("decode.step", t0, t1, step=step_idx,
                              batch=len(active), replica=req.replica,
                              slot=slot)
            if self.mgr.consume(slot):
                self._finish(slot)

    def _finish(self, slot):
        req, tokens = self._seqs.pop(slot)
        self.mgr.evict(slot)
        self.engine.clear_slot(slot)
        req.t_done = time.perf_counter()
        req.done_step = self.engine.steps
        n = req.max_new_tokens
        self._account(req)
        req.future.set_result(np.concatenate(
            [np.asarray(req.prompt_ids, np.int32),
             np.asarray(tokens[:n], np.int32)]))
        if self.summary_every and self.completed % self.summary_every == 0:
            self.emit_summary()

    def _account(self, req):
        self.completed += 1
        telemetry.count("serving.completed")
        telemetry.count(f"serving.completed|replica={req.replica}")
        rec = req.record(lane="decode")
        tag = f"|replica={req.replica}"
        for key in ("queue_wait_ms", "total_ms", "ttft_ms", "tpot_ms"):
            if rec.get(key) is not None:
                telemetry.hist("serving." + key, rec[key])
                telemetry.hist("serving." + key + tag, rec[key])
        if self.slo is not None:
            rec["slo_met"] = self.slo.observe(
                tenant=req.tenant, ttft_ms=rec.get("ttft_ms"),
                tpot_ms=rec.get("tpot_ms"))
        self.records.append(rec)
        telemetry.emit(rec)
        if req.trace is not None:
            req.trace.event("evict", replica=req.replica, slot=req.slot)
            tracing.finish(req.trace, status="ok", replica=req.replica,
                           lane="decode", request_id=req.id)

    def _fail(self, req, exc, lane):
        """Failure-path twin of :meth:`_account`: the error record with
        replica and lane, the failed counters, the trace seal."""
        self.failed += 1
        telemetry.count("serving.failed")
        telemetry.count(f"serving.failed|replica={req.replica}")
        req.t_done = time.perf_counter()
        rec = req.record(lane=lane, status="error", error=repr(exc))
        self.records.append(rec)
        telemetry.emit(rec)
        if req.trace is not None:
            tracing.finish(req.trace, status="error",
                           replica=req.replica, lane=lane,
                           error=repr(exc), request_id=req.id)

    def emit_summary(self):
        telemetry.emit({
            "record": "serving.latency",
            "completed": self.completed,
            "failed": self.failed,
            "batches": self.batches,
            "rejected": self.queue.rejected,
            "queue_wait_ms": telemetry.hist_summary("serving.queue_wait_ms"),
            "total_ms": telemetry.hist_summary("serving.total_ms"),
            "ttft_ms": telemetry.hist_summary("serving.ttft_ms"),
            "batch_size": telemetry.hist_summary("serving.batch_size"),
            "kv_cache": self.mgr.stats(),
        })
