"""Disaggregated prefill/decode execution lanes over paged KV.

Counterpart of ``mxnet_tpu/serving/lanes.py``.  The two phases of
serving run as lanes with their own threads and batch policies,
connected by an explicit KV handoff:

* :class:`PrefillLane` — batch-tolerant.  Pulls the FIFO-head prompt
  bucket from the replica queue, gated by the paged-KV admission budget
  (free decode slots, free KV blocks, a cumulative prompt-token ceiling),
  admits each request to the :class:`~.kv_cache.PagedKVCacheManager`
  (which reserves the request's whole block budget up front), runs the
  prompt forward OUTSIDE the engine's device lock, then commits the raw
  K/V rows into the admitted blocks (one brief locked scatter) and hands
  the slot to the decode lane.
* :class:`DecodeLane` — every tick it adopts pending handoffs, then
  advances its own slot set one token (or, with a draft engine, one
  speculative window).
* :class:`Replica` — one engine + manager + lane pair, fed by a bounded
  queue; :class:`ReplicaDispatcher` routes the server's front queue to
  the least loaded replica.  A replica runs where its ``ReplicaMesh``
  says (``generative.py``): on a card (or the CPU) of this process, or,
  with tp > 1, over its tensor-parallel ranks, where the leader runs the
  lanes and each peer only ``follow``s its leader's programs.

Both lanes share one engine and one CUDA stream; every device→host wait
is ``scheduler._materialize`` (first tokens at the handoff, token vectors
at each tick).  Each lane thread runs under ``torch.inference_mode()``.

Observability, from stamps the lanes already take: with
``telemetry.tracing`` on, each request carries its span context across
the lane threads (``req.trace``) — the prefill lane records the
``queue`` and ``prefill`` spans, the decode lane ``handoff`` and one
``decode.step`` a tick, and :meth:`Replica.finish` seals the trace
(``evict``, then the root).  A decode tick's stamps close after the
host has the tick's tokens, so a span (and the ``capacity`` ledgers'
busy interval) covers the card's work, with no sync added for them.
Lane failures trip the flight recorder (``tracing.incident``).  The
request records are kept in ``Replica.records`` and emitted as
``serving.request`` JSONL records; every ``summary_every`` completions a
replica emits ``serving.latency`` with its ``capacity`` view.  On a
tensor-parallel replica only the leader runs the lanes, so traces,
records and capacity notes come from the leader alone.
"""
from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np
import torch

from .. import sanitizer as _san
from .. import telemetry
from ..telemetry import capacity
from ..telemetry import tracing
from .bucketing import pad_batch
from .kv_cache import PagedKVCacheManager
from .protocol import ServerClosedError
from .scheduler import RequestQueue, _materialize

__all__ = ["PrefillLane", "DecodeLane", "Replica", "ReplicaDispatcher"]


class _Handoff:
    """One admitted request crossing the prefill→decode boundary: its
    KV rows are already scattered into its blocks; the decode lane just
    adopts the slot."""

    __slots__ = ("req", "slot", "first")

    def __init__(self, req, slot, first):
        self.req = req
        self.slot = slot
        self.first = first


class _Lane:
    """Thread scaffolding shared by both lanes: a lane-machinery error
    is captured and re-raised at ``join()``."""

    _name = "lane"

    def __init__(self, replica, poll_s):
        self.r = replica
        self.poll_s = float(poll_s)
        self._stop = threading.Event()
        self._thread = None
        self.error = None

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop,
                name=f"mxt-{self._name}-r{self.r.index}", daemon=True)
            self._thread.start()

    def join(self):
        """Join the lane thread; a captured lane-machinery error is
        re-raised here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            raise self.error

    def alive(self):
        return self._thread is not None and self._thread.is_alive()

    def _loop(self):
        # per-request failures are handled inside the lane; this catches
        # lane-machinery bugs so the thread never dies silently.  A new
        # thread starts with grad mode on: the lane runs without autograd
        try:
            dev = self.r.engine.device
            if dev.type == "cuda":  # the replica's card, for its streams
                torch.cuda.set_device(dev)
            with torch.inference_mode():
                self._run()
        except Exception as exc:
            self.error = exc
            tracing.incident("lane_thread_error",
                             context={"replica": self.r.index,
                                      "lane": self._name,
                                      "error": repr(exc)})


class PrefillLane(_Lane):
    """Admission + prompt forward + KV commit, one thread per replica."""

    _name = "prefill"

    def __init__(self, replica, poll_s=0.02):
        super().__init__(replica, poll_s)
        self._drain = True

    def request_stop(self, drain=True):
        self._drain = drain
        self._stop.set()

    def _run(self):
        q = self.r.queue
        while True:
            if self._stop.is_set():
                if not self._drain or not len(q):
                    break
            if not self._admit_batch() and not self._stop.is_set():
                if len(q):
                    # queue non-empty but gated on capacity: wait for an
                    # eviction to free slots/blocks
                    self.r.capacity_evt.wait(self.poll_s)
                    self.r.capacity_evt.clear()
                else:
                    q.wait_for_item(self.poll_s)

    def _bucket(self, req):
        """Prompt-length bucket — of the NOVEL SUFFIX when the radix
        prefix cache is on (``match_len`` does not touch LRU state; this
        thread is the trie's only mutator, so the probe and the real
        lookup in ``_admit_batch`` agree)."""
        plen = len(req.prompt_ids)
        if self.r.radix is not None:
            plen -= self.r.radix.match_len(req.prompt_ids)
        return self.r.policy.length_bucket(plen)

    def _admit_batch(self):
        """One prefill batch: gate → admit → forward (unlocked) →
        commit (locked) → handoff.  Returns True if anything ran."""
        r = self.r
        mgr = r.mgr
        free_slots = mgr.free_slots()
        if not free_slots or not len(r.queue):
            return False
        free_blocks = mgr.allocator.free_blocks
        budget = {"n": 0, "blocks": 0, "tokens": 0}

        def accept(req):
            # greedy by token count under the block budget (a radix hit
            # shrinks the fresh-block need by the shared prefix)
            need = mgr.blocks_for(len(req.prompt_ids),
                                  req.max_new_tokens)
            if r.radix is not None:
                need -= r.radix.match_len(req.prompt_ids) \
                    // mgr.block_size
            if budget["n"] >= free_slots:
                return False
            if budget["blocks"] + need > free_blocks:
                return False
            if budget["tokens"] and (budget["tokens"]
                                     + len(req.prompt_ids)
                                     > r.max_prefill_tokens):
                return False
            budget["n"] += 1
            budget["blocks"] += need
            budget["tokens"] += len(req.prompt_ids)
            return True

        group = r.queue.take_batch(
            self._bucket, min(free_slots, r.policy.max_batch), accept)
        if not group:
            return False
        t_start = time.perf_counter()
        lb = self._bucket(group[0])
        kb = r.policy.batch_bucket(len(group))
        eng = r.engine
        rx = r.radix
        try:
            if rx is not None:
                # the real lookup (bumps LRU, counts hits); references are
                # taken by admit() under the manager lock
                t_rx0 = time.perf_counter()
                matched, shared = [], []
                for req in group:
                    m, blks = rx.lookup(req.prompt_ids)
                    matched.append(m)
                    shared.append(blks)
                t_rx1 = time.perf_counter()
                hits = sum(1 for m in matched if m)
                telemetry.count("serving.radix_hits", hits)
                telemetry.count("serving.radix_misses", len(group) - hits)
                if any(matched):
                    telemetry.count("serving.radix_hit_tokens",
                                    sum(matched))
            else:
                t_rx0 = t_rx1 = t_start
                matched = [0] * len(group)
                shared = [None] * len(group)
            prompts = pad_batch(
                [np.asarray(q.prompt_ids[matched[i]:], np.int32)
                 for i, q in enumerate(group)], kb, lb)
            t0s = np.full(kb, len(group[0].prompt_ids), np.int32)
            t0s_suf = np.full(
                kb, len(group[0].prompt_ids) - matched[0], np.int32)
            s0s = np.zeros(kb, np.int32)
            skip = np.zeros(kb, np.int32)
            slots = np.full(kb, eng.num_slots, np.int32)
            block_lists = [None] * kb
            for i, req in enumerate(group):
                t0s[i] = len(req.prompt_ids)
                t0s_suf[i] = t0s[i] - matched[i]
                s0s[i] = matched[i]
                skip[i] = matched[i] // mgr.block_size
                slot, blocks = mgr.admit(req.id, int(t0s[i]),
                                         req.max_new_tokens,
                                         step=eng.steps,
                                         shared_blocks=shared[i] or None)
                slots[i] = slot
                block_lists[i] = blocks
                req.slot = int(slot)
                req.kv_blocks = len(blocks)
                if rx is not None:
                    req.prefix_hit_tokens = matched[i]
                req.replica = r.index
                req.joined_step = eng.steps
                req.t_start = t_start
                req.bucket = (kb, lb)
                req.batch_size = len(group)
            with telemetry.span("serving.prefill",
                                {"lane": "prefill", "replica": r.index,
                                 "batch": kb, "length": lb}):
                if rx is not None and any(matched):
                    # radix-hit path: dense prefix copies (locked gather)
                    # feed the suffix-only forward (unlocked); the commit
                    # writes ONLY the suffix rows, into the request's
                    # private blocks past the shared prefix
                    pre_lb = r.policy.length_bucket(max(matched))
                    nbp_pre = -(-pre_lb // mgr.block_size)
                    rows_idx = np.full((kb, nbp_pre), eng.num_blocks,
                                       np.int32)
                    for i in range(len(group)):
                        rows_idx[i, :skip[i]] = block_lists[i][:skip[i]]
                    pre_kv = eng.gather_prefix(rows_idx)
                    toks, rows = eng.prefill_suffix(pre_kv, prompts,
                                                    t0s_suf, s0s)
                else:
                    toks, rows = eng.prefill_rows(prompts, t0s_suf)
                first = _materialize([toks])[0]
                eng.commit_rows(rows, slots, block_lists, t0s, first,
                                skip_blocks=skip)
            if rx is not None:
                # register the full prompt blocks (written by the commit
                # above, on the same stream) so later requests share them
                for i, req in enumerate(group):
                    rx.insert(req.prompt_ids, block_lists[i])
            if r.draft is not None:
                # the draft engine prefills the FULL prompt into its own
                # slot caches, then aligns its mirror with the target's
                # first token (draft.admit picked its own)
                lbf = r.policy.length_bucket(
                    max(len(q.prompt_ids) for q in group))
                fulls = pad_batch([np.asarray(q.prompt_ids, np.int32)
                                   for q in group], kb, lbf)
                r.draft.admit(fulls, t0s, slots)
                for i in range(len(group)):
                    s = int(slots[i])
                    if s < eng.num_slots:
                        r.draft.set_mirror(s, int(first[i]), int(t0s[i]))
        except Exception as exc:
            for req in group:
                if req.slot is not None and req.slot in mgr._active:
                    mgr.evict(req.slot)
                    eng.clear_slot(req.slot)
                req.replica = r.index
                req.future.set_exception(exc)
                r.fail(req, exc, lane="prefill")
            r.capacity_evt.set()
            tracing.incident("replica_exception",
                             context={"replica": r.index,
                                      "lane": "prefill",
                                      "error": repr(exc)})
            return True
        t_first = time.perf_counter()
        # the prefill busy interval, from the stamps the lane already took
        # (t_first follows the first tokens' host read)
        capacity.lane_busy(r.index, "prefill", t_start, t_first)
        mates = [req.id for req in group]
        for i, req in enumerate(group):
            req.t_first = t_first
            if rx is not None and matched[i] and t0s_suf[i] > 0:
                # prefill cost scales about linearly in prompt tokens, so
                # the saved share is the reused fraction scaled onto the
                # measured suffix prefill (an estimate)
                pf_ms = (t_first - t_rx1) * 1e3
                req.prefill_saved_ms = pf_ms * matched[i] \
                    / int(t0s_suf[i])
            if req.trace is not None:
                # retroactive spans from the stamps above: queue covers
                # dispatch + bucket dwell, prefill the forward + commit
                req.trace.add("queue", req.t_submit, t_start,
                              replica=r.index)
                if rx is not None:
                    req.trace.add("radix_lookup", t_rx0, t_rx1,
                                  replica=r.index, hit_tokens=matched[i])
                req.trace.add("prefill", t_start, t_first,
                              replica=r.index, slot=req.slot,
                              kv_blocks=req.kv_blocks,
                              bucket=list(req.bucket),
                              mates=[m for m in mates if m != req.id])
            if mgr.consume(req.slot):
                # max_new_tokens == 1: done at prefill, never decodes
                r.finish(req, [int(first[i])])
            else:
                r.decode.hand_off(_Handoff(req, req.slot, int(first[i])))
        r.prefill_ms.append((t_first - t_start) * 1e3)
        telemetry.count("serving.admitted", len(group))
        return True


class DecodeLane(_Lane):
    """Slot-set advancement, one thread per replica: adopt handoffs,
    tick every in-flight slot, evict finished requests (returning their
    KV blocks to the pool)."""

    _name = "decode"

    def __init__(self, replica, poll_s=0.005):
        super().__init__(replica, poll_s)
        self._handoffs = deque()
        self._hand_lock = _san.wrap_lock(
            threading.Lock(), "lanes.DecodeLane._hand_lock")
        self._seqs = {}       # slot -> (request, [generated tokens])
        self._wake = threading.Event()   # set on hand_off: adopt now

    def hand_off(self, h):
        with self._hand_lock:
            self._handoffs.append(h)
        self._wake.set()

    def pending(self):
        with self._hand_lock:
            return len(self._handoffs) + len(self._seqs)

    def request_stop(self):
        self._stop.set()

    def snapshot(self):
        """In-flight view for the /requests table: handoffs not yet
        adopted and decoding slots, host-side bookkeeping only."""
        rows = []
        with self._hand_lock:
            handoffs = list(self._handoffs)
            seqs = dict(self._seqs)
        for h in handoffs:
            rows.append({"request_id": h.req.id, "state": "handoff",
                         "slot": h.slot, "replica": self.r.index,
                         "trace_id": h.req.trace.trace_id
                         if h.req.trace is not None else None})
        for slot, (req, tokens) in seqs.items():
            rows.append({"request_id": req.id, "state": "decoding",
                         "slot": slot, "replica": self.r.index,
                         "trace_id": req.trace.trace_id
                         if req.trace is not None else None,
                         "tokens_done": len(tokens),
                         "max_new_tokens": req.max_new_tokens})
        return rows

    def _run(self):
        spec = self.r.spec_k > 0 and self.r.draft is not None
        while True:
            self._adopt()
            with self._hand_lock:
                busy = bool(self._seqs)
            if busy:
                self._tick_spec() if spec else self._tick()
            elif self._stop.is_set():
                if not self.pending():
                    break
            else:
                self._wake.wait(self.poll_s)
                self._wake.clear()

    def _adopt(self):
        """Pull every pending handoff into this lane's slot set.  The KV
        rows are already in the request's blocks, so adoption is pure
        bookkeeping."""
        while True:
            with self._hand_lock:
                if not self._handoffs:
                    return
                h = self._handoffs.popleft()
            h.req.t_handoff = time.perf_counter()
            hand_ms = (h.req.t_handoff - h.req.t_first) * 1e3
            telemetry.hist("serving.handoff_ms", hand_ms)
            telemetry.hist(f"serving.handoff_ms|replica={self.r.index}",
                           hand_ms)
            if h.req.trace is not None:
                h.req.trace.add("handoff", h.req.t_first,
                                h.req.t_handoff, replica=self.r.index,
                                slot=h.slot)
            with self._hand_lock:
                self._seqs[h.slot] = (h.req, [h.first])

    def _fail_all(self, active, exc):
        r = self.r
        for slot in active:
            with self._hand_lock:
                req, _ = self._seqs.pop(slot)
            r.mgr.evict(slot)
            r.engine.clear_slot(slot)
            if r.draft is not None:
                r.draft.clear_slot(slot)
            req.future.set_exception(exc)
            r.fail(req, exc, lane="decode")
        r.capacity_evt.set()
        tracing.incident("replica_exception",
                         context={"replica": r.index, "lane": "decode",
                                  "error": repr(exc)})

    def _tick(self):
        r = self.r
        with self._hand_lock:
            active = sorted(self._seqs)
        t0 = time.perf_counter()
        try:
            toks = r.engine.step(active)
        except Exception as exc:
            self._fail_all(active, exc)
            return
        # t1 follows the tokens' host read inside ``step``: the stamps
        # bracket the card's work, not just the graph's launch
        t1 = time.perf_counter()
        r.note_tick(len(active), t0, t1)
        step_idx = r.engine.steps
        for slot in active:
            r.mgr.advance(slot)   # the step wrote K/V at slot's pos
            with self._hand_lock:
                req, tokens = self._seqs[slot]
            tokens.append(int(toks[slot]))
            if req.trace is not None:
                # one span per traced slot per tick (one dict append)
                req.trace.add("decode.step", t0, t1, step=step_idx,
                              batch=len(active), replica=r.index,
                              slot=slot)
            if r.mgr.consume(slot):
                with self._hand_lock:
                    del self._seqs[slot]
                r.finish(req, tokens)

    def _tick_spec(self):
        """Speculative tick: k sequential DRAFT steps propose a window,
        ONE target verify scores all k+1 positions, and greedy
        token-exact acceptance commits the matched prefix plus (below
        full acceptance) the target's correction token — the same output
        as plain decode (every emitted token is a target argmax given the
        tokens before it), at one target forward per up-to-k tokens.
        Rollback is host-side only: the manager's cursor advances by the
        whole window and truncates to the accepted position; rejected
        rows sit masked in the pool until the next window overwrites
        them."""
        r = self.r
        k = r.spec_k
        with self._hand_lock:
            active = sorted(self._seqs)
        t0 = time.perf_counter()
        proposals = np.zeros((r.engine.num_slots, k), np.int32)
        try:
            for j in range(k):
                # draft mirrors auto-advance, so step j+1 is conditioned
                # on the draft's own proposal j
                proposals[:, j] = r.draft.step(active)
            t_draft = time.perf_counter()
            pos0 = r.engine.positions()
            out = r.engine.verify(proposals)
        except Exception as exc:
            self._fail_all(active, exc)
            return
        t1 = time.perf_counter()
        r.note_tick(len(active), t0, t1)
        accepted_this_tick = 0
        step_idx = r.engine.steps
        for slot in active:
            d, g = proposals[slot], out[slot]
            m = 0
            while m < k and d[m] == g[m]:
                m += 1
            st = r.mgr.state(slot)
            # accepted = matched drafts + the target's own next token,
            # capped at k (on full acceptance the bonus token is NOT
            # taken: the draft's cache holds rows for [last, d1..d_{k-1}]
            # only) and clamped to the tokens still owed
            acc = min(m + 1, k, int(st.remaining))
            adv = min(k + 1, int(st.reserved) - int(st.pos))
            r.mgr.advance_n(slot, adv)
            r.mgr.truncate(slot, int(pos0[slot]) + acc)
            last = int(g[acc - 1])
            r.engine.set_mirror(slot, last, int(pos0[slot]) + acc)
            r.draft.set_mirror(slot, last, int(pos0[slot]) + acc)
            with self._hand_lock:
                req, tokens = self._seqs[slot]
            tokens.extend(int(t) for t in g[:acc])
            got = min(m, acc)
            req.draft_tokens += k
            req.accepted_tokens += got
            r.draft_tokens += k
            r.accepted_tokens += got
            accepted_this_tick += got
            telemetry.count("serving.accepted_tokens", got)
            if req.trace is not None:
                req.trace.add("draft", t0, t_draft, step=step_idx,
                              k=k, replica=r.index, slot=slot)
                req.trace.add("verify", t_draft, t1, step=step_idx,
                              accepted=acc, replica=r.index, slot=slot)
            done = False
            for _ in range(acc):
                if r.mgr.consume(slot):
                    done = True
            if done:
                with self._hand_lock:
                    del self._seqs[slot]
                r.finish(req, tokens)
        telemetry.count("serving.draft_tokens", k * len(active))
        capacity.note_spec(r.index, k * len(active), accepted_this_tick)
        if r.draft_tokens:
            telemetry.gauge("serving.accept_rate",
                            round(r.accepted_tokens / r.draft_tokens, 4))


class Replica:
    """One model replica: engine + paged-KV manager + lane pair, fed by a
    bounded internal queue."""

    def __init__(self, net, policy, index=0, mesh=None,
                 partition_rules=None, num_slots=4, int8=False,
                 block_size=16, num_blocks=None, queue_capacity=64,
                 max_prefill_tokens=None, draft_net=None, spec_k=0,
                 radix_cache=False, prefix_cache_tokens=None,
                 max_records=4096, summary_every=32, slo=None):
        from .generative import LlamaServingEngine

        self.index = int(index)
        self.policy = policy
        self.spec_k = int(spec_k) if draft_net is not None else 0
        self.engine = LlamaServingEngine(
            net, max_len=policy.max_length, num_slots=num_slots,
            int8=int8, kv_mode="paged", block_size=block_size,
            num_blocks=num_blocks, mesh=mesh,
            partition_rules=partition_rules, replica_id=self.index,
            spec_k=self.spec_k)
        rm = self.engine.mesh
        #: a tensor-parallel peer: it runs its leader's programs only
        self.follower = rm is not None and not rm.is_leader
        self.draft = None
        if self.spec_k > 0:
            # the draft runs the slot-ledger engine: fixed per-slot cache
            # rows, no block bookkeeping to keep consistent with the
            # target's pool; over tp > 1 on the target's ranks and channel
            self.draft = LlamaServingEngine(
                draft_net, max_len=policy.max_length,
                num_slots=num_slots, int8=int8, kv_mode="slots",
                mesh=rm, partition_rules=partition_rules,
                replica_id=self.index, channel=self.engine._channel)
        self.mgr = PagedKVCacheManager(
            num_slots, policy.max_length,
            num_blocks=self.engine.num_blocks,
            block_size=self.engine.block_size)
        self.radix = None
        if radix_cache:
            from .radix import RadixPrefixCache
            cap = int(prefix_cache_tokens
                      if prefix_cache_tokens is not None
                      else self.engine.num_blocks
                      * self.engine.block_size // 2)
            self.radix = RadixPrefixCache(self.mgr.allocator,
                                          self.engine.block_size, cap)
            self.mgr.prefix_cache = self.radix
        self.draft_tokens = 0
        self.accepted_tokens = 0
        self.queue = RequestQueue(queue_capacity)
        self.max_prefill_tokens = int(max_prefill_tokens or
                                      policy.max_batch
                                      * policy.max_length)
        self.summary_every = int(summary_every)
        self.prefill = PrefillLane(self)
        self.decode = DecodeLane(self)
        self.capacity_evt = threading.Event()  # set on evict: re-admit
        self.slo = slo   # the server's SLOTracker, or None
        self.completed = 0
        self.failed = 0
        self.batches = 0
        # the last ``max_records`` requests' records, prefill batches'
        # and decode ticks' host wall times (ms), and each tick's slots
        self.records = deque(maxlen=int(max_records))
        self.prefill_ms = deque(maxlen=int(max_records))
        self.tick_ms = deque(maxlen=int(max_records))
        self.tick_slots = deque(maxlen=int(max_records))
        self._rec_lock = threading.Lock()

    # -- dispatcher-facing ----------------------------------------------------
    def load(self):
        """Routing weight: tokens reserved in the KV pool plus tokens
        waiting in the internal queue."""
        queued = self.queue.queued_tokens(
            lambda r: len(r.prompt_ids) + r.max_new_tokens)
        return self.mgr.reserved_tokens() + queued

    def offer(self, req):
        ok = self.queue.offer(req)
        if ok:
            # accepted offers only: a shed request never joins the
            # arrival process the λ estimator models
            capacity.note_arrival(self.index, t=req.t_submit)
        return ok

    # -- lifecycle ------------------------------------------------------------
    def start(self):
        if self.follower:
            self.engine.follow_in_background()
            return
        self.prefill.start()
        self.decode.start()

    def stop(self, drain=True):
        """Drain order matters: prefill first (with decode still live,
        so draining admissions can wait for blocks decode will free),
        then decode finishes the in-flight slot set; then the leader
        releases its tensor-parallel peers (a peer's stop waits for
        that)."""
        if self.follower:
            self.engine.join_follower()
            return
        self.queue.close()
        self.prefill.request_stop(drain)
        try:
            self.prefill.join()
        finally:
            self.decode.request_stop()
            self.decode.join()
            self.engine.release()
        for req in self.queue.take_group(lambda r: 0, 1 << 30):
            req.future.set_exception(
                ServerClosedError("server stopped before execution"))

    # -- accounting -----------------------------------------------------------
    def note_tick(self, n_active, t0, t1):
        """One decode tick (a step, or a speculative window) done between
        the stamps ``t0`` and ``t1`` the lane took."""
        self.batches += 1
        self.tick_ms.append((t1 - t0) * 1e3)
        self.tick_slots.append(n_active)
        telemetry.hist("serving.batch_size", n_active)
        telemetry.gauge("serving.kv_blocks_in_use",
                        self.mgr.allocator.blocks_in_use)
        # the busy interval, batch occupancy and pool pressure of the
        # tick; gated so the arguments cost nothing while it is off
        if capacity.is_enabled():
            capacity.note_tick(self.index, n_active, self.engine.num_slots,
                               t0, t1)
            capacity.note_kv(self.index, self.mgr.allocator.free_blocks,
                             self.mgr.num_blocks)

    def _keep(self, rec):
        with self._rec_lock:
            self.records.append(rec)

    def finish(self, req, tokens):
        self.mgr.evict(req.slot)
        self.engine.clear_slot(req.slot)
        if self.draft is not None:
            self.draft.clear_slot(req.slot)
        self.capacity_evt.set()
        req.t_done = time.perf_counter()
        req.done_step = self.engine.steps
        n = req.max_new_tokens
        self.completed += 1
        telemetry.count("serving.completed")
        telemetry.count(f"serving.completed|replica={self.index}")
        capacity.note_completion(self.index, t=req.t_done)
        lane = "decode" if req.t_handoff is not None else "prefill"
        rec = req.record(lane=lane)
        tag = f"|replica={self.index}"
        for key in ("queue_wait_ms", "total_ms", "ttft_ms", "tpot_ms"):
            if rec.get(key) is not None:
                telemetry.hist("serving." + key, rec[key])
                telemetry.hist("serving." + key + tag, rec[key])
        if self.slo is not None:
            rec["slo_met"] = self.slo.observe(
                tenant=req.tenant, ttft_ms=rec.get("ttft_ms"),
                tpot_ms=rec.get("tpot_ms"))
        self._keep(rec)
        telemetry.emit(rec)
        if req.trace is not None:
            req.trace.event("evict", replica=self.index, slot=req.slot)
            tracing.finish(req.trace, status="ok", replica=self.index,
                           lane=lane, request_id=req.id)
        req.future.set_result(np.concatenate(
            [np.asarray(req.prompt_ids, np.int32),
             np.asarray(tokens[:n], np.int32)]))
        if self.summary_every and self.completed % self.summary_every == 0:
            self.emit_summary()

    def fail(self, req, exc, lane):
        """Failure-path accounting: the ``status="error"`` request record
        (tagged replica + lane), the failed counters and the trace
        seal."""
        self.failed += 1
        telemetry.count("serving.failed")
        telemetry.count(f"serving.failed|replica={self.index}")
        req.t_done = time.perf_counter()
        rec = req.record(lane=lane, status="error", error=repr(exc))
        self._keep(rec)
        telemetry.emit(rec)
        if req.trace is not None:
            tracing.finish(req.trace, status="error", replica=self.index,
                           lane=lane, error=repr(exc), request_id=req.id)

    def emit_summary(self):
        """The rolling ``serving.latency`` record of this replica, with
        its KV pool's stats and its ``capacity`` view."""
        rec = {
            "record": "serving.latency",
            "replica": self.index,
            "completed": self.completed,
            "failed": self.failed,
            "batches": self.batches,
            "queue_wait_ms": telemetry.hist_summary("serving.queue_wait_ms"),
            "total_ms": telemetry.hist_summary("serving.total_ms"),
            "ttft_ms": telemetry.hist_summary("serving.ttft_ms"),
            "handoff_ms": telemetry.hist_summary("serving.handoff_ms"),
            "batch_size": telemetry.hist_summary("serving.batch_size"),
            "kv_cache": self.mgr.stats(),
        }
        # the summary already paid for stats(): feed the pool's
        # fragmentation to the capacity trend estimator here
        capacity.note_kv(self.index, self.mgr.allocator.free_blocks,
                         self.mgr.num_blocks,
                         fragmentation=rec["kv_cache"].get("fragmentation"))
        cap_view = capacity.snapshot(self.index)
        if cap_view is not None:
            rec["capacity"] = cap_view
        if self.draft is not None:
            rec["speculative"] = {
                "k": self.spec_k,
                "draft_tokens": self.draft_tokens,
                "accepted_tokens": self.accepted_tokens,
                "accept_rate": round(self.accepted_tokens
                                     / self.draft_tokens, 4)
                if self.draft_tokens else None,
            }
        if self.radix is not None:
            rec["radix_cache"] = self.radix.stats()
        telemetry.emit(rec)


class ReplicaDispatcher:
    """Routes the front queue to the least-loaded replica.

    One thread pops the FIFO head and offers it to the replica with the
    smallest :meth:`Replica.load` that has internal queue space; if all
    replica queues are full the head is held (client backpressure
    already happened at the front queue's bounded ``put``)."""

    def __init__(self, queue, replicas, poll_s=0.005):
        self.queue = queue
        self.replicas = list(replicas)
        self.poll_s = float(poll_s)
        self._held = None
        self._stop = threading.Event()
        self._thread = None
        self.error = None

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="mxt-dispatch",
                                            daemon=True)
            self._thread.start()

    def alive(self):
        return self._thread is not None and self._thread.is_alive()

    def stop(self, drain=True):
        self._stop.set()
        self.queue.close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            raise self.error
        leftovers = ([self._held] if self._held is not None else []) \
            + self.queue.take_group(lambda r: 0, 1 << 30)
        self._held = None
        for req in leftovers:
            if drain:
                while not self._route(req):
                    time.sleep(self.poll_s)
            else:
                req.future.set_exception(
                    ServerClosedError("server stopped before execution"))

    def _route(self, req):
        for rep in sorted(self.replicas, key=lambda r: r.load()):
            if rep.offer(req):
                return True
        return False

    def _loop(self):
        # catches dispatcher bugs so the routing thread never dies
        # silently; re-raised at stop()
        try:
            self._run()
        except Exception as exc:
            self.error = exc
            tracing.incident("dispatcher_thread_error",
                             context={"error": repr(exc)})

    def _run(self):
        while not self._stop.is_set():
            if self._held is None:
                group = self.queue.take_group(lambda r: 0, 1)
                if not group:
                    self.queue.wait_for_item(self.poll_s)
                    continue
                self._held = group[0]
            if self._route(self._held):
                self._held = None
            else:
                time.sleep(self.poll_s)

