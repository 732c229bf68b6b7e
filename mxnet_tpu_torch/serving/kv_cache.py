"""KV-cache capacity accounting for continuous-batching decode.

Counterpart of ``mxnet_tpu/serving/kv_cache.py`` (the port keeps its
own copy).

Two generations of the same host-side ledger live here:

* :class:`KVCacheManager` — the r8 **slot ledger**: one fixed
  ``max_len`` cache row per slot, capacity = ``num_slots × max_len``
  tokens whether or not a request ever uses its worst case.  Kept
  importable behind the paged pool for A/B (``ServerConfig(
  kv_mode="slots")``) and for the legacy single-loop scheduler.
* :class:`PagedKVCacheManager` — the r11 **paged pool**: device K/V
  lives in fixed-size blocks (``block_size`` tokens each) drawn from a
  shared :class:`BlockAllocator`; each request owns a *block list*
  sized to its actual ``prompt_len + max_new_tokens`` budget, so pool
  capacity is bounded by tokens in flight, not by
  ``max_len × num_slots``.  A long-prompt + short-prompt mix that the
  slot ledger could only host with worst-case reservations fits a much
  smaller pool (the r11 capacity acceptance test admits a mix whose
  slot-ledger worst case exceeds the pool outright).

Both managers expose the same transition surface (``admit`` /
``advance`` / ``consume`` / ``evict``) plus ``check()`` invariants and
``stats()`` with fragmentation and peak-token occupancy.  The paged
manager is touched by TWO lane threads (prefill admits, decode
advances/evicts — docs/serving.md) and serializes its transitions on an
internal lock; the slot ledger stays single-threaded under the legacy
scheduler.

Device-side block contents are the engine's problem: a freshly
allocated block may hold a previous tenant's K/V, but the per-slot
causal mask (``t <= pos``) hides every position the current request has
not yet written, so stale rows are unreachable — the same invariant
that lets the slot ledger skip zeroing slot rows.
"""
from __future__ import annotations

import threading

from ..base import MXNetError

__all__ = ["KVCacheManager", "PagedKVCacheManager", "BlockAllocator",
           "SlotState"]


class SlotState:
    """One occupied slot's bookkeeping."""

    __slots__ = ("request_id", "pos", "remaining", "joined_step",
                 "blocks", "reserved")

    def __init__(self, request_id, pos, remaining, joined_step,
                 blocks=None, reserved=0):
        self.request_id = request_id
        self.pos = pos              # next cache row the step writes
        self.remaining = remaining  # tokens still owed to the request
        self.joined_step = joined_step
        self.blocks = blocks or []  # paged: block ids, logical order
        self.reserved = reserved    # paged: token budget behind blocks


class BlockAllocator:
    """Fixed-size KV block pool: ``num_blocks`` blocks of
    ``block_size`` tokens each, free-list allocation.

    ``alloc`` is all-or-nothing (a request either gets its whole block
    list or stays queued — no partial reservations to unwind), and
    ``free`` rejects double-frees and foreign ids.

    Since r19 every allocated block carries a **refcount**: ``alloc``
    hands out blocks at refcount 1, ``share`` grants an additional
    holder (the radix prefix cache, or a request reusing a cached
    prefix), and ``release`` drops one reference — the block returns to
    the free list only at refcount 0.  ``free`` is ``release`` under
    its historical name, so single-holder callers behave exactly as
    before (including the double-free guard).  Shared blocks are
    strictly read-shared: only *full prompt-prefix* blocks are ever
    shared, and no decode or verify write targets a row inside them.
    """

    def __init__(self, num_blocks, block_size):
        if num_blocks < 1 or block_size < 1:
            raise MXNetError("num_blocks and block_size must be >= 1")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free = list(range(self.num_blocks - 1, -1, -1))  # pop()->0
        self._in_use = set()
        self._refs = {}             # block id -> holder count (>= 1)
        self._peak_in_use = 0
        self._peak_shared = 0

    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def blocks_in_use(self):
        return len(self._in_use)

    @property
    def peak_blocks_in_use(self):
        return self._peak_in_use

    @property
    def shared_blocks(self):
        """Blocks currently held by more than one owner."""
        return sum(1 for c in self._refs.values() if c > 1)

    @property
    def peak_shared_blocks(self):
        return self._peak_shared

    def refcount(self, block):
        """Holder count for ``block`` (0 when free)."""
        return self._refs.get(block, 0)

    def alloc(self, n):
        """Claim ``n`` blocks (ascending ids) at refcount 1.  Returns
        the id list, or None when the pool cannot cover the request
        (all-or-nothing)."""
        if n < 0:
            raise MXNetError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        self._in_use.update(blocks)
        for b in blocks:
            self._refs[b] = 1
        self._peak_in_use = max(self._peak_in_use, len(self._in_use))
        return blocks

    def share(self, blocks):
        """Grant one additional reference to each of ``blocks``.  Every
        block must already be allocated — sharing a free block would
        resurrect contents the pool no longer guarantees."""
        for b in blocks:
            if b not in self._in_use:
                raise MXNetError(f"cannot share free block {b}")
        for b in blocks:
            self._refs[b] += 1
        self._peak_shared = max(self._peak_shared, self.shared_blocks)

    def release(self, blocks):
        """Drop one reference from each of ``blocks``; a block returns
        to the free list only when its last holder lets go.  Unknown /
        already-free ids raise (the no-double-assignment invariant's
        enforcement edge, unchanged from the pre-refcount ``free``)."""
        for b in blocks:
            if b not in self._in_use:
                raise MXNetError(f"block {b} is not allocated")
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._in_use.discard(b)
                self._free.append(b)

    def free(self, blocks):
        """Historical name for :meth:`release` (identical semantics for
        refcount-1 blocks, which is every block before r19)."""
        self.release(blocks)

    def check(self):
        free = set(self._free)
        if len(free) != len(self._free):
            raise MXNetError("duplicate ids on the free list")
        if free & self._in_use:
            raise MXNetError(
                f"blocks both free and in use: {free & self._in_use}")
        if free | self._in_use != set(range(self.num_blocks)):
            raise MXNetError("block pool lost track of blocks")
        if set(self._refs) != self._in_use:
            raise MXNetError("refcount table does not match the in-use "
                             "set")
        bad = [b for b, c in self._refs.items() if c < 1]
        if bad:
            raise MXNetError(f"allocated blocks with refcount < 1: {bad}")
        return True


class KVCacheManager:
    """Fixed-capacity slot ledger (``num_slots`` concurrent sequences),
    each slot owning a full ``max_len`` cache row."""

    def __init__(self, num_slots, max_len):
        if num_slots < 1:
            raise MXNetError("num_slots must be >= 1")
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self._free = list(range(self.num_slots - 1, -1, -1))  # pop() -> 0 first
        self._active = {}           # slot -> SlotState
        self._admits = 0
        self._evictions = 0
        self._peak_occupancy = 0
        self._peak_tokens = 0

    # -- queries --------------------------------------------------------------
    def free_slots(self):
        return len(self._free)

    def active_slots(self):
        """Occupied slot ids, ascending."""
        return sorted(self._active)

    def state(self, slot):
        return self._active[slot]

    def tokens_in_flight(self):
        """K/V rows live right now = sum of active write positions."""
        return sum(st.pos for st in self._active.values())

    def stats(self):
        """Occupancy counters plus the r11 capacity metrics: the slot
        ledger reserves ``max_len`` rows for every OCCUPIED slot, so its
        ``fragmentation`` is the fraction of those reservations holding
        no live token — the number the paged pool exists to shrink."""
        reserved = len(self._active) * self.max_len
        live = self.tokens_in_flight()
        cap = self.num_slots * self.max_len
        return {"admits": self._admits, "evictions": self._evictions,
                "occupancy": len(self._active),
                "peak_occupancy": self._peak_occupancy,
                "num_slots": self.num_slots,
                "capacity_tokens": cap,
                "tokens_in_flight": int(live),
                "peak_tokens": int(self._peak_tokens),
                "utilization": round(live / cap, 4) if cap else 0.0,
                "fragmentation": round(1.0 - live / reserved, 4)
                if reserved else 0.0}

    # -- transitions ----------------------------------------------------------
    def admit(self, request_id, prompt_len, max_new_tokens, step=0):
        """Claim a slot for a prefilled request: position starts at
        ``prompt_len`` (the first decode write lands there).  Returns
        the slot id, or None when the cache is at capacity."""
        if prompt_len + max_new_tokens > self.max_len:
            raise MXNetError(
                f"sequence budget {prompt_len}+{max_new_tokens} exceeds "
                f"cache max_len {self.max_len}")
        if not self._free:
            return None
        slot = self._free.pop()
        self._active[slot] = SlotState(request_id, prompt_len,
                                       max_new_tokens, step)
        self._admits += 1
        self._peak_occupancy = max(self._peak_occupancy, len(self._active))
        self._peak_tokens = max(self._peak_tokens, self.tokens_in_flight())
        return slot

    def advance(self, slot):
        """One decode step wrote ``slot``'s K/V at its current position:
        bump the write cursor.  (The prefill-produced first token never
        advances — its K/V lands with the next step's write.)"""
        st = self._active[slot]
        st.pos += 1
        if st.pos > self.max_len:
            raise MXNetError(f"slot {slot} overran max_len {self.max_len}")
        self._peak_tokens = max(self._peak_tokens, self.tokens_in_flight())

    def consume(self, slot):
        """One output token was emitted for ``slot``'s request.  Returns
        True when the token budget is exhausted (caller evicts)."""
        st = self._active[slot]
        st.remaining -= 1
        return st.remaining <= 0

    def evict(self, slot):
        """Release ``slot`` back to the free list."""
        if slot not in self._active:
            raise MXNetError(f"slot {slot} is not active")
        del self._active[slot]
        self._free.append(slot)
        self._evictions += 1

    def check(self):
        """Assert the ledger invariants (used by tests and debug)."""
        free = set(self._free)
        active = set(self._active)
        if free & active:
            raise MXNetError(f"slots both free and active: {free & active}")
        if free | active != set(range(self.num_slots)):
            raise MXNetError("slot ledger lost track of slots")
        for slot, st in self._active.items():
            if not 0 <= st.pos <= self.max_len:
                raise MXNetError(f"slot {slot} position {st.pos} out of "
                                 f"range [0, {self.max_len}]")
        return True


class PagedKVCacheManager:
    """Block-pool ledger: slots are still the decode batch rows (the
    step program's shape), but K/V capacity comes from a shared
    :class:`BlockAllocator` — a request is admitted only when BOTH a
    slot and its whole block list (``ceil((prompt + budget) /
    block_size)`` blocks) are available.  All transitions are
    lock-serialized: the prefill lane admits while the decode lane
    advances and evicts."""

    def __init__(self, num_slots, max_len, num_blocks, block_size):
        if num_slots < 1:
            raise MXNetError("num_slots must be >= 1")
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.block_size = int(block_size)
        self.allocator = BlockAllocator(num_blocks, block_size)
        self.num_blocks = self.allocator.num_blocks
        #: static per-slot block-table width: the step program gathers
        #: this many blocks per slot whatever the request actually owns
        self.max_blocks = -(-self.max_len // self.block_size)
        self._free = list(range(self.num_slots - 1, -1, -1))
        self._active = {}
        self._admits = 0
        self._evictions = 0
        self._peak_occupancy = 0
        self._peak_tokens = 0
        self._lock = threading.RLock()
        #: optional :class:`~mxnet_tpu.serving.radix.RadixPrefixCache`
        #: holding its own references on cached prefix blocks; consulted
        #: by ``check()`` so the refcount invariant covers cache-held
        #: blocks too.
        self.prefix_cache = None

    # -- queries --------------------------------------------------------------
    def blocks_for(self, prompt_len, max_new_tokens):
        """Blocks a request needs for its whole lifetime (prompt rows +
        every decode write), allocated up front at admit so a running
        sequence can never stall mid-decode on pool exhaustion."""
        return -(-(prompt_len + max_new_tokens) // self.block_size)

    def can_admit(self, prompt_len, max_new_tokens):
        with self._lock:
            return bool(self._free) and \
                self.blocks_for(prompt_len, max_new_tokens) \
                <= self.allocator.free_blocks

    def free_slots(self):
        with self._lock:
            return len(self._free)

    def active_slots(self):
        with self._lock:
            return sorted(self._active)

    def state(self, slot):
        return self._active[slot]

    def tokens_in_flight(self):
        with self._lock:
            return sum(st.pos for st in self._active.values())

    def _holders(self):
        """block id -> number of active block lists containing it
        (callers hold the lock)."""
        holders = {}
        for st in self._active.values():
            for b in st.blocks:
                holders[b] = holders.get(b, 0) + 1
        return holders

    def reserved_tokens(self):
        """Token capacity reserved by active requests, counting each
        shared prefix block's capacity ONCE — the pool only spends one
        block however many requests read it."""
        with self._lock:
            total = sum(st.reserved for st in self._active.values())
            over = sum((c - 1) * self.block_size
                       for c in self._holders().values() if c > 1)
            return total - over

    def stats(self):
        """Slot counters plus pool metrics.  ``fragmentation`` here is
        *internal*: the fraction of allocated block capacity not yet
        holding a live token (tail of each request's last block + the
        decode budget allocated ahead of the write cursor)."""
        with self._lock:
            live = sum(st.pos for st in self._active.values())
            # shared prefix blocks store their rows ONCE however many
            # slots read them: subtract the duplicate holders' share so
            # utilization / fragmentation describe physical rows.
            over = sum((c - 1) * self.block_size
                       for c in self._holders().values() if c > 1)
            live_unique = live - over
            used = self.allocator.blocks_in_use
            alloc_cap = used * self.block_size
            cap = self.num_blocks * self.block_size
            return {
                "admits": self._admits, "evictions": self._evictions,
                "occupancy": len(self._active),
                "peak_occupancy": self._peak_occupancy,
                "num_slots": self.num_slots,
                "num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "blocks_in_use": used,
                "peak_blocks_in_use": self.allocator.peak_blocks_in_use,
                "shared_blocks": self.allocator.shared_blocks,
                "peak_shared_blocks": self.allocator.peak_shared_blocks,
                "capacity_tokens": cap,
                "tokens_in_flight": int(live_unique),
                "reserved_tokens": int(self.reserved_tokens()),
                "peak_tokens": int(self._peak_tokens),
                "utilization": round(live_unique / cap, 4) if cap
                else 0.0,
                "fragmentation": round(1.0 - live_unique / alloc_cap, 4)
                if alloc_cap else 0.0,
            }

    # -- transitions ----------------------------------------------------------
    def admit(self, request_id, prompt_len, max_new_tokens, step=0,
              shared_blocks=None):
        """Claim a slot AND the request's full block list.  Returns
        ``(slot, blocks)`` or None when either is unavailable (the
        request stays queued).

        ``shared_blocks`` (r19): already-allocated prefix blocks the
        request will read instead of prefilling — the radix cache's
        lookup result, in logical order, covering whole leading blocks
        of the prompt.  They are ``share()``d (the request's own
        reference) and only the remainder of the block list is freshly
        allocated; on admit failure no references are taken."""
        if prompt_len + max_new_tokens > self.max_len:
            raise MXNetError(
                f"sequence budget {prompt_len}+{max_new_tokens} exceeds "
                f"cache max_len {self.max_len}")
        shared = list(shared_blocks) if shared_blocks else []
        need = self.blocks_for(prompt_len, max_new_tokens) - len(shared)
        if need < 0:
            raise MXNetError(
                f"{len(shared)} shared prefix blocks exceed the "
                f"request's {self.blocks_for(prompt_len, max_new_tokens)}"
                "-block budget")
        with self._lock:
            if not self._free:
                return None
            fresh = self.allocator.alloc(need)
            if fresh is None:
                return None
            if shared:
                self.allocator.share(shared)
            blocks = shared + fresh
            slot = self._free.pop()
            self._active[slot] = SlotState(
                request_id, prompt_len, max_new_tokens, step,
                blocks=blocks, reserved=prompt_len + max_new_tokens)
            self._admits += 1
            self._peak_occupancy = max(self._peak_occupancy,
                                       len(self._active))
            self._peak_tokens = max(
                self._peak_tokens,
                sum(st.pos for st in self._active.values()))
            return slot, blocks

    def advance(self, slot):
        with self._lock:
            st = self._active[slot]
            st.pos += 1
            if st.pos > st.reserved:
                raise MXNetError(
                    f"slot {slot} overran its reserved {st.reserved} "
                    "tokens")
            self._peak_tokens = max(
                self._peak_tokens,
                sum(s.pos for s in self._active.values()))

    def advance_n(self, slot, n):
        """``n`` decode/verify writes landed for ``slot`` in one
        dispatch (the k-token verify forward): bump the cursor by ``n``.
        The caller rolls back any rejected suffix with
        :meth:`truncate`."""
        if n < 0:
            raise MXNetError(f"cannot advance by {n}")
        with self._lock:
            st = self._active[slot]
            st.pos += int(n)
            if st.pos > st.reserved:
                raise MXNetError(
                    f"slot {slot} overran its reserved {st.reserved} "
                    "tokens")
            self._peak_tokens = max(
                self._peak_tokens,
                sum(s.pos for s in self._active.values()))

    def truncate(self, slot, pos):
        """Roll ``slot``'s write cursor back to ``pos`` (speculative
        rejection, or an early stop releasing unused budget).  The
        reservation shrinks to what the sequence can still need
        (``pos + remaining``) and whole blocks past the new reservation
        return to the pool; returns the released block ids.

        No device-side cleanup happens: rejected rows sit beyond the
        causal mask (``t <= pos``) until the next verify/decode write
        overwrites them — the same stale-row invariant that lets a
        fresh block skip zeroing."""
        with self._lock:
            st = self._active[slot]
            if not 0 <= pos <= st.pos:
                raise MXNetError(
                    f"truncate target {pos} outside [0, {st.pos}] for "
                    f"slot {slot}")
            st.pos = int(pos)
            st.reserved = min(st.reserved,
                              st.pos + max(int(st.remaining), 0))
            need = max(-(-st.reserved // self.block_size), 0)
            released = st.blocks[need:]
            if released:
                st.blocks = st.blocks[:need]
                self.allocator.release(released)
            return released

    def consume(self, slot):
        with self._lock:
            st = self._active[slot]
            st.remaining -= 1
            return st.remaining <= 0

    def evict(self, slot):
        """Release the slot and drop the request's reference on every
        block it held; blocks shared with the radix cache or another
        request stay allocated for the remaining holders."""
        with self._lock:
            if slot not in self._active:
                raise MXNetError(f"slot {slot} is not active")
            st = self._active.pop(slot)
            self.allocator.release(st.blocks)
            self._free.append(slot)
            self._evictions += 1
            return st.blocks

    def check(self):
        """Slot invariants + block invariants.  Since r19 block lists
        may overlap on shared prefix blocks, so the partition check
        becomes a refcount check: every allocated block's holder count
        must equal the number of active block lists containing it plus
        one if the radix prefix cache holds it, and the union of all
        holders must cover the allocator's in-use set exactly."""
        with self._lock:
            free = set(self._free)
            active = set(self._active)
            if free & active:
                raise MXNetError(
                    f"slots both free and active: {free & active}")
            if free | active != set(range(self.num_slots)):
                raise MXNetError("slot ledger lost track of slots")
            for slot, st in self._active.items():
                if not 0 <= st.pos <= st.reserved <= self.max_len:
                    raise MXNetError(
                        f"slot {slot} pos {st.pos} / reserved "
                        f"{st.reserved} out of range")
                if len(st.blocks) * self.block_size < st.reserved:
                    raise MXNetError(
                        f"slot {slot} blocks cover "
                        f"{len(st.blocks) * self.block_size} < reserved "
                        f"{st.reserved} tokens")
                if len(st.blocks) != len(set(st.blocks)):
                    raise MXNetError(
                        f"slot {slot} lists a block twice")
            holders = self._holders()
            cached = (self.prefix_cache.block_refs()
                      if self.prefix_cache is not None else {})
            union = set(holders) | set(cached)
            if union != self.allocator._in_use:
                raise MXNetError(
                    "active block lists + cached prefixes do not match "
                    "the allocator's in-use set")
            for b in union:
                want = holders.get(b, 0) + cached.get(b, 0)
                have = self.allocator.refcount(b)
                if have != want:
                    raise MXNetError(
                        f"block {b} refcount {have} != {want} holders "
                        f"({holders.get(b, 0)} slots + "
                        f"{cached.get(b, 0)} cached)")
            self.allocator.check()
            return True
