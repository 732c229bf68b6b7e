"""Radix prefix cache: shared-prefix KV reuse over the paged pool.

Counterpart of ``mxnet_tpu/serving/radix.py`` (the port keeps its own
copy).

The chat / RAG serving scenario sends thousands of requests that open
with the same system prompt.  Without reuse every one of them prefills
the same tokens into its own freshly allocated blocks.  This module
keeps a **trie over block-aligned prompt prefixes** (SGLang's
RadixAttention idea, at block granularity): each trie node represents
one full ``block_size``-token chunk and pins the physical paged block
holding that chunk's K/V.  A new request walks the trie over its prompt,
adopts the matched blocks by reference (``BlockAllocator.share``), and
only prefills the novel suffix.

Design points:

* **Block granularity.** Matching is in whole-block units — a physical
  block either exactly holds a request's chunk ``[i*bs, (i+1)*bs)`` or
  it is unusable, so only full blocks enter the trie (the trailing
  partial prompt block is always prefilled by its owner).  RoPE is
  applied at absolute positions before K enters the pool, so a prefix
  block's rows are bit-identical for every request sharing the prefix.
* **At least one novel token.** ``match_len`` caps the match at
  ``(prompt_len - 1)`` rounded down to a block boundary: the suffix
  prefill must process ≥ 1 real token to produce first-token logits.
* **Write-safety.** Cached blocks hold *full prompt chunks* only.  A
  request's decode/verify writes start at ``pos >= prompt_len``, which
  lies strictly past its last full prompt block, so no shared block is
  ever written — sharing is read-only by construction (no
  copy-on-write needed).
* **Refcounts, not copies.** The cache holds ONE allocator reference
  per cached block; every adopting request holds its own (taken by
  ``PagedKVCacheManager.admit(shared_blocks=...)``).  LRU eviction
  drops the cache's reference; a block still read by an active request
  survives until that request evicts (evict-while-shared is safe).
* **LRU under a token budget.**  ``insert`` registers a finished
  prefill's full prompt blocks and then evicts least-recently-matched
  *leaf* chunks until ``cached_tokens <= capacity_tokens`` (leaves
  first so every cached node stays reachable from the root).

The cache is per-replica (blocks are physical ids in the replica's own
pool).  Only the prefill lane mutates it, but all entry points take the
internal lock so ``stats()`` / ``check()`` readers from other threads
see a consistent trie.
"""
from __future__ import annotations

import itertools
import threading

from ..base import MXNetError

__all__ = ["RadixPrefixCache"]


class _Node:
    """One cached full-block chunk; children keyed by the next chunk's
    token tuple."""

    __slots__ = ("chunk", "block", "tick", "parent", "children")

    def __init__(self, chunk, block, tick, parent):
        self.chunk = chunk          # tuple of block_size token ids
        self.block = block          # physical block id (cache's ref)
        self.tick = tick            # LRU stamp, bumped on every match
        self.parent = parent
        self.children = {}


class RadixPrefixCache:
    """Trie from block-aligned prompt prefixes to refcounted paged KV
    blocks."""

    def __init__(self, allocator, block_size, capacity_tokens):
        if capacity_tokens < 0:
            raise MXNetError("capacity_tokens must be >= 0")
        self.allocator = allocator
        self.block_size = int(block_size)
        self.capacity_tokens = int(capacity_tokens)
        self._root = _Node(None, None, 0, None)
        self._nodes = 0
        self._tick = itertools.count(1)
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evictions = 0
        self.inserted_blocks = 0

    # -- queries --------------------------------------------------------------
    def _chunks(self, prompt_ids, limit):
        bs = self.block_size
        n = min(len(prompt_ids), limit) // bs
        return [tuple(int(t) for t in prompt_ids[i * bs:(i + 1) * bs])
                for i in range(n)]

    def _match_cap(self, prompt_ids):
        """Longest usable match in tokens: whole blocks only, and at
        least one prompt token left novel."""
        bs = self.block_size
        return max(len(prompt_ids) - 1, 0) // bs * bs

    def _walk(self, prompt_ids):
        """(nodes, matched_tokens) for the longest cached prefix."""
        node, path = self._root, []
        for chunk in self._chunks(prompt_ids,
                                  self._match_cap(prompt_ids)):
            nxt = node.children.get(chunk)
            if nxt is None:
                break
            path.append(nxt)
            node = nxt
        return path, len(path) * self.block_size

    def match_len(self, prompt_ids):
        """Matched prefix length in tokens WITHOUT touching LRU state —
        safe for batching/bucketing decisions ahead of the real
        :meth:`lookup`."""
        with self._lock:
            return self._walk(prompt_ids)[1]

    def lookup(self, prompt_ids):
        """Longest cached prefix of ``prompt_ids``: returns
        ``(matched_tokens, blocks)`` (logical order) and freshens the
        matched path's LRU stamps.  No references are taken — the
        caller passes ``blocks`` to ``admit(shared_blocks=...)``, which
        shares them under the manager lock."""
        with self._lock:
            path, matched = self._walk(prompt_ids)
            for node in path:
                node.tick = next(self._tick)
            if matched:
                self.hits += 1
                self.hit_tokens += matched
            else:
                self.misses += 1
            return matched, [n.block for n in path]

    def cached_tokens(self):
        with self._lock:
            return self._nodes * self.block_size

    def block_refs(self):
        """block id -> 1 for every block the cache holds a reference
        on (consumed by ``PagedKVCacheManager.check()``)."""
        with self._lock:
            out = {}
            stack = list(self._root.children.values())
            while stack:
                node = stack.pop()
                out[node.block] = 1
                stack.extend(node.children.values())
            return out

    def stats(self):
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "hit_tokens": self.hit_tokens,
                    "evictions": self.evictions,
                    "inserted_blocks": self.inserted_blocks,
                    "nodes": self._nodes,
                    "cached_tokens": self._nodes * self.block_size,
                    "capacity_tokens": self.capacity_tokens}

    # -- mutations ------------------------------------------------------------
    def insert(self, prompt_ids, blocks):
        """Register a just-prefilled request's full prompt blocks.

        ``blocks`` is the request's block list in logical order
        (``blocks[i]`` physically holds tokens ``[i*bs, (i+1)*bs)``);
        chunks already cached are skipped (their physical block is the
        one the request adopted at lookup), new chunks pin their block
        with a fresh cache-owned reference.  Ends by LRU-evicting down
        to the token budget."""
        with self._lock:
            node = self._root
            cap = self._match_cap(prompt_ids)
            for i, chunk in enumerate(self._chunks(prompt_ids, cap)):
                nxt = node.children.get(chunk)
                if nxt is None:
                    if i >= len(blocks):
                        raise MXNetError(
                            "block list shorter than the prompt's full "
                            "blocks")
                    self.allocator.share([blocks[i]])
                    nxt = _Node(chunk, blocks[i], next(self._tick),
                                node)
                    node.children[chunk] = nxt
                    self._nodes += 1
                    self.inserted_blocks += 1
                else:
                    nxt.tick = next(self._tick)
                node = nxt
            self._evict_to_budget()

    def _evict_to_budget(self):
        while self._nodes * self.block_size > self.capacity_tokens:
            leaf = None
            stack = list(self._root.children.values())
            while stack:
                node = stack.pop()
                if node.children:
                    stack.extend(node.children.values())
                elif leaf is None or node.tick < leaf.tick:
                    leaf = node
            if leaf is None:
                break
            del leaf.parent.children[leaf.chunk]
            self.allocator.release([leaf.block])
            self._nodes -= 1
            self.evictions += 1

    def clear(self):
        """Drop every cached prefix (releases all cache-held refs)."""
        with self._lock:
            stack = list(self._root.children.values())
            self._root.children = {}
            while stack:
                node = stack.pop()
                self.allocator.release([node.block])
                self.evictions += 1
                stack.extend(node.children.values())
            self._nodes = 0
