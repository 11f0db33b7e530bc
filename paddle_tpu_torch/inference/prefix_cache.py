"""Copy-on-write prefix caching over refcounted KV pages (counterpart of
``paddle_tpu/inference/prefix_cache.py``, whose names and rules it keeps).

A hash table at page granularity: for every full page of a finished
prefill the engine registers ``digest(prompt[:end]) -> page`` (the key
hashes the whole token prefix up to that page's end, so a chain of hits is
exact in position).  An admitted request walks its own prompt's chain;
every consecutive hit is shared into its block table
(``PagedKVCache.share_blocks``) and only the suffix is prefilled.  The
table holds its own reference on each registered page, so a cached prefix
outlives the request that wrote it.

Copy-on-write: a hit that covers the WHOLE prompt is cut one token short
(the last position re-runs to give the first sampled token), so its write
lands in the last shared page; the engine copies that page to a private
one (``jit/serving_step.copy_block``) first.  Shared pages are never
written.

Eviction honors refcounts: only entries whose page has no other holder
(refcount 1, the table's own) are dropped, least recently touched first;
entries passed over because a live request holds their page are counted
(``skipped_pinned``).

Host-RAM spill tier: with a :class:`HostPageTier` attached, evicted pages
are first serialized to a byte-capped host LRU in ONE batched
device-to-host copy per dtype (``jit/serving_step.extract_blocks``); a
later ``match`` whose device chain breaks continues into the tier and
restores every consecutive spilled page with ONE ``inject_blocks``, under
the same digest chain.  Restores never evict: they take only free pages.

Under a tp or ep mesh the table, refcounts and free list live on rank 0
alone (the driver's scheduler): they are host state, and every rank's
pools hold the same page ids.  The one page operation that touches the
pools, the copy-on-write copy, goes to every rank in rank 0's order
(``ContinuousBatchingEngine._copy_block``: one control broadcast, then
the copy on each rank's shard); without it the head-sharded pools drift
apart.  The host tier moves whole pages and is refused under a mesh, as
in the reference.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, Optional, Set

import numpy as np

__all__ = ["PrefixPageCache", "HostPageTier"]


def _prefix_key(prompt_ids: np.ndarray, end: int) -> bytes:
    return hashlib.blake2b(
        np.ascontiguousarray(prompt_ids[:end], dtype=np.int64).tobytes(),
        digest_size=16).digest()


class HostPageTier:
    """Bounded host-RAM LRU of spilled prefix pages: digest key → a
    1-page :class:`~paddle_tpu_torch.ops.paged_attention.KVPageBuffer`.
    Byte-capped (``capacity_bytes``), oldest-touch evicted — the spill
    tier is a cache of a cache, so dropping an entry is always safe."""

    def __init__(self, capacity_bytes: int):
        self.capacity_bytes = int(capacity_bytes)
        self.entries: "OrderedDict[bytes, object]" = OrderedDict()
        self.bytes = 0
        # spilled-then-aged-out entries (distinct from device eviction)
        self.tier_evictions = 0

    def put(self, key: bytes, buf) -> bool:
        """Insert/replace one spilled page; evicts LRU entries until
        the tier fits its byte cap.  Returns False (and stores
        nothing) when the single entry alone exceeds the cap."""
        if buf.nbytes > self.capacity_bytes:
            return False
        old = self.entries.pop(key, None)
        if old is not None:
            self.bytes -= old.nbytes
        self.entries[key] = buf
        self.bytes += buf.nbytes
        while self.bytes > self.capacity_bytes and self.entries:
            _k, dropped = self.entries.popitem(last=False)
            self.bytes -= dropped.nbytes
            self.tier_evictions += 1
        return True

    def get(self, key: bytes):
        buf = self.entries.get(key)
        if buf is not None:
            self.entries.move_to_end(key)
        return buf

    def pop(self, key: bytes):
        buf = self.entries.pop(key, None)
        if buf is not None:
            self.bytes -= buf.nbytes
        return buf

    def __contains__(self, key: bytes) -> bool:
        return key in self.entries

    def __len__(self) -> int:
        return len(self.entries)


class PrefixPageCache:
    """Block-granularity prompt-prefix table over one ``PagedKVCache``
    free-list authority (the engine's layer-0 cache: block ids are
    shared across layers).

    ``all_caches`` is the engine's full per-layer cache list: with a
    ``host_tier`` attached, eviction serializes every layer's copy of
    the dropped pages to host RAM and ``match`` restores them on a
    later hit — both as single batched transfers."""

    def __init__(self, cache, block_size: int, all_caches,
                 host_tier: Optional[HostPageTier] = None):
        self.cache = cache
        self.block_size = block_size
        self.all_caches = all_caches
        self.host_tier = host_tier
        self.table: "OrderedDict[bytes, int]" = OrderedDict()
        self._registered: Set[int] = set()   # block ids the table refs
        # host-side stats: the record of the cache's work (the engine
        # publishes their increments into its metrics)
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evictions = 0
        self.skipped_pinned = 0     # evict() passes over a pinned entry
        self.spills = 0             # pages serialized to the host tier
        self.host_hits = 0          # lookups that found a spilled page
        self.restores = 0           # spilled pages injected back

    # ---- lookup ---------------------------------------------------------
    def match(self, prompt_ids: np.ndarray) -> List[int]:
        """Longest consecutive chain of cached full-page prefixes of
        ``prompt_ids``.  With a host tier attached, a chain that breaks on the device table continues into the
        spill tier: every consecutive spilled page is restored with ONE
        batched inject and re-registered — bounded by the free list
        (restores never evict).  Otherwise side-effect free except LRU
        touch; the caller decides whether to commit (share_blocks) the
        hit."""
        bs = self.block_size
        prompt_ids = np.asarray(prompt_ids)
        blocks: List[int] = []
        n_full = len(prompt_ids) // bs
        for i in range(n_full):
            key = _prefix_key(prompt_ids, (i + 1) * bs)
            b = self.table.get(key)
            if b is None:
                break
            self.table.move_to_end(key)
            blocks.append(b)
        if self.host_tier is not None:
            blocks.extend(
                self._restore_chain(prompt_ids, len(blocks), n_full))
        return blocks

    def _restore_chain(self, prompt_ids, start: int,
                       n_full: int) -> List[int]:
        """Continue a broken device chain out of the host tier: probe
        keys ``start..``, restore every consecutive hit (capped by the
        free list) with one ``inject_blocks`` dispatch, re-register
        each page under its digest (the table takes the allocated
        reference, exactly like a registered page)."""
        bs = self.block_size
        pending = []
        for i in range(start, n_full):
            key = _prefix_key(prompt_ids, (i + 1) * bs)
            ent = self.host_tier.get(key)
            if ent is None:
                break
            pending.append((key, ent))
        if not pending:
            return []
        self.host_hits += len(pending)
        # restores never evict: only already-free device pages are used
        pending = pending[:len(self.cache._free)]
        if not pending:
            return []
        from ..jit.serving_step import inject_blocks
        from ..ops.paged_attention import KVPageBuffer
        first = pending[0][1]
        combined = KVPageBuffer(
            codes=np.concatenate([e.codes for _, e in pending], axis=1),
            scales=(np.concatenate([e.scales for _, e in pending],
                                   axis=1)
                    if first.scales is not None else None),
            n_pages=len(pending),
            n_tokens=len(pending) * self.block_size,
            block_size=first.block_size,
            num_kv_heads=first.num_kv_heads, head_dim=first.head_dim,
            num_layers=first.num_layers, kv_dtype=first.kv_dtype)
        dest = [self.cache.allocate_block() for _ in pending]
        inject_blocks(self.all_caches, combined, dest)
        out: List[int] = []
        for (key, _ent), b in zip(pending, dest):
            self.host_tier.pop(key)
            self.table[key] = b
            self._registered.add(b)
            self.table.move_to_end(key)
            out.append(b)
        self.restores += len(pending)
        return out

    # ---- registration ---------------------------------------------------
    def register(self, prompt_ids: np.ndarray, block_ids: List[int]):
        """Publish a freshly prefilled prompt's FULL pages.  Keys already
        present keep their existing page (first writer wins); the table
        takes its own reference on each newly published page."""
        bs = self.block_size
        prompt_ids = np.asarray(prompt_ids)
        for i in range(len(prompt_ids) // bs):
            if i >= len(block_ids):
                break
            b = int(block_ids[i])
            key = _prefix_key(prompt_ids, (i + 1) * bs)
            if key in self.table or b in self._registered:
                continue
            self.cache.share_blocks([b])
            self.table[key] = b
            self._registered.add(b)
            self.table.move_to_end(key)

    # ---- eviction -------------------------------------------------------
    def evictable_count(self, exclude: Optional[Set[int]] = None) -> int:
        """Pages reclaimable right now: table entries no live request
        holds (refcount == 1 — the table's own reference)."""
        exclude = exclude or set()
        return sum(1 for b in self.table.values()
                   if b not in exclude and self.cache.refcount(b) == 1)

    def evict(self, n: int = 1) -> int:
        """Drop up to ``n`` LRU entries whose page has no other holder,
        returning their pages to the free list.  Entries whose page is
        still shared with a live request are SKIPPED (never reclaimed
        from under a block table) and counted in ``skipped_pinned`` —
        the engine surfaces both outcomes on the eviction counter's
        label so cache-pressure stalls are diagnosable.

        With a host tier attached, the victims' pages are serialized
        to host RAM FIRST — all of them in ONE batched device→host
        extract — then released; a later ``match`` restores them."""
        victims = []
        for key in list(self.table.keys()):
            if len(victims) >= n:
                break
            b = self.table[key]
            if self.cache.refcount(b) != 1:
                self.skipped_pinned += 1
                continue
            victims.append((key, b))
        if victims and self.host_tier is not None:
            self._spill(victims)
        for key, b in victims:
            del self.table[key]
            self._registered.discard(b)
            self.cache.free_sequence([b])
            self.evictions += 1
        return len(victims)

    def _spill(self, victims) -> None:
        """Serialize the victim pages to the host tier: ONE batched
        extract over all of them, split host-side into per-key 1-page
        entries (so any subset restores independently)."""
        from ..jit.serving_step import extract_blocks
        from ..ops.paged_attention import KVPageBuffer
        bs = self.block_size
        buf = extract_blocks(self.all_caches, [b for _, b in victims],
                             n_tokens=len(victims) * bs)
        for i, (key, _b) in enumerate(victims):
            entry = KVPageBuffer(
                codes=np.ascontiguousarray(buf.codes[:, i:i + 1]),
                scales=(np.ascontiguousarray(buf.scales[:, i:i + 1])
                        if buf.scales is not None else None),
                n_pages=1, n_tokens=bs, block_size=buf.block_size,
                num_kv_heads=buf.num_kv_heads, head_dim=buf.head_dim,
                num_layers=buf.num_layers, kv_dtype=buf.kv_dtype)
            if self.host_tier.put(key, entry):
                self.spills += 1

    # ---- introspection --------------------------------------------------
    def cached_blocks(self) -> Set[int]:
        return set(self.table.values())

    def __len__(self) -> int:
        return len(self.table)
