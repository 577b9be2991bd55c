"""Shared-prefix KV cache: block-granular prefill reuse with refcounts
(counterpart of ``paddle_tpu/inference/serving/prefix_cache.py``; host
code, copied).

Production serving traffic is system-prompt dominated: thousands of
requests open with the same instruction block, and recomputing its
K/V per request burns exactly the FLOPs a paged cache exists to keep.
This module hashes prompt prefixes to the pool blocks that already
hold their K/V, on top of the ``BlockAllocator``'s per-block
accounting:

- **Chain hashing at block granularity.**  A prompt's full blocks
  (``block_size`` tokens each) hash as a chain — entry ``i``'s key is
  ``sha256(key[i-1] || tokens[i*BS:(i+1)*BS])`` — so a hit at depth
  ``n`` certifies the *entire* ``n*BS``-token prefix matches, not just
  one block.  Absolute positions are implicit: chain depth IS the
  block's position, and identical tokens at identical positions
  produce identical K/V (position embeddings included), which is what
  makes reuse exact.
- **Ownership + refcounts.**  A cached block is owned by the cache;
  live requests whose page tables include it hold a reference.  A
  request's *exclusive* blocks (partial prompt tail, generated
  tokens) never enter the cache and free at finalize exactly as
  before.  ``refs == 0`` means "no live table points here" — the
  entry is idle, kept warm for the next hit, and evictable.
- **Leaf-first LRU eviction under pressure.**  The admission
  invariant (sum of worst-case reservations <= capacity, reservations
  deliberately NOT discounted by expected hits) guarantees that
  live-request needs always fit; idle cached blocks are the only
  overflow, and ``ensure_free`` reclaims them least-recently-used
  first, leaves before parents, so a surviving chain never has a hole
  (a hole would strand unreachable deeper entries: ``match`` walks
  from depth 0 and stops at the first miss).

The engine's single pump thread owns every call here — no locking,
same threading contract as the allocator it sits on.
"""

from __future__ import annotations

import hashlib
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from .kv_cache import BlockAllocator, OutOfBlocks


class PrefixEntry:
    """One cached block: chain key, pool block id, live references."""

    __slots__ = ("key", "parent", "block", "refs", "last_used",
                 "children")

    def __init__(self, key: bytes, parent: Optional[bytes], block: int):
        self.key = key
        self.parent = parent
        self.block = int(block)
        self.refs = 0
        self.last_used = 0
        self.children = 0        # cached (not live) child entries

    def __repr__(self):
        return (f"PrefixEntry(block={self.block}, refs={self.refs}, "
                f"children={self.children})")


def _chain_hash(prev: bytes, tokens: Sequence[int]) -> bytes:
    h = hashlib.sha256(prev)
    h.update(b"|".join(str(int(t)).encode() for t in tokens))
    return h.digest()


class PrefixCache:
    """Prefix → pool-block map with refcounts and LRU eviction.

    ``pin_referenced=True`` arms the reservation-discount admission
    mode (``DecodeEngine(prefix_reserve_discount=True)``): every entry whose
    refcount rises 0→1 pins one block on the allocator (falls 1→0
    unpins), so live-referenced cache blocks — occupied, un-evictable,
    and NOT covered by any discounted reservation — still count in
    the admission envelope.  Off (the default), admission reserves
    the full worst case and the envelope never needs the pin.
    """

    def __init__(self, allocator: BlockAllocator, block_size: int,
                 pin_referenced: bool = False):
        self._alloc = allocator
        self.block_size = int(block_size)
        self.pin_referenced = bool(pin_referenced)
        self._entries: Dict[bytes, PrefixEntry] = {}
        self._tick = itertools.count(1)
        # lifetime stats (the engine mirrors them onto the registry)
        self.hits = 0            # blocks reused from cache
        self.misses = 0          # shareable blocks computed fresh
        self.evictions = 0       # idle entries reclaimed

    def _ref(self, e: PrefixEntry):
        e.refs += 1
        if e.refs == 1 and self.pin_referenced:
            self._alloc.pin(1)

    # -- introspection -------------------------------------------------------
    @property
    def cached_blocks(self) -> int:
        return len(self._entries)

    @property
    def live_refs(self) -> int:
        return sum(e.refs for e in self._entries.values())

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {"cached_blocks": self.cached_blocks,
                "live_refs": self.live_refs,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": (self.hits / total) if total else 0.0}

    # -- lookup / acquire ----------------------------------------------------
    def shareable_blocks(self, prompt: Sequence[int]) -> int:
        """How many leading blocks of this prompt are share-eligible:
        full blocks only, and never the whole prompt — at least one
        suffix token must run through prefill so the request's first
        generated token has logits to come from."""
        return max(0, (len(prompt) - 1) // self.block_size)

    def match(self, prompt: Sequence[int], count: bool = True
              ) -> Tuple[List[PrefixEntry], bytes]:
        """Longest cached prefix of ``prompt``: returns the matched
        entries (a reference is taken on each — pair with
        :meth:`release`) and the chain hash at the match depth, which
        :meth:`insert` extends for the blocks this request computes
        itself.  Counts hits (matched) and misses (share-eligible but
        absent) on the lifetime stats; ``count=False`` defers that to
        an explicit :meth:`count_match` — the discounted-admission
        path matches speculatively at every reservation attempt and
        must not inflate the rate while a request waits at the
        door."""
        bs = self.block_size
        n = self.shareable_blocks(prompt)
        got: List[PrefixEntry] = []
        h = b""
        for i in range(n):
            nxt = _chain_hash(h, prompt[i * bs:(i + 1) * bs])
            e = self._entries.get(nxt)
            if e is None:
                break
            h = nxt
            got.append(e)
        tick = next(self._tick)
        for e in got:
            self._ref(e)
            e.last_used = tick
        if count:
            self.count_match(len(got), n - len(got))
        return got, h

    def count_match(self, hits: int, misses: int):
        """Fold one ADMITTED request's match outcome into the lifetime
        hit/miss stats (see ``match(count=False)``)."""
        self.hits += int(hits)
        self.misses += int(misses)

    # -- insert / release ----------------------------------------------------
    def insert(self, prompt: Sequence[int], start_block: int,
               chain_hash: bytes, blocks: Sequence[int]
               ) -> Tuple[List[PrefixEntry], List[int]]:
        """Register freshly prefilled full blocks, transferring their
        ownership to the cache (the caller keeps a reference on each
        new entry).  ``start_block``/``chain_hash`` come from
        :meth:`match`; ``blocks`` are the pool ids holding blocks
        ``start_block..`` of the prompt.  Returns ``(entries,
        leftover)``: entries the caller now references, and block ids
        that stay caller-owned because an identical entry already
        exists (a same-prefix race within the engine — the duplicate
        block simply frees at finalize, the table keeps pointing at
        it, contents are identical by construction)."""
        bs = self.block_size
        n = self.shareable_blocks(prompt)
        entries: List[PrefixEntry] = []
        leftover: List[int] = []
        h = chain_hash
        tick = next(self._tick)
        broken = False
        for j, block in enumerate(blocks):
            i = start_block + j
            if i >= n or broken:
                leftover.append(int(block))
                continue
            nxt = _chain_hash(h, prompt[i * bs:(i + 1) * bs])
            if nxt in self._entries:
                # duplicate chain suffix: keep ours caller-owned, and
                # stop extending (a child of OUR unregistered block
                # must not attach under the existing entry's chain)
                leftover.append(int(block))
                broken = True
                continue
            e = PrefixEntry(nxt, h if h else None, block)
            self._ref(e)
            e.last_used = tick
            self._entries[nxt] = e
            parent = self._entries.get(h) if h else None
            if parent is not None:
                parent.children += 1
            entries.append(e)
            h = nxt
        return entries, leftover

    def release(self, entries: Sequence[PrefixEntry]):
        """Drop one reference per entry (request finalize).  Entries
        stay cached at ``refs == 0`` — idle and warm — until eviction
        pressure reclaims them."""
        for e in entries:
            assert e.refs > 0, "release() without matching reference"
            e.refs -= 1
            if e.refs == 0 and self.pin_referenced:
                self._alloc.unpin(1)

    # -- eviction ------------------------------------------------------------
    def _evictable(self) -> Optional[PrefixEntry]:
        best: Optional[PrefixEntry] = None
        for e in self._entries.values():
            if e.refs > 0 or e.children > 0:
                continue
            if best is None or e.last_used < best.last_used:
                best = e
        return best

    def evict_one(self) -> Optional[int]:
        """Reclaim the least-recently-used idle *leaf* entry; returns
        the freed block id (freed back to the allocator) or None."""
        e = self._evictable()
        if e is None:
            return None
        del self._entries[e.key]
        if e.parent is not None:
            p = self._entries.get(e.parent)
            if p is not None:
                p.children -= 1
        self._alloc.free([e.block])
        self.evictions += 1
        return e.block

    def ensure_free(self, n: int):
        """Make the allocator able to satisfy ``allocate(n)`` by
        evicting idle entries.  Under reservation-gated admission this
        cannot fail for an admitted request: idle cached blocks are
        the only pool occupancy beyond the reservation envelope.  An
        un-reserved caller can still exhaust a pool whose live blocks
        cover it — that raises :class:`OutOfBlocks` exactly like the
        allocator itself would."""
        while self._alloc.num_free < int(n):
            if self.evict_one() is None:
                raise OutOfBlocks(
                    f"ensure_free({n}): {self._alloc.num_free} free, "
                    f"no idle prefix entries left to evict "
                    f"(cached={self.cached_blocks}, "
                    f"live_refs={self.live_refs})")

    def clear(self):
        """Drop every idle entry (engine teardown); entries still
        referenced by live tables are kept and reported."""
        while self.evict_one() is not None:
            pass
        return len(self._entries)
