"""Paged KV cache: fixed-size blocks in one preallocated device pool
(counterpart of ``paddle_tpu/inference/serving/kv_cache.py``).

Every request keeps its K/V in fixed-size *blocks* drawn from one pool
``[L, 2, num_blocks, block_size, H, Dh]`` (axis 1 = K/V).  The
per-request layout lives in an integer page table, which is data, so
requests joining and leaving the batch never change a shape.

- ``BlockAllocator`` (host): free list, best-fit contiguous
  allocation, and the worst-case *reservation* accounting that
  admission control uses so an admitted request can never run the
  pool dry mid-decode.
- ``PagedKVCache``: owns the pool tensor on the engine's device.
- pool ops (``write_prompt_pages(_group)``, ``paged_append``,
  ``gather_pages``).  Unlike the JAX package, which donates the pool
  and adopts a new array from every step, the port updates the pool
  **in place**: the write ops return nothing and the one pool tensor
  lives for the engine's lifetime.

Block 0 is the scratch block: never allocated, it absorbs every masked
write (inactive slot, bucket-padding tail), and nothing reads it
because attention masks by length.  Duplicate scratch indices in one
scatter make that scatter order-dependent only inside scratch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

#: block id that absorbs masked writes; never allocated, never read
SCRATCH_BLOCK = 0


class OutOfBlocks(RuntimeError):
    """The pool cannot satisfy an allocation (admission-control bug or
    an un-reserved caller)."""


class BlockAllocator:
    """Free-list allocator over the block pool (host side).

    ``allocate(n)`` takes the smallest contiguous free run that fits
    (best fit), else scattered lowest-index-first blocks.
    ``reserve``/``release`` account every admitted request's worst-case
    need without allocating; ``allocate`` then draws lazily and cannot
    fail for a request that holds a reservation.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is scratch)")
        self._free = list(range(1, num_blocks))    # block 0 = scratch
        self._allocated: set = set()
        self.capacity = num_blocks - 1
        self._reserved = 0

    @property
    def reserved(self) -> int:
        return self._reserved

    def can_reserve(self, n: int) -> bool:
        return self._reserved + int(n) <= self.capacity

    def reserve(self, n: int) -> bool:
        if not self.can_reserve(n):
            return False
        self._reserved += int(n)
        return True

    def release(self, n: int):
        if int(n) > self._reserved:
            raise ValueError("release() without matching reserve()")
        self._reserved -= int(n)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        return len(self._allocated)

    def _runs(self) -> List[List[int]]:
        """Maximal contiguous runs of the (sorted) free list."""
        runs: List[List[int]] = []
        for b in self._free:
            if runs and runs[-1][-1] == b - 1:
                runs[-1].append(b)
            else:
                runs.append([b])
        return runs

    def allocate(self, n: int) -> List[int]:
        """n block ids — contiguous best-fit, else scattered
        lowest-first.  Raises :class:`OutOfBlocks` when the pool cannot
        satisfy it."""
        n = int(n)
        if n <= 0:
            return []
        if n > len(self._free):
            raise OutOfBlocks(
                f"allocate({n}): only {len(self._free)} free blocks "
                f"(capacity {self.capacity}, reserved {self._reserved})")
        best: Optional[List[int]] = None
        for run in self._runs():
            if len(run) >= n and (best is None or len(run) < len(best)):
                best = run
        got = best[:n] if best is not None else self._free[:n]
        got_set = set(got)
        self._free = [b for b in self._free if b not in got_set]
        self._allocated |= got_set
        return got

    def free(self, blocks: Sequence[int]):
        blocks = [int(b) for b in blocks]
        for b in blocks:
            if b not in self._allocated:
                raise ValueError(f"free({b}): block is not allocated")
            self._allocated.discard(b)
        self._free = sorted(set(self._free) | set(blocks))

    def stats(self) -> Dict[str, float]:
        runs = self._runs()
        largest = max((len(r) for r in runs), default=0)
        free = len(self._free)
        return {
            "capacity": self.capacity,
            "free": free,
            "allocated": len(self._allocated),
            "reserved": self._reserved,
            "free_runs": len(runs),
            "largest_run": largest,
            # 0.0 = one contiguous run (or empty), -> 1.0 = scattered
            "fragmentation": (1.0 - largest / free) if free else 0.0,
        }


class PageTable:
    """Per-request block list + length (host bookkeeping)."""

    __slots__ = ("blocks", "length")

    def __init__(self):
        self.blocks: List[int] = []
        self.length = 0


class PagedKVCache:
    """The device pool + block allocator for one serving engine.

    ``pool``: ``[num_layers, 2, num_blocks, block_size, heads,
    head_dim]`` zero-initialised on ``device``, written in place by the
    pool ops below.
    """

    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 num_heads: int, head_dim: int, *,
                 dtype=torch.float32, device):
        self.num_layers = int(num_layers)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.pool = torch.zeros(
            (num_layers, 2, num_blocks, block_size, num_heads, head_dim),
            dtype=dtype, device=device)
        self.allocator = BlockAllocator(num_blocks)

    def blocks_for_tokens(self, n_tokens: int) -> int:
        """Pages covering ``n_tokens`` positions."""
        return -(-int(n_tokens) // self.block_size)


# ---------------------------------------------------------------------------
# pool ops (in place)
# ---------------------------------------------------------------------------
def write_prompt_pages(pool, kv, block_ids):
    """Scatter one prefill's K/V into its pages, in place.

    ``kv``: ``[L, 2, Lb, H, Dh]`` with ``Lb = len(block_ids) *
    block_size``; ``block_ids`` ``[nb]`` int (tail entries past the
    prompt's real blocks are SCRATCH_BLOCK).
    """
    write_prompt_pages_group(pool, kv[:, :, None], block_ids[None])


def write_prompt_pages_group(pool, kv, block_ids):
    """Grouped :func:`write_prompt_pages`: one scatter for a whole
    same-bucket prefill group, in place.

    ``kv``: ``[L, 2, G, Lb, H, Dh]``; ``block_ids`` ``[G, nb]`` int
    (dummy group rows and padding tails point at SCRATCH_BLOCK).
    """
    L, two, G, Lb, H, Dh = kv.shape
    nb = block_ids.shape[1]
    bs = Lb // nb
    pool[:, :, block_ids.long()] = kv.reshape(L, two, G, nb, bs, H, Dh
                                              ).to(pool.dtype)


def paged_append(pool, layer, k_new, v_new, block_ids, offsets):
    """Write one decode token's K/V per request into its current page,
    in place.  ``k_new``/``v_new`` ``[B, H, Dh]``; ``block_ids``/
    ``offsets`` ``[B]`` int (masked rows target SCRATCH_BLOCK)."""
    blk, off = block_ids.long(), offsets.long()
    pool[layer, 0, blk, off] = k_new.to(pool.dtype)
    pool[layer, 1, blk, off] = v_new.to(pool.dtype)


def gather_pages(pool, layer, page_table):
    """Page-table gather → per-request contiguous K/V copies.

    ``page_table`` ``[B, max_blocks]`` int → ``(k, v)`` each
    ``[B, max_blocks * block_size, H, Dh]``.  Unused table entries are
    SCRATCH_BLOCK; whatever they gather is masked by length.
    """
    idx = page_table.long()
    k = pool[layer, 0][idx]                 # [B, nb, bs, H, Dh]
    v = pool[layer, 1][idx]
    B, nb, bs, H, Dh = k.shape
    return (k.reshape(B, nb * bs, H, Dh), v.reshape(B, nb * bs, H, Dh))
