"""Paged KV pool: block-granular refcounted cache, fixed-shape block
tables, and the radix prefix index that makes blocks shareable.

Ports ``paddle_tpu/serving/paged/pool.py``. Physical layout: one pair of
cache tensors ``kc/vc [layers, num_blocks, heads, block_size, head_dim]``
preallocated on the engine's device and updated IN PLACE by the serving
programs. That replaces the reference's buffer donation plus
``rebind``: there is one live buffer per cache for the pool's lifetime.
The int32 block table ``[num_slots, blocks_per_slot]`` maps each slot's
logical block to a physical block; it is authored on the host (numpy)
and uploaded by ``device_tables()`` only when admission or release
changed it.

Block 0 is the reserved TRASH block: free table rows and row padding
point at it, so a released slot's stale in-flight decode write lands in
garbage no reader sees.

Refcounting: ``ref[b]`` counts live slots whose row references block b.
Indexed blocks at ref 0 are EVICTABLE (kept as cache hits, reclaimed
LRU-leaf-first when the free list runs dry); unindexed blocks free at
ref 0. An admission pins its matched prefix before allocating, so it
never evicts blocks it is about to reuse.
"""
import heapq

import numpy as np
import torch

from .radix import RadixPrefixIndex

TRASH_BLOCK = 0


def upload(array, device):
    """A copy of host ``array`` on ``device``, queued without waiting for
    the card (a blocking copy would wait for every kernel queued before
    it). From pageable memory CUDA stages the bytes before the call
    returns, so the caller may edit ``array`` at once."""
    return torch.from_numpy(np.array(array)).to(device, non_blocking=True)


class PagedAllocation:
    """What ``acquire`` hands the engine: the slot, how many prompt
    tokens its pinned prefix blocks already hold, and the pinned and the
    fresh blocks of its row."""

    __slots__ = ("slot", "prefix_tokens", "prefix_blocks", "new_blocks")

    def __init__(self, slot, prefix_tokens, prefix_blocks, new_blocks):
        self.slot = slot
        self.prefix_tokens = int(prefix_tokens)
        self.prefix_blocks = list(prefix_blocks)
        self.new_blocks = list(new_blocks)


class PagedKVPool:
    """Block allocator + slot table over the paged cache tensors."""

    def __init__(self, num_slots, num_layers, num_heads, max_len,
                 head_dim, block_size=16, num_blocks=None,
                 dtype=torch.float32, device="cpu"):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_slots = int(num_slots)
        self.block_size = int(block_size)
        self.max_len = int(max_len)
        self.blocks_per_slot = -(-self.max_len // self.block_size)
        # default: every slot fully backed plus the trash block; fewer
        # blocks oversubscribe (admission waits, never corrupts)
        if num_blocks is None:
            num_blocks = self.num_slots * self.blocks_per_slot + 1
        self.num_blocks = int(num_blocks)
        if self.num_blocks < self.blocks_per_slot + 1:
            raise ValueError(
                f"num_blocks {self.num_blocks} cannot back even one "
                f"slot ({self.blocks_per_slot} blocks) plus the trash "
                "block")
        self.device = torch.device(device)
        shape = (int(num_layers), self.num_blocks, int(num_heads),
                 self.block_size, int(head_dim))
        self.kc = torch.zeros(shape, dtype=dtype, device=self.device)
        self.vc = torch.zeros(shape, dtype=dtype, device=self.device)
        self.index = RadixPrefixIndex(self.block_size)
        self._free_blocks = list(range(1, self.num_blocks))
        self._ref = {}
        self._evictable = 0
        self._live = 0   # blocks at ref > 0
        self.evictions = 0
        self._free_slots = list(range(self.num_slots))
        self._owner = {}
        self._slot_blocks = {}
        self.block_tables = np.full(
            (self.num_slots, self.blocks_per_slot), TRASH_BLOCK, np.int32)
        self._tables_dev = None
        self._dirty = True

    # ------------------------------------------------------- slot facade
    @property
    def free_count(self):
        return len(self._free_slots)

    @property
    def slot_capacity(self):
        """Tokens one slot's table row can address."""
        return self.blocks_per_slot * self.block_size

    # ------------------------------------------------------ block alloc
    @property
    def free_blocks(self):
        return len(self._free_blocks)

    @property
    def live_blocks(self):
        return self._live

    def _alloc_block(self):
        """A fresh block at ref 1 from the free heap, or by evicting the
        LRU ref-0 radix leaf; None when neither has one (ref-0 interior
        nodes are unreachable while live descendants pin the path)."""
        if self._free_blocks:
            b = heapq.heappop(self._free_blocks)
        else:
            b = self.index.evict_lru(
                lambda blk: self._ref.get(blk, 0) == 0)
            if b is None:
                return None
            self.evictions += 1
            self._evictable -= 1
        self._ref[b] = 1
        self._live += 1
        return b

    def _deref(self, b):
        """Drop one reference: at ref 0 an indexed block parks evictable,
        an unindexed one frees."""
        r = self._ref[b] = self._ref[b] - 1
        if r < 0:
            raise AssertionError(f"block {b} refcount underflow")
        if r == 0:
            self._live -= 1
            if b in self.index:
                self._evictable += 1
            else:
                del self._ref[b]
                heapq.heappush(self._free_blocks, b)

    def match_prefix(self, prompt):
        """Longest cached prefix of ``prompt`` in tokens (a block
        multiple)."""
        return len(self.index.match(prompt)) * self.block_size

    def acquire(self, owner, prompt, total_tokens, prefix_tokens):
        """Claim the lowest free slot for ``owner``, pin the first
        ``prefix_tokens`` (block-aligned) from the radix index into its
        row, and allocate fresh blocks for the rest of ``total_tokens``.
        Returns a PagedAllocation, or None (pool untouched) when no slot
        is free or the fresh blocks cannot all be found."""
        if not self._free_slots:
            return None
        bs = self.block_size
        if prefix_tokens % bs:
            raise ValueError(
                f"prefix_tokens {prefix_tokens} is not block-aligned "
                f"(block_size {bs})")
        n_total = -(-int(total_tokens) // bs)
        if n_total > self.blocks_per_slot:
            raise ValueError(
                f"{total_tokens} tokens need {n_total} blocks; a slot "
                f"row holds {self.blocks_per_slot}")
        n_prefix = prefix_tokens // bs
        n_new = n_total - n_prefix
        # the row's LAST block must be private: decode clamps
        # overflowing write positions into it
        if n_new < 1:
            raise ValueError(
                f"total_tokens {total_tokens} must exceed the pinned "
                f"prefix ({prefix_tokens} tokens): the row's last "
                f"block must be private, never a shared prefix block")
        matched = self.index.match(prompt)
        prefix_blocks = matched[:n_prefix]
        if len(prefix_blocks) < n_prefix:
            raise ValueError(
                f"prefix_tokens {prefix_tokens} exceeds the cached "
                f"prefix ({len(prefix_blocks) * bs} tokens)")
        # ref-0 prefix blocks are about to be pinned: not supply
        pinned_ref0 = sum(
            1 for b in prefix_blocks if self._ref.get(b, 0) == 0)
        if n_new > (len(self._free_blocks) + self._evictable
                    - pinned_ref0):
            return None
        for b in prefix_blocks:
            r = self._ref.get(b, 0)
            self._ref[b] = r + 1
            if r == 0:
                self._evictable -= 1
                self._live += 1
        new_blocks = []
        for _ in range(n_new):
            b = self._alloc_block()
            if b is None:
                for nb in new_blocks:
                    self._deref(nb)
                for pb in prefix_blocks:
                    self._deref(pb)
                return None
            new_blocks.append(b)
        slot = heapq.heappop(self._free_slots)
        self._owner[slot] = owner
        row = prefix_blocks + new_blocks
        self._slot_blocks[slot] = row
        self.block_tables[slot, :] = TRASH_BLOCK
        self.block_tables[slot, :len(row)] = row
        self._dirty = True
        self.index.note_hits(prefix_blocks)
        return PagedAllocation(slot, prefix_tokens, prefix_blocks,
                               new_blocks)

    def commit_prefix(self, slot, prompt):
        """Index the slot's FULL prompt blocks so later admissions can
        hit them; call after the prefill ran."""
        if slot not in self._owner:
            raise ValueError(f"slot {slot} is not live")
        n_full = len(prompt) // self.block_size
        blocks = self._slot_blocks[slot][:n_full]
        return self.index.insert(prompt, blocks)

    def release(self, slot):
        """Return a slot: deref its blocks and point its row at trash."""
        if slot not in self._owner:
            raise ValueError(f"slot {slot} is not live")
        del self._owner[slot]
        for b in self._slot_blocks.pop(slot):
            self._deref(b)
        heapq.heappush(self._free_slots, slot)
        self.block_tables[slot, :] = TRASH_BLOCK
        self._dirty = True

    # ------------------------------------------------- export / import
    def row_blocks(self, slot, n):
        """The first ``n`` blocks of a live slot's row, in row order:
        the blocks a handoff of its first ``n * block_size`` positions
        ships (shared prefix blocks included, read in place)."""
        if slot not in self._owner:
            raise ValueError(f"slot {slot} is not live")
        row = self._slot_blocks[slot]
        if not 0 < n <= len(row):
            raise ValueError(f"slot {slot} holds {len(row)} blocks, "
                             f"{n} asked for")
        return row[:n]

    def read_blocks(self, blocks):
        """K and V tiles ``[layers, n, heads, block_size, head_dim]`` of
        ``blocks``, copied to the host."""
        idx = upload(np.asarray(blocks, np.int64), self.device)
        return (self.kc.index_select(1, idx).cpu(),
                self.vc.index_select(1, idx).cpu())

    def write_blocks(self, blocks, k, v):
        """Bind received tiles into ``blocks`` (fresh blocks an import
        acquired): ``kc[:, blocks] = k``."""
        idx = upload(np.asarray(blocks, np.int64), self.device)
        self.kc[:, idx] = k.to(self.device, self.kc.dtype)
        self.vc[:, idx] = v.to(self.device, self.vc.dtype)

    # ---------------------------------------------------- device tensors
    def device_tables(self):
        """The block table on the pool's device, re-uploaded only when
        acquire/release changed it."""
        if self._tables_dev is None or self._dirty:
            self._tables_dev = upload(self.block_tables, self.device)
            self._dirty = False
        return self._tables_dev

    def table_row(self, slot):
        """One slot's row on the device (int64, for index_select)."""
        return upload(self.block_tables[slot].astype(np.int64),
                      self.device)

    # ------------------------------------------------------------ stats
    def stats(self):
        """The ``snapshot()["prefix_cache"]["pool"]`` section."""
        return {
            "block_size": self.block_size,
            "blocks_per_slot": self.blocks_per_slot,
            "num_blocks": self.num_blocks,
            "free_blocks": len(self._free_blocks),
            "live_blocks": self.live_blocks,
            "evictable_blocks": self._evictable,
            "indexed_blocks": len(self.index),
            "radix_depth": self.index.stats()["depth"],
            "evictions": self.evictions,
            "thrash_reinserts": self.index.thrash_count,
        }

    def check_conservation(self):
        """Invariant audit: trash + free + refcounted blocks partition
        the pool, and the evictable count equals the indexed ref-0
        population."""
        tracked = set(self._ref)
        free = set(self._free_blocks)
        assert not (tracked & free), (tracked, free)
        assert tracked | free | {TRASH_BLOCK} == set(
            range(self.num_blocks))
        assert self._evictable == sum(
            1 for b, r in self._ref.items() if r == 0 and b in self.index)
        assert self._live == sum(
            1 for r in self._ref.values() if r > 0), \
            (self._live, dict(self._ref))
        for b, r in self._ref.items():
            assert r >= 0, (b, r)
            if r == 0:
                assert b in self.index
        return True
