"""Slot-pooled contiguous KV cache (a port of
``paddle_tpu/serving/kv_pool.py``).

The pool owns one pair of cache tensors ``[layers, num_slots, heads,
max_len, head_dim]`` on its device, updated IN PLACE by the serving
programs. A request claims a slot at prefill, decodes in it, and frees
it the step it finishes; a waiting request then claims it. Recycling
needs no wipe: a prefill overwrites the slot's first rows and the
per-slot length mask (``ops.attention.cached_slot_attention``) hides
every row beyond the request's live prefix.

The reference's ``rebind`` swapped in the arrays a donating executable
returned; with the caches updated in place there is nothing to swap,
so it has no counterpart. A quarantined slot (repeated same-slot
dispatch failures) is neither free nor occupied.
"""
import heapq

import torch

from ..core.device import resolve_device


class SlotKVPool:
    """Free-list allocator over the pooled cache tensors: the lowest
    free slot first, from a heap, so runs are reproducible. ``device``
    None means the card, as for every entry point of the port."""

    def __init__(self, num_slots, num_layers, num_heads, max_len,
                 head_dim, dtype=torch.float32, device=None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.device = resolve_device(device)
        shape = (int(num_layers), self.num_slots, int(num_heads),
                 self.max_len, int(head_dim))
        self.kc = torch.zeros(shape, dtype=dtype, device=self.device)
        self.vc = torch.zeros(shape, dtype=dtype, device=self.device)
        self._free = list(range(self.num_slots))   # heap: lowest first
        self._owner = {}                           # slot -> request id
        self._quarantined = set()   # excluded from admission
        self.reuse_count = 0   # acquisitions of a slot used before
        self._ever_used = set()

    @property
    def free_count(self):
        return len(self._free)

    @property
    def occupancy(self):
        """Fraction of slots owned by live requests (quarantined slots
        are neither free nor occupied)."""
        return len(self._owner) / self.num_slots

    @property
    def quarantined(self):
        """Slots excluded from admission (sorted)."""
        return sorted(self._quarantined)

    def quarantine(self, slot):
        """Exclude a FREE slot from admission (the engine's response to
        repeated same-slot dispatch failures)."""
        if slot in self._owner:
            raise ValueError(f"slot {slot} is live; release it first")
        if slot in self._quarantined:
            return
        self._free.remove(slot)
        heapq.heapify(self._free)
        self._quarantined.add(slot)

    def unquarantine_all(self):
        """Return every quarantined slot to the free heap."""
        for slot in sorted(self._quarantined):
            heapq.heappush(self._free, slot)
        self._quarantined.clear()

    def acquire(self, owner):
        """Claim the lowest free slot for ``owner``; None when full."""
        if not self._free:
            return None
        slot = heapq.heappop(self._free)
        self._owner[slot] = owner
        if slot in self._ever_used:
            self.reuse_count += 1
        self._ever_used.add(slot)
        return slot

    def release(self, slot):
        if slot not in self._owner:
            raise ValueError(f"slot {slot} is not live")
        del self._owner[slot]
        heapq.heappush(self._free, slot)

    def owner_of(self, slot):
        return self._owner.get(slot)

    def nbytes(self):
        return self.kc.nbytes + self.vc.nbytes
