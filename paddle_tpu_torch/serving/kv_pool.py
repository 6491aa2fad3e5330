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
so it has no counterpart. Quarantine belongs to the resilience layer,
which is not ported.
"""
import heapq

import torch


class SlotKVPool:
    """Free-list allocator over the pooled cache tensors: the lowest
    free slot first, from a heap, so runs are reproducible."""

    def __init__(self, num_slots, num_layers, num_heads, max_len,
                 head_dim, dtype=torch.float32, device="cpu"):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.device = torch.device(device)
        shape = (int(num_layers), self.num_slots, int(num_heads),
                 self.max_len, int(head_dim))
        self.kc = torch.zeros(shape, dtype=dtype, device=self.device)
        self.vc = torch.zeros(shape, dtype=dtype, device=self.device)
        self._free = list(range(self.num_slots))   # heap: lowest first
        self._owner = {}                           # slot -> request id
        self.reuse_count = 0   # acquisitions of a slot used before
        self._ever_used = set()

    @property
    def free_count(self):
        return len(self._free)

    @property
    def occupancy(self):
        """Fraction of slots owned by live requests."""
        return len(self._owner) / self.num_slots

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
