"""Host side of speculative decoding (the port's own copy of
``paddle_tpu/serving/spec/decoder.py``): the drafter, the fixed-shape
``[S, k]`` draft buffers the verify program takes, and the EWMA
acceptance gate that returns a request to plain decode when its drafts
stop landing.

The engine calls ``propose(snapshot)`` once per decode step, after it
has harvested the tokens in flight (drafts extend a request's last
HARVESTED token), and ``observe(...)`` once per verified slot at
harvest. Per request: the draft width is ``min(k, remaining - 1)`` (the
verify step adds a bonus token), and an acceptance EWMA (seeded at 1.0)
below ``min_accept`` stops its proposals; a slot with no draft rides the
verify program as a plain decode, and a step where no slot drafts runs
the plain decode program. The EWMA table is a bounded LRU.
"""
from collections import OrderedDict

import numpy as np

from .drafter import NGramDrafter

_EWMA_KEEP = 4096


class SpecDecoder:
    def __init__(self, num_slots, k, min_accept, ewma_alpha=0.3,
                 drafter=None):
        self.num_slots = int(num_slots)
        self.k = int(k)
        self.min_accept = float(min_accept)
        self.alpha = float(ewma_alpha)
        self.drafter = drafter if drafter is not None \
            else NGramDrafter(k)
        self._ewma = OrderedDict()        # rid -> smoothed acceptance

    # -- per-step proposal -----------------------------------------

    def propose(self, snapshot):
        """snapshot: {slot: Request} (decode-eligible slots only).
        Returns (drafts [S, k] int32, dlen [S] int32, drafted) with
        drafted = {slot: n} for slots given a non-empty draft — empty
        means the engine should dispatch the plain decode program."""
        drafts = np.zeros((self.num_slots, self.k), np.int32)
        dlen = np.zeros((self.num_slots,), np.int32)
        drafted = {}
        for slot, req in snapshot.items():
            ids = req.prefill_ids
            self.drafter.sync(slot, req.rid, ids)
            if req.inflight or not req.generated:
                # the device-side chained token is not in prefill_ids
                # yet (freshly prefilled slot, or a result still in
                # flight) — a draft here would extend the wrong token
                continue
            width = req.max_new_tokens - len(req.generated) - 1
            if width < 1:
                continue
            if self._ewma.get(req.rid, 1.0) < self.min_accept:
                continue
            prop = self.drafter.propose(slot, width=width)
            if not prop:
                continue
            n = len(prop)
            drafts[slot, :n] = prop
            dlen[slot] = n
            drafted[slot] = n
        return drafts, dlen, drafted

    # -- harvest feedback ------------------------------------------

    def observe(self, rid, drafted, accepted):
        """Fold one verify outcome into the request's acceptance EWMA
        (only meaningful when it actually drafted)."""
        if drafted <= 0:
            return
        rate = accepted / drafted
        old = self._ewma.pop(rid, 1.0)
        self._ewma[rid] = self.alpha * rate + (1 - self.alpha) * old
        while len(self._ewma) > _EWMA_KEEP:
            self._ewma.popitem(last=False)

    def acceptance_ewma(self, rid):
        return self._ewma.get(rid, 1.0)

    def reset(self):
        """Supervisor restart: drop all draft state (the replay rebuilds
        each request's context from its prompt and emitted tokens)."""
        self.drafter = NGramDrafter(
            self.k, max_entries=self.drafter.max_entries,
            shared_entries=self.drafter.shared_entries)
        self._ewma.clear()
