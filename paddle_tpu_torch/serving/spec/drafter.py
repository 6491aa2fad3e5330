"""Self-drafting n-gram / prompt-lookup proposer (the port's own copy
of ``paddle_tpu/serving/spec/drafter.py``, Saxena's "Prompt Lookup
Decoding"): no second model, each slot's own context (``prefill_ids``,
the prompt and everything emitted) is the draft source. Per slot, a
bounded index maps the last n tokens to the position after their most
recent PRIOR occurrence; a proposal is the k tokens that followed it.

  * bounded memory: per-slot entries are capped (``max_entries``, FIFO
    eviction); the shared prompt index is a capped LRU;
  * incremental: ``sync()`` indexes only the tokens appended since the
    last call;
  * shared prompts: prompt n-grams feed a content-keyed index shared by
    every request, so a second request with the same prompt drafts from
    the first's statistics at once; a seen-prompt fingerprint set skips
    exact repeats;
  * deterministic: identical token streams give identical proposals.

Proposals come back unpadded (``SpecDecoder`` pads them to ``[S, k]``).
"""
from collections import OrderedDict


class _SlotIndex:
    """One slot's incremental n-gram index over its token history."""

    __slots__ = ("history", "index", "max_entries")

    def __init__(self, max_entries):
        self.history = []
        # ngram tuple -> (prev_start, last_start): positions right
        # AFTER the two most recent occurrences. The suffix n-gram of
        # the history always maps its own (useless, empty-continuation)
        # occurrence to last_start == len(history); prev_start keeps
        # the one a proposal actually wants.
        self.index = OrderedDict()
        self.max_entries = max_entries

    def extend(self, tokens, orders):
        h = self.history
        idx = self.index
        for tok in tokens:
            h.append(int(tok))
            end = len(h)
            for n in orders:
                if end < n:
                    continue
                key = tuple(h[end - n:end])
                old = idx.pop(key, None)
                idx[key] = (old[1] if old else None, end)
                if len(idx) > self.max_entries:
                    idx.popitem(last=False)

    def lookup(self, orders):
        """Continuation-start position for the history's freshest
        matching suffix n-gram (longest order first), or None."""
        h = self.history
        end = len(h)
        for n in orders:
            if end < n:
                continue
            hit = self.index.get(tuple(h[end - n:end]))
            if hit is None:
                continue
            prev, last = hit
            p = last if last < end else prev
            if p is not None and p < end:
                return p
        return None


class NGramDrafter:
    """Bounded, incremental, radix-aware prompt-lookup draft index.

    ``k``            draft width (max tokens proposed per call);
    ``ngram_max`` / ``ngram_min``
                     suffix n-gram orders tried, longest first
                     (longer matches draft more reliably);
    ``max_entries``  per-slot index cap (FIFO eviction);
    ``shared_entries``
                     cap of the cross-request shared prompt index
                     (LRU) and of the seen-prompt fingerprint set.
    """

    def __init__(self, k, ngram_max=3, ngram_min=2, max_entries=4096,
                 shared_entries=16384):
        if k < 1:
            raise ValueError(f"draft width k must be >= 1, got {k}")
        if ngram_min < 1 or ngram_max < ngram_min:
            raise ValueError("need 1 <= ngram_min <= ngram_max")
        self.k = int(k)
        self.orders = tuple(range(int(ngram_max), int(ngram_min) - 1,
                                  -1))
        self.max_entries = int(max_entries)
        self.shared_entries = int(shared_entries)
        self._slots = {}          # slot -> (rid, _SlotIndex)
        self._shared = OrderedDict()   # ngram -> continuation tuple
        self._seen_prompts = OrderedDict()  # prompt fingerprint -> True

    # -- binding / incremental sync --------------------------------

    def sync(self, slot, rid, tokens):
        """Bind (slot, rid) if new, then index any tokens appended
        since the last sync. ``tokens`` is the request's full
        prompt-plus-generated list; only the unseen tail is processed.
        On first bind the PROMPT part also feeds the shared index
        (skipped entirely for an exactly-repeated prompt — its
        n-grams are already there)."""
        bound = self._slots.get(slot)
        if bound is None or bound[0] != rid:
            st = _SlotIndex(self.max_entries)
            self._slots[slot] = (rid, st)
            self._index_shared_prompt(tokens)
        else:
            st = bound[1]
        done = len(st.history)
        if len(tokens) > done:
            st.extend(tokens[done:], self.orders)

    def _index_shared_prompt(self, prompt):
        fp = hash(tuple(int(t) for t in prompt))
        if fp in self._seen_prompts:
            self._seen_prompts.move_to_end(fp)
            return
        self._seen_prompts[fp] = True
        if len(self._seen_prompts) > self.shared_entries:
            self._seen_prompts.popitem(last=False)
        n_min = self.orders[-1]
        toks = [int(t) for t in prompt]
        for end in range(n_min, len(toks)):
            for n in self.orders:
                if end < n:
                    continue
                cont = tuple(toks[end:end + self.k])
                if not cont:
                    continue
                key = tuple(toks[end - n:end])
                self._shared.pop(key, None)
                self._shared[key] = cont
                if len(self._shared) > self.shared_entries:
                    self._shared.popitem(last=False)

    # -- proposals --------------------------------------------------

    def propose(self, slot, width=None):
        """Up to ``min(k, width)`` draft tokens continuing this slot's
        context, or [] when no n-gram matches. Own-context matches win
        (freshest statistics); the shared prompt index is the
        fallback for requests that haven't generated enough context
        of their own yet."""
        bound = self._slots.get(slot)
        if bound is None:
            return []
        st = bound[1]
        w = self.k if width is None else min(self.k, int(width))
        if w < 1:
            return []
        p = st.lookup(self.orders)
        if p is not None:
            return st.history[p:p + w]
        h = st.history
        end = len(h)
        for n in self.orders:
            if end < n:
                continue
            cont = self._shared.get(tuple(h[end - n:end]))
            if cont:
                return list(cont[:w])
        return []

    # -- introspection (tests; bounded-memory proof) ----------------

    def index_sizes(self):
        """{slot: per-slot index entries} plus the shared index size —
        every number is bounded by the caps above by construction."""
        sizes = {slot: len(st.index)
                 for slot, (_, st) in self._slots.items()}
        sizes["shared"] = len(self._shared)
        sizes["seen_prompts"] = len(self._seen_prompts)
        return sizes
