"""In-flight request journal: the router's replay ledger (a copy of
``paddle_tpu/serving/router/journal.py``).

Mirrors the self-healing supervisor's ``prefill_ids`` replay
discipline one level up: for every admitted request the router
remembers the prompt plus every token a replica has streamed back so
far. When a replica dies mid-request, the next dispatch sends
``prompt + tokens_so_far`` as the prompt with the token budget reduced
accordingly — greedy decoding makes the continuation bit-exact, so
the client-visible stream is indistinguishable from an unfaulted run.

Committed prefixes are append-consistent by construction: greedy
streams from identically-seeded replicas agree token-for-token, so a
commit from ANY dispatch attempt (a failed attempt's partials, a
hedged winner's full stream) replaces the suffix from that attempt's
dispatch base without conflict. ``commit`` still asserts the base is
in range — a torn journal is a router bug worth crashing on in tests.

The journal is bounded by the router's admission gate (``max_queue``)
— never unbounded buffering — and its depth is exported as the
``router_journal_depth`` gauge.
"""
import threading

__all__ = ["JournalEntry", "RequestJournal"]


class JournalEntry:
    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_id",
                 "deadline_ms", "tokens", "replica", "attempts",
                 "t_admitted", "trace", "tenant")

    def __init__(self, rid, prompt, max_new_tokens, eos_id,
                 deadline_ms, t_admitted, trace=None, tenant=None):
        self.rid = rid
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.deadline_ms = deadline_ms
        self.tokens = []          # committed generated tokens so far
        self.replica = None       # current / last dispatch target
        self.attempts = 0
        self.t_admitted = t_admitted
        # the request's distributed TraceContext, minted at admission:
        # every dispatch attempt (including failover replays) carries
        # it, so replayed work appears as sibling spans of ONE trace.
        # None tolerated (old-format replay) — the engine coerces.
        self.trace = trace
        # the admitting tenant: a failover replay bills the SAME
        # tenant as the original attempt (it also rides the trace
        # baggage; this slot keeps the journal snapshot greppable)
        self.tenant = tenant

    @property
    def prefill_ids(self):
        """What the NEXT dispatch must send as its prompt: original
        prompt + every committed token (the supervisor's replay rule,
        applied across replicas)."""
        return self.prompt + [int(t) for t in self.tokens]

    @property
    def remaining_tokens(self):
        return max(0, self.max_new_tokens - len(self.tokens))


class RequestJournal:
    def __init__(self):
        self._entries = {}
        self._lock = threading.Lock()

    def admit(self, rid, prompt, max_new_tokens, eos_id, deadline_ms,
              t_admitted, trace=None, tenant=None):
        entry = JournalEntry(rid, prompt, max_new_tokens, eos_id,
                             deadline_ms, t_admitted, trace=trace,
                             tenant=tenant)
        with self._lock:
            self._entries[rid] = entry
        return entry

    def commit(self, entry, base, tokens):
        """Replace ``entry.tokens[base:]`` with ``tokens`` — the
        committed stream from a dispatch attempt whose journal length
        at dispatch time was ``base``. Greedy determinism guarantees
        agreement on any overlap; the base must not skip past the
        committed frontier (that would tear the stream)."""
        with self._lock:
            if base > len(entry.tokens):
                raise AssertionError(
                    f"journal tear: commit base {base} past frontier "
                    f"{len(entry.tokens)} (rid {entry.rid})")
            if len(tokens) > len(entry.tokens) - base:
                entry.tokens[base:] = [int(t) for t in tokens]

    def complete(self, rid):
        with self._lock:
            return self._entries.pop(rid, None)

    @property
    def depth(self):
        with self._lock:
            return len(self._entries)

    def snapshot(self):
        with self._lock:
            return [{"rid": e.rid, "replica": e.replica,
                     "attempts": e.attempts,
                     "tokens_so_far": len(e.tokens),
                     "remaining_tokens": e.remaining_tokens,
                     "tenant": e.tenant}
                    for e in self._entries.values()]
