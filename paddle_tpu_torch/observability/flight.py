"""Request-level flight recorder: one lifecycle trace per serving
request, flow-linked across engine step spans (a copy of
``paddle_tpu/observability/flight.py``).

The engine-level observability (registry / host spans / watchdog)
answers "what is the ENGINE doing"; operating continuous batching
under heavy traffic is debugged per REQUEST — "why did request 4812
take 900 ms to first token?". This module is that Dapper-style answer:
every request gets a trace id and an append-only lifecycle record

    enqueued -> admitted(slot, bucket, group_size)
             -> prefill_dispatched -> first_token
             -> decode_window(tokens) ...
             -> retired(reason, slo_violations)

with perf_counter timestamps (monotone by construction — appended
under one lock from a monotonic clock).

Every event ALSO lands in the host-span recorder twice: a zero-length
marker span (``request/<event>`` with the rid and attrs) and a chrome
FLOW event (``ph:"s"/"t"/"f"``, one flow chain per request, id = rid).
Flow points bind to the slice enclosing their timestamp, so Perfetto
draws arrows from a request's enqueue marker through the engine step
spans it was admitted/prefilled/decoded in, to its retirement — load
``dump_chrome_trace()`` output and follow one request's life across
the steps.

Completed traces park in a bounded keep-last-N ring (a
serve-forever process must not accumulate per-request state). ``ServingEngine.request_trace(rid)``
reads one back; the ``/debug/requests`` endpoint serves them all.
"""
import collections
import threading
import time

from .tracing import default_recorder

# lifecycle event names (the validator test pins the order contract:
# enqueued <= admitted <= prefill_dispatched <= first_token <= retired)
ENQUEUED = "enqueued"
ADMITTED = "admitted"
ADMISSION_ROLLED_BACK = "admission_rolled_back"
PREFIX_HIT = "prefix_hit"
PREFILL_DISPATCHED = "prefill_dispatched"
PREFILL_CHUNK = "prefill_chunk"
DEPRIORITIZED = "deprioritized"
SHED = "shed"
DISPATCH_FAILED = "dispatch_failed"
REQUEUED = "requeued"
CALLBACK_ERROR = "callback_error"
DEADLINE_EXCEEDED = "deadline_exceeded"
FIRST_TOKEN = "first_token"
DECODE_WINDOW = "decode_window"
DRAFT_ACCEPTED = "draft_accepted"
DRAFT_REJECTED = "draft_rejected"
KV_EXPORTED = "kv_exported"
KV_IMPORTED = "kv_imported"
RETIRED = "retired"


class RequestTrace:
    """One request's lifecycle: an append-only list of
    ``{"event", "t", ...attrs}`` records (``t`` on the perf_counter
    clock) plus the retirement reason once retired."""

    __slots__ = ("rid", "events", "reason", "trace_id", "tenant_id")

    def __init__(self, rid):
        self.rid = int(rid)
        self.events = []
        self.reason = None
        # the request's distributed trace id (32-hex), stamped at
        # enqueue from the propagated TraceContext — the join key
        # between /debug/requests and the cross-replica trace surface
        self.trace_id = None
        # attribution: which tenant this request billed to (stamped at
        # enqueue; the ?tenant= filter on /debug/requests keys on it)
        self.tenant_id = None

    def t_of(self, event):
        """Timestamp of the FIRST occurrence of ``event``; None if it
        never happened (e.g. still queued)."""
        for e in self.events:
            if e["event"] == event:
                return e["t"]
        return None

    @property
    def retired(self):
        return self.reason is not None

    def as_dict(self):
        """JSON-safe view: absolute t plus ms-since-enqueue per event
        (the human-readable column when eyeballing /debug/requests)."""
        t0 = self.t_of(ENQUEUED)
        events = []
        for e in self.events:
            d = dict(e)
            d["t"] = round(d["t"], 6)
            if t0 is not None:
                d["t_rel_ms"] = round((e["t"] - t0) * 1000.0, 3)
            events.append(d)
        return {"rid": self.rid, "reason": self.reason,
                "trace_id": self.trace_id, "tenant_id": self.tenant_id,
                "events": events}


class FlightRecorder:
    """Thread-safe per-request lifecycle recorder.

    ``keep_last`` bounds the completed-trace ring; ``decode_window``
    sets the token-count granularity of mid-decode progress events
    (every N tokens one ``decode_window`` event records the cumulative
    count — cheap enough to leave on, detailed enough to see a slow
    decode tail). ``recorder`` is the HostSpanRecorder receiving the
    marker spans + flow events (default: the process-global one the
    chrome trace dump exports).
    """

    def __init__(self, recorder=None, keep_last=256, decode_window=32,
                 clock=time.perf_counter):
        if keep_last < 1:
            raise ValueError("keep_last must be >= 1")
        if decode_window < 1:
            raise ValueError("decode_window must be >= 1")
        self.keep_last = int(keep_last)
        self.decode_window = int(decode_window)
        self._recorder = recorder if recorder is not None \
            else default_recorder()
        self._clock = clock
        self._lock = threading.Lock()
        self._active = {}                       # rid -> RequestTrace
        self._done = collections.OrderedDict()  # rid -> RequestTrace
        self._dropped = 0

    # ------------------------------------------------------- recording
    def _event(self, rid, event, phase, attrs):
        t = self._clock()
        with self._lock:
            trace = self._active.get(rid)
            if trace is None:
                # first sighting of this rid — normally the enqueue,
                # but a recorder attached mid-flight starts a partial
                # trace rather than losing events. Either way the flow
                # chain must START here.
                trace = self._active[rid] = RequestTrace(rid)
                phase = "s"
            if "trace_id" in attrs and trace.trace_id is None:
                trace.trace_id = attrs["trace_id"]
            if "tenant" in attrs and trace.tenant_id is None:
                trace.tenant_id = attrs["tenant"]
            trace.events.append(dict({"event": event, "t": t}, **attrs))
        args = dict({"rid": rid}, **attrs)
        # marker span + flow point at the SAME timestamp: the flow
        # binds to the marker (or any enclosing engine span), linking
        # the request's life across step spans in Perfetto
        self._recorder.record(f"request/{event}", t, 0.0, args)
        self._recorder.record_flow(f"request {rid}", t, phase, rid,
                                   {"event": event})
        return t

    def enqueued(self, req):
        attrs = {"prompt_len": int(len(req.prompt)),
                 "max_new_tokens": int(req.max_new_tokens)}
        trace = getattr(req, "trace", None)
        if trace is not None:
            attrs["trace_id"] = trace.trace_id
        tenant = getattr(req, "tenant_id", None)
        if tenant is not None:
            attrs["tenant"] = tenant
        self._event(req.rid, ENQUEUED, "s", attrs)

    def admitted(self, req, slot, bucket, group_size):
        self._event(req.rid, ADMITTED, "t",
                    {"slot": int(slot), "bucket": int(bucket),
                     "group_size": int(group_size)})

    def admission_rolled_back(self, req):
        """The request's admission was undone before its prefill
        dispatched (dispatch-failure rollback): the preceding
        ``admitted`` event is void, the request is back at the front
        of the queue, and a later ``admitted`` is a fresh attempt —
        readers pairing admissions with retirements skip voided
        ones."""
        self._event(req.rid, ADMISSION_ROLLED_BACK, "t", {})

    def prefix_hit(self, req, cached_tokens, tail_tokens,
                   saved_ms=None):
        """The request's admission reused ``cached_tokens`` prompt
        tokens straight from the paged pool's radix prefix cache, so
        the prefill that follows dispatches only the ``tail_tokens``
        tail (emitted between ``admitted`` and ``prefill_dispatched``;
        absent = the prompt missed the cache entirely). ``saved_ms``
        is the cache observatory's estimated TTFT saving for this
        admission (cached tokens x measured per-token prefill cost;
        None until prefill measurements exist)."""
        attrs = {"cached_tokens": int(cached_tokens),
                 "tail_tokens": int(tail_tokens)}
        if saved_ms is not None:
            attrs["saved_ms"] = round(float(saved_ms), 3)
        self._event(req.rid, PREFIX_HIT, "t", attrs)

    def prefill_dispatched(self, req, bucket, group_size):
        self._event(req.rid, PREFILL_DISPATCHED, "t",
                    {"bucket": int(bucket),
                     "group_size": int(group_size)})

    def prefill_chunk(self, req, index, start, chunk_len, final):
        """One chunked-prefill dispatch for this request: chunk
        ``index`` covers prompt positions ``start..start+chunk_len``
        (``final`` marks the chunk whose logits emit the first token).
        The chunk chain is WHY a long prompt's trace shows decode
        windows of other requests progressing between its own prefill
        events — chunking is the co-scheduling made visible."""
        self._event(req.rid, PREFILL_CHUNK, "t",
                    {"chunk": int(index), "start": int(start),
                     "chunk_len": int(chunk_len),
                     "final": bool(final)})

    def deprioritized(self, req, headroom_ms):
        """The admission policy moved this queued request behind the
        still-SLO-viable queue (its own SLO is already lost);
        ``headroom_ms`` (<= 0) is the TTFT budget balance at decision
        time — the trace answers WHY it waited."""
        self._event(req.rid, DEPRIORITIZED, "t",
                    {"headroom_ms": round(float(headroom_ms), 3)})

    def shed(self, req, reason, headroom_ms):
        """The admission policy DROPPED this queued request (zero
        tokens served): a ``shed`` event with the reason + headroom at
        decision time, then the trace closes through the normal
        retirement path (reason "shed") so every trace still ends
        ``retired`` and the completed ring stays bounded."""
        self._event(req.rid, SHED, "t",
                    {"reason": str(reason),
                     "headroom_ms": round(float(headroom_ms), 3)})
        self.retired(req, "shed")

    def dispatch_failed(self, req, kind, error):
        """A dispatch carrying this request raised (and its admission
        rolled back): ``kind`` names the seam (prefill / chunk /
        decode), ``error`` the exception. A later ``admitted`` is the
        bounded-retry attempt; a ``retired(reason="error")`` means the
        retry budget ran out."""
        self._event(req.rid, DISPATCH_FAILED, "t",
                    {"kind": str(kind),
                     "error": f"{type(error).__name__}: {error}"[:200],
                     "failures": int(req.dispatch_failures)})

    def requeued(self, req, reason):
        """A supervisor restart re-queued this in-flight request for
        re-prefill of its prompt + already-emitted tokens; the earlier
        ``admitted``/``prefill_dispatched`` chain is void (like a
        rollback) and the replay re-runs it."""
        self._event(req.rid, REQUEUED, "t",
                    {"reason": str(reason),
                     "tokens_kept": int(len(req.generated))})

    def callback_error(self, req, error):
        """The user ``on_token`` callback raised; the engine caught it
        and kept streaming (the token WAS emitted and counted)."""
        self._event(req.rid, CALLBACK_ERROR, "t",
                    {"error": f"{type(error).__name__}: {error}"[:200]})

    def deadline_exceeded(self, req, overrun_ms):
        """The request blew its ``deadline_ms`` and is being retired
        (reason "deadline" follows); ``overrun_ms`` is how far past
        the deadline the engine noticed."""
        self._event(req.rid, DEADLINE_EXCEEDED, "t",
                    {"overrun_ms": round(float(overrun_ms), 3)})

    def token_emitted(self, req, n_tokens):
        """Account one emitted token: the FIRST is the TTFT lifecycle
        moment; thereafter every ``decode_window``-th token records a
        cumulative progress point."""
        n = int(n_tokens)
        if n == 1:
            self._event(req.rid, FIRST_TOKEN, "t", {})
        elif n % self.decode_window == 0:
            self._event(req.rid, DECODE_WINDOW, "t", {"tokens": n})

    def draft_accepted(self, req, accepted, drafted):
        """One verify dispatch kept ``accepted`` of this request's
        ``drafted`` speculative tokens (plus the bonus token the
        verify step always yields — counted by token_emitted)."""
        self._event(req.rid, DRAFT_ACCEPTED, "t",
                    {"accepted": int(accepted),
                     "drafted": int(drafted)})

    def draft_rejected(self, req, rejected, drafted):
        """One verify dispatch discarded ``rejected`` of this
        request's ``drafted`` speculative tokens (the tail after the
        first mismatch with the model's greedy choice)."""
        self._event(req.rid, DRAFT_REJECTED, "t",
                    {"rejected": int(rejected),
                     "drafted": int(drafted)})

    def kv_exported(self, req, blocks, wire_bytes):
        """The prefill tier serialized this request's KV blocks for a
        disaggregated handoff. Fires AFTER retirement (the slot was
        parked through it), so the event appends to the completed
        trace in the ring instead of reopening an active one."""
        t = self._clock()
        with self._lock:
            trace = self._done.get(req.rid) or self._active.get(req.rid)
            if trace is not None:
                trace.events.append(
                    {"event": KV_EXPORTED, "t": t,
                     "blocks": int(blocks),
                     "wire_bytes": int(wire_bytes)})
        self._recorder.record(
            f"request/{KV_EXPORTED}", t, 0.0,
            {"rid": req.rid, "blocks": int(blocks),
             "wire_bytes": int(wire_bytes)})

    def kv_imported(self, req, blocks, wire_bytes):
        """The decode tier bound this request's streamed KV blocks
        into its pool (the disaggregated admission moment)."""
        self._event(req.rid, KV_IMPORTED, "t",
                    {"blocks": int(blocks),
                     "wire_bytes": int(wire_bytes)})

    def retired(self, req, reason, **attrs):
        """Close the request's trace (reason: "eos" / "max_tokens" /
        anything the engine decides, e.g. future cancellations) and
        move it into the bounded completed ring."""
        base = {"reason": str(reason),
                "tokens": int(len(req.generated))}
        tenant = getattr(req, "tenant_id", None)
        if tenant is not None:
            # retirement carries the attribution too: a grep of
            # retired events alone can bill tokens per tenant
            base["tenant"] = tenant
        self._event(req.rid, RETIRED, "f", dict(base, **attrs))
        with self._lock:
            trace = self._active.pop(req.rid, None)
            if trace is None:
                return
            trace.reason = str(reason)
            self._done[req.rid] = trace
            while len(self._done) > self.keep_last:
                self._done.popitem(last=False)
                self._dropped += 1

    # -------------------------------------------------------- querying
    def trace(self, rid):
        """The RequestTrace for ``rid`` — completed or still active;
        None when unknown (never seen, or evicted from the ring)."""
        with self._lock:
            return self._done.get(rid) or self._active.get(rid)

    def completed(self):
        """Completed traces, oldest first (bounded at keep_last)."""
        with self._lock:
            return list(self._done.values())

    def active(self):
        with self._lock:
            return list(self._active.values())

    def state(self):
        with self._lock:
            return {
                "active": len(self._active),
                "completed_kept": len(self._done),
                "completed_dropped": self._dropped,
                "keep_last": self.keep_last,
                "decode_window": self.decode_window,
            }

    def debug_requests(self, tenant=None):
        """The ``/debug/requests`` JSON body: recorder state plus every
        kept trace, completed and in-flight. ``tenant`` filters both
        lists to one tenant's requests (the ``?tenant=<id>`` query
        form of the route); the ``state`` summary stays fleet-wide."""
        completed, active = self.completed(), self.active()
        if tenant:
            completed = [t for t in completed if t.tenant_id == tenant]
            active = [t for t in active if t.tenant_id == tenant]
        out = {
            "state": self.state(),
            "completed": [t.as_dict() for t in completed],
            "active": [t.as_dict() for t in active],
        }
        if tenant:
            out["tenant"] = tenant
        return out
