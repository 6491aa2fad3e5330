"""Per-process trace spans: named, wall-anchored, bounded (a copy of
``paddle_tpu/observability/trace/spans.py``).

Each process in a request's path (router, prefill replica, decode
replica) owns one :class:`TraceRecorder` — a thread-safe bounded ring
of :class:`TraceSpan` records. Spans are WALL-anchored (epoch seconds
from ``time.time()``), unlike the flight recorder's perf_counter
timestamps: cross-process assembly needs a clock every replica
shares, and the assembler's offset estimation corrects what it
doesn't. Callers holding perf_counter stamps (the engine's existing
``Request`` lifecycle timestamps) convert through :meth:`wall`,
which anchors one perf_counter origin to one wall reading at recorder
construction — monotone within the process, drift-free at serving
time scales.

The nine CANONICAL_SEGMENTS are the TTFT critical path of a two-hop
disaggregated request; extra span names (``router/retry``,
``router/hedge``, ``router/failover``, ``router/request``) annotate
the retry machinery without entering the decomposition.

``/debug/traces`` serves :meth:`debug_traces` (spans + the replica's
wall clock at render time — the fact the assembler's skew bound needs);
``snapshot()["trace"]`` serves :meth:`snapshot` (TRACE_SNAPSHOT_KEYS
pinned, identical shape disabled).
"""
import collections
import os
import threading
import time

__all__ = ["CANONICAL_SEGMENTS", "TRACE_SNAPSHOT_KEYS", "TraceSpan",
           "TraceRecorder"]

# the TTFT critical path of a two-hop disaggregated request, in
# causal order; a trace assembler's completeness check keys on exactly
# these names
CANONICAL_SEGMENTS = (
    "router/queue", "router/dispatch", "prefill/queue",
    "prefill/compute", "kv/export", "kv/wire", "kv/import",
    "decode/queue", "decode/first_step",
)

# snapshot()["trace"] schema
TRACE_SNAPSHOT_KEYS = ("enabled", "spans_recorded", "spans_dropped",
                       "ring_occupancy", "ring_capacity")


class TraceSpan:
    """One named span of one trace on one replica. ``t0``/``dur`` are
    wall seconds (epoch); ``parent_id`` is the propagated caller span
    (the router's root for every per-hop span)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "replica",
                 "t0", "dur", "attrs")

    def __init__(self, trace_id, span_id, parent_id, name, replica,
                 t0, dur, attrs):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.replica = replica
        self.t0 = t0
        self.dur = dur
        self.attrs = attrs

    def as_dict(self):
        d = {"trace_id": self.trace_id, "span_id": self.span_id,
             "parent_id": self.parent_id, "name": self.name,
             "replica": self.replica, "t0": round(self.t0, 6),
             "dur": round(self.dur, 6)}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


class _SpanTimer:
    """Context manager handle from :meth:`TraceRecorder.span`."""

    __slots__ = ("_rec", "_ctx", "_name", "_attrs", "_t0")

    def __init__(self, rec, ctx, name, attrs):
        self._rec = rec
        self._ctx = ctx
        self._name = name
        self._attrs = attrs

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        self._rec.record(self._ctx, self._name, self._t0,
                         time.time() - self._t0, self._attrs)
        return False


class TraceRecorder:
    """Thread-safe bounded ring of wall-anchored trace spans.

    ``enabled=False`` keeps the full surface (``record`` is a cheap
    no-op, ``snapshot``/``debug_traces`` keep their shapes) so a
    disabled replica still answers every scrape."""

    def __init__(self, replica_id, capacity=4096, enabled=True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.replica_id = str(replica_id)
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._ring = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._recorded = 0
        self._dropped = 0
        # perf_counter -> wall anchor (one origin per process; callers
        # holding Request perf_counter stamps convert through wall()).
        # The anchor pairs a wall read with the perf_counter midpoint
        # of a bracket around it; the bracket width bounds how far a
        # scheduler stall between the two clock reads can skew every
        # later conversion. wall() keeps re-anchoring on the tightest
        # bracket seen, so one unlucky stall never sticks.
        self._anchor = self._read_anchor()

    @staticmethod
    def _read_anchor():
        p1 = time.perf_counter()
        w = time.time()
        p2 = time.perf_counter()
        return (p2 - p1, w, 0.5 * (p1 + p2))

    def wall(self, t_perf):
        """Convert a perf_counter timestamp from THIS process into
        epoch wall seconds through the recorder's anchor."""
        cand = self._read_anchor()
        if cand[0] < self._anchor[0]:
            self._anchor = cand
        _, wall0, perf0 = self._anchor
        return wall0 + (float(t_perf) - perf0)

    # ------------------------------------------------------ recording
    def record(self, ctx, name, t0, dur, attrs=None):
        """Append one span: ``t0``/``dur`` in wall seconds, parented
        on ``ctx.span_id``. Returns the new span id (None when
        disabled or ctx is None — callers never branch on it)."""
        if not self.enabled or ctx is None:
            return None
        span_id = os.urandom(8).hex()
        span = TraceSpan(ctx.trace_id, span_id, ctx.span_id,
                         str(name), self.replica_id, float(t0),
                         max(0.0, float(dur)),
                         dict(attrs) if attrs else None)
        with self._lock:
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append(span)
            self._recorded += 1
        return span_id

    def record_root(self, ctx, name, t0, dur, attrs=None):
        """Append the trace's ROOT span: its span id IS ``ctx.span_id``
        (everything else recorded against ``ctx`` parents on it) and
        it has no parent. The router stamps one per finished request."""
        if not self.enabled or ctx is None:
            return None
        span = TraceSpan(ctx.trace_id, ctx.span_id, None, str(name),
                         self.replica_id, float(t0),
                         max(0.0, float(dur)),
                         dict(attrs) if attrs else None)
        with self._lock:
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append(span)
            self._recorded += 1
        return ctx.span_id

    def span(self, ctx, name, attrs=None):
        """``with recorder.span(ctx, "kv/wire"):`` — wall-timed."""
        return _SpanTimer(self, ctx, name, attrs)

    # ------------------------------------------------------- querying
    def spans(self):
        with self._lock:
            return list(self._ring)

    def for_trace(self, trace_id):
        """Spans of one trace (as dicts), oldest first."""
        with self._lock:
            return [s.as_dict() for s in self._ring
                    if s.trace_id == trace_id]

    def trace_ids(self):
        """Distinct trace ids in the ring, most recent last."""
        seen = {}
        with self._lock:
            for s in self._ring:
                seen[s.trace_id] = True
        return list(seen)

    def snapshot(self):
        """The ``snapshot()["trace"]`` section (TRACE_SNAPSHOT_KEYS
        pinned; identical shape when disabled)."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "spans_recorded": self._recorded,
                "spans_dropped": self._dropped,
                "ring_occupancy": len(self._ring),
                "ring_capacity": self.capacity,
            }

    def debug_traces(self):
        """The ``/debug/traces`` JSON body. ``wall_time`` is this
        replica's clock at render time — the reading the assembler
        pairs with its own request/response stamps to bound skew."""
        with self._lock:
            spans = [s.as_dict() for s in self._ring]
        return {
            "replica_id": self.replica_id,
            "wall_time": round(time.time(), 6),
            "state": self.snapshot(),
            "spans": spans,
        }
