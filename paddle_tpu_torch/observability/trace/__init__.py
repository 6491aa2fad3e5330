"""Distributed request tracing: the propagated context and the
per-process span ring (a port of ``paddle_tpu/observability/trace``).

  * :mod:`context` — a W3C-traceparent-style :class:`TraceContext`
    (trace_id, parent span id, baggage) minted by the router at
    admission and carried on every wire edge: the ``/v1/generate`` /
    ``/v1/prefill`` / ``/v1/import`` POST bodies and the router
    journal (so a failover replay appears as sibling spans of the dead
    attempt under one trace_id). ``TraceContext.coerce`` never raises:
    a request arriving with a missing or malformed context gets a
    locally minted root and keeps serving.
  * :mod:`spans` — per-process wall-anchored named spans
    (``router/queue``, ``router/dispatch``, ``router/failover``, ...)
    in a bounded ring, exposed at ``/router/trace`` on the router and
    ``/debug/traces`` on each engine replica;
  * :mod:`assembler` — the fleet-side :class:`TraceAssembler`: scrapes
    ``/debug/traces`` across replicas, joins spans by trace_id with
    per-replica clock-offset estimation (ordering inside the ambiguity
    window is flagged, never silently reordered), and renders the
    end-to-end timeline, a chrome://tracing export and the TTFT
    critical-path decomposition.
"""
from .context import TRACEPARENT_RE, TraceContext
from .spans import (CANONICAL_SEGMENTS, TRACE_SNAPSHOT_KEYS, TraceSpan,
                    TraceRecorder)
from .assembler import (AssembledTrace, TraceAssembler, chrome_trace,
                        ttft_breakdown)

__all__ = [
    "TraceContext", "TraceSpan", "TraceRecorder", "TraceAssembler",
    "AssembledTrace", "chrome_trace", "ttft_breakdown",
    "CANONICAL_SEGMENTS", "TRACE_SNAPSHOT_KEYS", "TRACEPARENT_RE",
]
