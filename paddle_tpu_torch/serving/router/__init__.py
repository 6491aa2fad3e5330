"""Fault-tolerant fleet router (a port of
``paddle_tpu/serving/router``): the client-facing front-end over N
serving-engine replicas::

      client ──► Router ──┬─► EngineGateway(engine A)   (in-process)
        submit/generate   ├─► POST /v1/generate ► replica B  (wire)
                          └─► POST /v1/generate ► replica C  (wire)

Pieces:

  * :class:`EngineGateway` (transport.py) — owns one engine's step
    loop + the ``POST /v1/generate`` wire surface;
  * :class:`InProcessTransport` / :class:`HTTPTransport` — how the
    router reaches a replica (same interface, sockets optional);
  * :class:`CircuitBreaker` (breaker.py) — per-replica
    closed→open→half-open distrust, driven by dispatch outcomes;
  * :class:`RequestJournal` (journal.py) — prompt + tokens-so-far
    per in-flight request: replica death → re-dispatch with bit-exact
    greedy continuation;
  * :class:`Router` (core.py) — admission (bounded queue, explicit
    shed verdicts, down/draining/degraded refused), load + affinity
    placement, bounded retry/failover with deterministic jittered
    backoff, optional first-wins hedging (OFF by default),
    ``/router/state`` + its own metrics registry, and the
    prefill → decode two-hop path over the KV wire.
"""
from .breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker
from .core import (ROUTER_STATE_KEYS, Router, RouterConfig,
                   RouterTicket, prompt_fingerprints)
from .journal import JournalEntry, RequestJournal
from .transport import (EngineGateway, HTTPTransport,
                        InProcessTransport, TransportError,
                        TransportRefused)

__all__ = [
    "Router", "RouterConfig", "RouterTicket", "ROUTER_STATE_KEYS",
    "prompt_fingerprints",
    "CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN",
    "RequestJournal", "JournalEntry",
    "EngineGateway", "InProcessTransport", "HTTPTransport",
    "TransportError", "TransportRefused",
]
