"""Router: fault-tolerant dispatch across N engine replicas (a port of
``paddle_tpu/serving/router/core.py``).

  * **admission** — bounded router queue (``max_queue`` — never
    unbounded buffering); a request is refused with an explicit shed
    verdict when the queue is full or no replica is admissible.
    ``down``/``stale``, draining, degraded and unhealthy replicas never
    receive NEW requests;
  * **placement** — least-loaded by ``queue_depth`` (probed off each
    transport's ``/debug/state``) plus the router's own in-flight
    count, with prefix affinity: prompts are fingerprinted with the
    SAME stable ``path_fingerprint`` chain the radix cache uses, and a
    replica the router's sticky placement memory (or a replica's
    reported heat table) names keeps the prefix — unless it is
    overloaded past ``affinity_spill``;
  * **robustness** — per-replica circuit breakers, bounded
    retry/failover with exponential backoff + deterministic seeded
    jitter (``backoff_jitter_unit``), an in-flight journal mirroring
    the supervisor's ``prefill_ids`` replay discipline (replica death →
    re-dispatch ``prompt + tokens_so_far`` to a healthy peer, bit-exact
    under greedy decoding), remaining-deadline propagation into engine
    ``add_request(deadline_ms=)``, and optional tail-latency hedging
    (OFF by default): a second dispatch after a p99-derived delay,
    first result wins, the loser is cancelled (in-process) or
    abandoned (wire) and both outcomes counted.

Router state — breaker states, per-replica dispatch/failure counters,
journal depth, shed/retry/failover/hedge totals — lives on the
router's own MetricsRegistry and the ``/router/state`` route
(``router.serve()``).

**Disaggregated serving**: replicas advertise a ``role`` in their debug
state (``prefill`` / ``decode`` / ``monolithic``). When an admissible
prefill-role replica exists, a fresh request takes the two-hop path:
hop 1 dispatches ``transport.prefill`` to the least-loaded prefill
replica (prompt KV + first token, serialized as wire blocks); the first
token is journaled BEFORE any decode dispatch, so a prefill death
anywhere after hop 1 replays bit-exact from ``prefill_ids`` on a
survivor. Hop 2 binds the payload on a decode owner picked by the same
affinity + spill margin as monolithic placement. Every fallback edge —
refused import, decode death mid-stream, no decode tier left — lands in
the ordinary monolithic retry machinery, which continues from the
journal without regenerating committed tokens.

A ``FleetPoller`` (``observability/fleet/poller.py``) given as
``poller`` supplies each replica's posture and verdict, which feed its
breaker; a replica the poller does not know, or a router built with
``poller=None``, is probed through its transport directly.
"""
import itertools
import threading
import time

from ...observability.fleet import backoff_jitter_unit
from ...observability.registry import (MetricsRegistry, Reservoir,
                                       start_metrics_server)
from ...observability.trace import TraceContext, TraceRecorder
from ..kv_wire import payload_wire_bytes
from ..paged.radix import path_fingerprint
from ..resilience.chaos import InjectedFault, resolve_chaos
from .breaker import CircuitBreaker
from .journal import RequestJournal
from .transport import TransportError, TransportRefused

__all__ = ["RouterConfig", "Router", "RouterTicket",
           "prompt_fingerprints", "ROUTER_STATE_KEYS"]

_tag_seq = itertools.count()


def _accepts_kw(fn, name):
    """Whether ``fn`` takes keyword ``name`` — trace propagation is
    additive: a transport that predates the field (scripted test
    doubles, third-party shims) is simply called without it."""
    import inspect
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    return name in params or any(
        p.kind == inspect.Parameter.VAR_KEYWORD
        for p in params.values())

# /router/state top-level schema (pinned by tests/test_router.py)
ROUTER_STATE_KEYS = (
    "config", "counters", "disagg", "hedge", "journal",
    "journal_depth", "replicas",
)


def prompt_fingerprints(prompt, block_size):
    """The prompt's root->block fingerprint chain — the same stable
    crc32 path fingerprints the radix index stamps into the heat
    digest, computed router-side without ever shipping raw tokens.
    Only whole blocks fingerprint (the cache shares whole blocks)."""
    fps = []
    fp = 0
    prompt = [int(t) for t in prompt]
    for i in range(0, (len(prompt) // block_size) * block_size,
                   block_size):
        fp = path_fingerprint(fp, tuple(prompt[i:i + block_size]))
        fps.append(fp)
    return fps


class RouterConfig:
    """Router policy knobs, ServingConfig-style, validated eagerly. The
    reference's ``PADDLE_ROUTER_MAX_RETRIES`` / ``PADDLE_ROUTER_HEDGE``
    environment defaults have no counterpart: 2 retries, no hedging."""

    def __init__(self, max_queue=64, max_retries=2,
                 backoff_base_s=0.05, backoff_max_s=2.0,
                 backoff_jitter=0.5, seed=0,
                 breaker_threshold=3, breaker_reset_s=1.0,
                 refresh_s=0.25, affinity=True, affinity_block=16,
                 affinity_spill=4, hedge=False, hedge_factor=1.5,
                 hedge_min_s=0.05, default_deadline_ms=None):
        # retry/failover budget: attempts = 1 + max_retries
        self.max_retries = int(max_retries)
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {max_retries}")
        self.max_queue = int(max_queue)
        if self.max_queue < 1:
            raise ValueError(
                f"max_queue must be >= 1, got {max_queue}")
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        if not 0.0 <= float(backoff_jitter) <= 1.0:
            raise ValueError(
                f"backoff_jitter must be in [0, 1], "
                f"got {backoff_jitter}")
        self.backoff_jitter = float(backoff_jitter)
        self.seed = seed
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_reset_s = float(breaker_reset_s)
        self.refresh_s = float(refresh_s)
        if self.refresh_s <= 0:
            raise ValueError(
                f"refresh_s must be > 0, got {refresh_s}")
        self.affinity = bool(affinity)
        self.affinity_block = int(affinity_block)
        if self.affinity_block < 1:
            raise ValueError(
                f"affinity_block must be >= 1, got {affinity_block}")
        self.affinity_spill = int(affinity_spill)
        # tail-latency hedging: OFF by default (a second dispatch is
        # real capacity spent; opt in per router)
        self.hedge = bool(hedge)
        self.hedge_factor = float(hedge_factor)
        self.hedge_min_s = float(hedge_min_s)
        if self.hedge_min_s < 0:
            raise ValueError(
                f"hedge_min_s must be >= 0, got {hedge_min_s}")
        self.default_deadline_ms = default_deadline_ms

    def describe(self):
        return {
            "max_queue": self.max_queue,
            "max_retries": self.max_retries,
            "backoff_base_s": self.backoff_base_s,
            "backoff_jitter": self.backoff_jitter,
            "breaker_threshold": self.breaker_threshold,
            "breaker_reset_s": self.breaker_reset_s,
            "refresh_s": self.refresh_s,
            "affinity": self.affinity,
            "affinity_block": self.affinity_block,
            "hedge": self.hedge,
        }


class RouterTicket:
    """Handle for one routed request: ``result(timeout)`` blocks for
    the RouterResult dict ({ok, shed, reason, tokens, replica_id,
    attempts, failovers, hedged, ...})."""

    def __init__(self, rid):
        self.rid = rid
        self._done = threading.Event()
        self._result = None

    def _finish(self, result):
        self._result = result
        self._done.set()

    @property
    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"routed request {self.rid} still in flight")
        return self._result


class Router:
    def __init__(self, transports, poller=None, config=None,
                 registry=None, chaos=False, clock=time.monotonic):
        self.config = config if config is not None else RouterConfig()
        self._clock = clock
        self.poller = poller
        # seeded fault plans at the router's own seam
        # (``router_dispatch``): an armed injector fails dispatches
        # deterministically BEFORE they reach a replica — the chaos
        # input the retry/failover/breaker machinery is drilled with.
        # False (or None) = off.
        self.chaos = resolve_chaos(chaos)
        self.transports = {}
        for i, t in enumerate(transports):
            rid = getattr(t, "replica_id", None) or f"r{i}"
            if rid in self.transports:
                raise ValueError(f"duplicate replica_id {rid!r}")
            self.transports[rid] = t
        if not self.transports:
            raise ValueError("Router needs at least one transport")
        self.breakers = {
            rid: CircuitBreaker(
                threshold=self.config.breaker_threshold,
                reset_s=self.config.breaker_reset_s)
            for rid in self.transports}
        self.journal = RequestJournal()
        # distributed tracing: the router MINTS each request's
        # TraceContext at admission and records its own hop spans
        # (router/queue, router/dispatch, kv/wire, retry/failover/
        # hedge annotations, plus the router/request root) into this
        # ring, served at /router/trace
        self.trace = TraceRecorder("router")
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        r = self.registry
        self._c_requests = r.counter(
            "router_requests_total", "routed requests by outcome",
            labelnames=("outcome",))
        self._c_shed = r.counter(
            "router_shed_total",
            "requests refused at admission, by shed verdict",
            labelnames=("reason",))
        self._c_dispatch = r.counter(
            "router_dispatches_total", "dispatch attempts per replica",
            labelnames=("replica",))
        self._c_dispatch_fail = r.counter(
            "router_dispatch_failures_total",
            "failed dispatch attempts per replica by kind "
            "(error charges the breaker, refused does not)",
            labelnames=("replica", "kind"))
        self._c_retries = r.counter(
            "router_retries_total", "dispatch retries (backoff slept)")
        self._c_failovers = r.counter(
            "router_failovers_total",
            "re-dispatches that moved a request to a different "
            "replica")
        self._c_hedges = r.counter(
            "router_hedges_total", "hedge dispatches launched")
        self._c_hedge_wins = r.counter(
            "router_hedge_wins_total", "hedged races by winner",
            labelnames=("winner",))
        self._c_hedge_losers = r.counter(
            "router_hedge_losers_total",
            "hedge losers by disposition (cancelled: replica freed; "
            "abandoned: result discarded, replica ran to completion)",
            labelnames=("disposition",))
        self._c_breaker_trans = r.counter(
            "router_breaker_transitions_total",
            "circuit-breaker state entries per replica",
            labelnames=("replica", "to"))
        self._g_journal = r.gauge(
            "router_journal_depth",
            "in-flight routed requests (journal entries)")
        self._g_breaker = r.gauge(
            "router_breaker_state",
            "breaker state per replica (0 closed, 1 half-open, "
            "2 open)", labelnames=("replica",))
        self._h_latency = r.histogram(
            "router_request_latency_seconds",
            "end-to-end routed request latency")
        self._c_handoffs = r.counter(
            "router_kv_handoffs_total",
            "prefill->decode KV handoffs by outcome (ok, or the "
            "fallback edge that sent the request monolithic)",
            labelnames=("outcome",))
        self._c_wire_bytes = r.counter(
            "router_kv_wire_bytes_total",
            "raw K+V tile bytes shipped prefill->decode "
            "(pre-base64, completed handoffs only)")
        self._c_wire_tokens = r.counter(
            "router_kv_wire_tokens_total",
            "prompt tokens whose KV shipped prefill->decode "
            "(completed handoffs only)")
        self._h_handoff = r.histogram(
            "router_kv_handoff_seconds",
            "two-hop TTFT cost: prefill hop wall + decode-side "
            "bind wall (the monolithic-TTFT comparable)")
        self._c_overhead_s = r.counter(
            "router_overhead_seconds_total",
            "wall seconds spent in router bookkeeping (admission, "
            "placement, journal, commit) — excludes waiting on "
            "replicas")
        self._c_overhead_ops = r.counter(
            "router_overhead_ops_total",
            "bookkeeping sections timed into "
            "router_overhead_seconds_total")
        self._latencies = Reservoir(capacity=512, seed=self.config.seed
                                    if isinstance(self.config.seed,
                                                  int) else 0)
        self._lock = threading.RLock()
        self._posture = {}
        self._last_refresh = None
        self._inflight = {rid: 0 for rid in self.transports}
        self._sticky = {}          # fingerprint -> replica_id
        self._stats = {"ok": 0, "error": 0, "shed": 0, "retries": 0,
                       "failovers": 0, "hedges": 0, "hedge_wins": 0,
                       "handoffs": 0, "handoff_failures": 0,
                       "wire_bytes": 0, "wire_tokens": 0}
        self._closed = False
        self._threads = []
        self._servers = []

    # ---------------------------------------------------- posture
    def refresh(self, force=False):
        """Refresh the per-replica posture map (verdict, draining,
        degraded, healthy, queue_depth, heat table), TTL-cached at
        ``refresh_s`` — the router's "one poll interval". Feeds every
        breaker its replica's poller verdict."""
        now = self._clock()
        with self._lock:
            if (not force and self._last_refresh is not None
                    and now - self._last_refresh < self.config.refresh_s):
                return
            self._last_refresh = now
            by_replica = {}
            if self.poller is not None:
                for st in self.poller.replicas:
                    by_replica[st.replica_id] = st
                    by_replica[st.url] = st
            for rid, t in self.transports.items():
                st = by_replica.get(rid) \
                    or by_replica.get(getattr(t, "url", None))
                if st is not None:
                    self._posture[rid] = self._posture_from_poller(st)
                else:
                    self._posture[rid] = self._probe(t)
                verdict = self._posture[rid].get("verdict")
                if verdict:
                    self.breakers[rid].note_verdict(verdict, now)
                self._export_breaker(rid)

    @staticmethod
    def _posture_from_poller(st):
        health = st.health or {}
        state = st.state or {}
        heat = ((state.get("cache") or {}).get("heat")
                or {}).get("top") or []
        return {
            "verdict": st.verdict,
            "draining": bool(health.get("draining")),
            "degraded": bool(health.get("degraded")),
            "healthy": health.get("healthy"),
            "role": state.get("role") or "monolithic",
            "queue_depth": state.get("queue_depth") or 0,
            "heat": {e["fp"]: e.get("tokens_saved", 0)
                     for e in heat},
        }

    @staticmethod
    def _probe(t):
        try:
            health = t.health() or {}
            state = t.state() or {}
        except TransportError as e:
            return {"verdict": "down", "error": str(e)[:160],
                    "queue_depth": 0, "heat": {}}
        heat = ((state.get("cache") or {}).get("heat")
                or {}).get("top") or []
        return {
            "verdict": "up",
            "draining": bool(health.get("draining")),
            "degraded": bool(health.get("degraded")),
            "healthy": health.get("healthy"),
            "role": state.get("role") or "monolithic",
            "queue_depth": state.get("queue_depth") or 0,
            "heat": {e["fp"]: e.get("tokens_saved", 0)
                     for e in heat},
        }

    @staticmethod
    def _admissible(posture):
        if posture.get("verdict") in ("down", "stale"):
            return False
        if posture.get("draining") or posture.get("degraded"):
            return False
        if posture.get("healthy") is False:
            return False
        return True

    def _export_breaker(self, rid):
        br = self.breakers[rid]
        level = {"closed": 0, "half_open": 1, "open": 2}[br.state]
        self._g_breaker.labels(rid).set(level)

    # --------------------------------------------------- placement
    @staticmethod
    def _best_scored(scores):
        """Deterministic argmax over affinity scores: highest score
        wins, replica-id order breaks ties. The ONE tie-break site —
        placement must never depend on dict insertion order (posture
        maps are rebuilt per refresh in whatever order transports
        answered)."""
        return min(scores, key=lambda r: (-scores[r], str(r)))

    def _select(self, fps, excluded, now):
        """One placement decision: admissible (posture + breaker)
        candidates, failover preference (``excluded`` last), affinity
        first unless the affinity replica is overloaded, else least
        loaded. Prefill-role replicas never serve generate/decode
        dispatches — role is a routing posture, and the prefill tier's
        capacity is reserved for hop-1 work. Returns a replica id or
        None."""
        with self._lock:
            cands = []
            for rid in self.transports:
                posture = self._posture.get(rid) or {}
                if posture.get("role") == "prefill":
                    continue
                if not self._admissible(posture):
                    continue
                if not self.breakers[rid].allow(now):
                    continue
                cands.append(rid)
            if not cands:
                return None
            fresh = [r for r in cands if r not in excluded]
            pool = fresh or cands   # single-replica fleets may retry
            load = {r: ((self._posture.get(r) or {})
                        .get("queue_depth") or 0)
                    + self._inflight[r] for r in pool}
            floor = min(load.values())
            choice = None
            if self.config.affinity and fps:
                scores = {}
                for r in pool:
                    heat = (self._posture.get(r) or {}).get("heat") \
                        or {}
                    s = sum(heat.get(fp, 0) for fp in fps)
                    for depth, fp in enumerate(fps):
                        if self._sticky.get(fp) == r:
                            s += depth + 1
                    if s > 0:
                        scores[r] = s
                if scores:
                    best = self._best_scored(scores)
                    if load[best] <= floor + self.config.affinity_spill:
                        choice = best
            if choice is None:
                choice = min(sorted(pool), key=lambda r: load[r])
            self.breakers[choice].claim(now)
            self._inflight[choice] += 1
            return choice

    def _select_prefill(self, excluded, now):
        """Hop-1 placement: least-loaded admissible prefill-role
        replica whose transport speaks the handoff protocol. None
        when no prefill tier exists (or it is all down/excluded) —
        the caller falls back to the monolithic path."""
        with self._lock:
            cands = []
            for rid, t in self.transports.items():
                posture = self._posture.get(rid) or {}
                if posture.get("role") != "prefill":
                    continue
                if rid in excluded:
                    continue
                if not hasattr(t, "prefill"):
                    continue
                if not self._admissible(posture):
                    continue
                if not self.breakers[rid].allow(now):
                    continue
                cands.append(rid)
            if not cands:
                return None
            load = {r: ((self._posture.get(r) or {})
                        .get("queue_depth") or 0)
                    + self._inflight[r] for r in cands}
            choice = min(sorted(cands), key=lambda r: load[r])
            self.breakers[choice].claim(now)
            self._inflight[choice] += 1
            return choice

    def _note_handoff(self, outcome, wire_bytes=0, wire_tokens=0):
        self._c_handoffs.labels(outcome).inc()
        if wire_bytes:
            self._c_wire_bytes.inc(wire_bytes)
        if wire_tokens:
            self._c_wire_tokens.inc(wire_tokens)
        with self._lock:
            if outcome == "ok":
                self._stats["handoffs"] += 1
                self._stats["wire_bytes"] += wire_bytes
                self._stats["wire_tokens"] += wire_tokens
            else:
                self._stats["handoff_failures"] += 1

    def _release(self, rid):
        with self._lock:
            self._inflight[rid] = max(0, self._inflight[rid] - 1)

    def _note_sticky(self, fps, rid):
        with self._lock:
            for fp in fps:
                self._sticky[fp] = rid
            while len(self._sticky) > 4096:
                self._sticky.pop(next(iter(self._sticky)))

    # --------------------------------------------------- breaker IO
    def _breaker_failure(self, rid):
        now = self._clock()
        with self._lock:
            br = self.breakers[rid]
            before = br.state
            br.record_failure(now)
            if br.state != before:
                self._c_breaker_trans.labels(rid, br.state).inc()
            self._export_breaker(rid)

    def _breaker_success(self, rid):
        with self._lock:
            br = self.breakers[rid]
            before = br.state
            br.record_success()
            if br.state != before:
                self._c_breaker_trans.labels(rid, br.state).inc()
            self._export_breaker(rid)

    # ---------------------------------------------------- admission
    def submit(self, prompt, max_new_tokens, eos_id=None,
               deadline_ms=None, tag=None, tenant_id=None):
        """Admit and route one request; returns a RouterTicket
        immediately (the dispatch runs on a worker thread). A shed
        verdict resolves the ticket synchronously with
        ``{"shed": True, "reason": ...}`` — the caller always gets an
        explicit answer, never silent buffering.

        ``tenant_id`` (default ``"default"``) attributes the request
        fleet-wide: minted into the trace baggage here at admission,
        it rides every dispatch attempt — both disaggregation hops,
        the KV handoff, and failover replays from the journal — so
        every engine bills the same tenant the router admitted."""
        t0 = time.perf_counter()
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        tag = tag if tag is not None else f"q{next(_tag_seq)}"
        ticket = RouterTicket(tag)
        if self._closed:
            return self._shed(ticket, "router_closed", t0)
        if self.journal.depth >= self.config.max_queue:
            return self._shed(ticket, "queue_full", t0)
        self.refresh()
        now = self._clock()
        with self._lock:
            # a prefill-only fleet cannot complete a request: the
            # admission gate asks for a replica that can OWN one
            any_admissible = any(
                self._admissible(self._posture.get(rid) or {})
                and (self._posture.get(rid) or {}).get("role")
                != "prefill"
                and self.breakers[rid].allow(now)
                for rid in self.transports)
        if not any_admissible:
            return self._shed(ticket, "no_admissible_replica", t0)
        # admission mints the request's distributed TraceContext:
        # every dispatch attempt — including failover replays from
        # the journal — carries the SAME trace id fleet-wide, and the
        # tenant rides its baggage so replayed work bills the same
        # tenant as the original attempt
        tenant = str(tenant_id) if tenant_id else "default"
        entry = self.journal.admit(tag, [int(t) for t in prompt],
                                   max_new_tokens, eos_id,
                                   deadline_ms, now,
                                   trace=TraceContext.mint(
                                       baggage={"rid": tag,
                                                "tenant": tenant}),
                                   tenant=tenant)
        self._g_journal.set(self.journal.depth)
        self._account_overhead(t0)
        worker = threading.Thread(
            target=self._drive, args=(entry, ticket, t0), daemon=True,
            name=f"router-{tag}")
        with self._lock:
            self._threads.append(worker)
            del self._threads[:-256]
        worker.start()
        return ticket

    def generate(self, prompt, max_new_tokens, eos_id=None,
                 deadline_ms=None, timeout=None, tenant_id=None):
        """Blocking convenience: submit + result."""
        return self.submit(prompt, max_new_tokens, eos_id=eos_id,
                           deadline_ms=deadline_ms,
                           tenant_id=tenant_id).result(timeout)

    def _shed(self, ticket, reason, t0):
        self._c_shed.labels(reason).inc()
        self._c_requests.labels("shed").inc()
        with self._lock:
            self._stats["shed"] += 1
        self._account_overhead(t0)
        ticket._finish({"rid": ticket.rid, "ok": False, "shed": True,
                        "reason": reason, "tokens": [],
                        "replica_id": None, "attempts": 0,
                        "failovers": 0, "hedged": False})
        return ticket

    def _account_overhead(self, t0):
        self._c_overhead_s.inc(time.perf_counter() - t0)
        self._c_overhead_ops.inc()

    # ------------------------------------------------------ dispatch
    def _remaining_ms(self, entry):
        if entry.deadline_ms is None:
            return None
        elapsed = (self._clock() - entry.t_admitted) * 1000.0
        return entry.deadline_ms - elapsed

    def _drive(self, entry, ticket, t_submit=None):
        t_start = time.perf_counter()
        # router/queue: admission -> this worker picking the entry up
        if t_submit is not None:
            self.trace.record(entry.trace, "router/queue",
                              self.trace.wall(t_submit),
                              t_start - t_submit,
                              {"rid": entry.rid})
        fps = prompt_fingerprints(entry.prompt,
                                  self.config.affinity_block) \
            if self.config.affinity else []
        excluded = set()
        failures = 0
        failovers = 0
        hedged = False
        hedge_winner = None
        last_error = "no_healthy_replica"
        while True:
            remaining = self._remaining_ms(entry)
            if remaining is not None and remaining <= 0:
                return self._finish_error(entry, ticket, "deadline",
                                          failures, failovers, hedged,
                                          t_start)
            # ------------------------- disaggregated two-hop path
            # Fresh entries only: once ANY token is committed, the
            # journal's prefill_ids continuation on a monolithic
            # dispatch is strictly better than re-prefilling for
            # export. finished=True → the helper resolved the
            # ticket; False → fall through to the monolithic
            # machinery (possibly with hop-1 tokens journaled).
            if not entry.tokens:
                finished, failures, failovers, last_error = \
                    self._drive_disagg(entry, ticket, fps, excluded,
                                       failures, failovers, hedged,
                                       t_start, last_error)
                if finished:
                    return
                if failures > self.config.max_retries:
                    return self._finish_error(
                        entry, ticket, last_error, failures,
                        failovers, hedged, t_start)
            t_bk = time.perf_counter()
            now = self._clock()
            self.refresh()
            rid = self._select(fps, excluded, now)
            self._account_overhead(t_bk)
            if rid is None:
                failures += 1
                last_error = "no_healthy_replica"
                if failures > self.config.max_retries:
                    return self._finish_error(
                        entry, ticket, last_error, failures,
                        failovers, hedged, t_start)
                self._c_retries.inc()
                with self._lock:
                    self._stats["retries"] += 1
                self._backoff(entry.rid, failures, ctx=entry.trace)
                self.refresh(force=True)
                continue
            self.trace.record(entry.trace, "router/dispatch",
                              self.trace.wall(t_bk),
                              time.perf_counter() - t_bk,
                              {"rid": entry.rid, "replica": rid})
            # a failover is counted by what actually happened: this
            # dispatch goes to a DIFFERENT replica than the previous
            # attempt (refused / errored / died / shed — the cause
            # has its own counter)
            if entry.replica is not None and entry.replica != rid:
                failovers += 1
                self._c_failovers.inc()
                with self._lock:
                    self._stats["failovers"] += 1
                # the span that LINKS a failed attempt's spans to the
                # replay's: same trace id, annotated with the move
                self.trace.record(entry.trace, "router/failover",
                                  time.time(), 0.0,
                                  {"rid": entry.rid,
                                   "from": entry.replica, "to": rid,
                                   "attempt": entry.attempts + 1})
            entry.replica = rid
            entry.attempts += 1
            base = len(entry.tokens)
            self._c_dispatch.labels(rid).inc()
            calls = []
            try:
                calls.append(self._begin(rid, entry, remaining))
            except TransportRefused as e:
                self._release(rid)
                self._c_dispatch_fail.labels(rid, "refused").inc()
                excluded.add(rid)
                last_error = f"refused: {e}"[:160]
                continue
            except TransportError as e:
                self._release(rid)
                self._c_dispatch_fail.labels(rid, "error").inc()
                self._breaker_failure(rid)
                excluded.add(rid)
                failures += 1
                last_error = str(e)[:160]
                if failures > self.config.max_retries:
                    return self._finish_error(
                        entry, ticket, last_error, failures,
                        failovers, hedged, t_start)
                self._c_retries.inc()
                with self._lock:
                    self._stats["retries"] += 1
                self._backoff(entry.rid, failures, ctx=entry.trace)
                self.refresh(force=True)
                continue
            # optional tail-latency hedge: one extra dispatch to a
            # different replica once the primary overstays the
            # p99-derived delay; first result wins
            if self.config.hedge and not hedged:
                self._maybe_hedge(entry, remaining, excluded, calls)
                hedged = len(calls) > 1
            outcome = self._await_first(entry, calls, remaining)
            for _rid_l, call_l, _buf_l in calls:
                self._release(_rid_l)
            if outcome is None:           # every call failed
                for rid_f, _call_f, buf_f in calls:
                    excluded.add(rid_f)
                    if buf_f:   # partial greedy prefix is committed —
                        # the failover continues, never regenerates
                        self.journal.commit(entry, base, buf_f)
                failures += 1
                last_error = "dispatch_failed"
                if failures > self.config.max_retries:
                    return self._finish_error(
                        entry, ticket, last_error, failures,
                        failovers, hedged, t_start)
                self._c_retries.inc()
                with self._lock:
                    self._stats["retries"] += 1
                self._backoff(entry.rid, failures, ctx=entry.trace)
                self.refresh(force=True)
                continue
            rid_won, res, buf = outcome
            if hedged:
                hedge_winner = "hedge" if rid_won != rid else "primary"
                self._c_hedge_wins.labels(hedge_winner).inc()
                with self._lock:
                    self._stats["hedge_wins"] += 1
                for rid_l, call_l, _buf_l in calls:
                    if call_l.done and rid_l == rid_won:
                        continue
                    disposition = "cancelled" if call_l.cancel() \
                        else "abandoned"
                    self._c_hedge_losers.labels(disposition).inc()
            if res.get("shed_reason"):
                # the REPLICA shed it (zero tokens, clean verdict):
                # not a transport failure — fail over without
                # charging the breaker
                excluded.add(rid_won)
                last_error = f"replica_shed: {res['shed_reason']}"
                if len(excluded) >= len(self.transports):
                    return self._finish_error(
                        entry, ticket, last_error, failures,
                        failovers, hedged, t_start)
                continue
            t_bk = time.perf_counter()
            tokens = res.get("tokens") or []
            commit = tokens if len(tokens) >= len(buf) else buf
            self.journal.commit(entry, base, commit)
            self._breaker_success(rid_won)
            if fps:
                self._note_sticky(fps, rid_won)
            self._account_overhead(t_bk)
            return self._finish_ok(entry, ticket, rid_won, failures,
                                   failovers, hedged, hedge_winner,
                                   t_start)

    def _retry_pause(self, entry, failures):
        self._c_retries.inc()
        with self._lock:
            self._stats["retries"] += 1
        self._backoff(entry.rid, failures, ctx=entry.trace)
        self.refresh(force=True)

    def _drive_disagg(self, entry, ticket, fps, excluded, failures,
                      failovers, hedged, t_start, last_error):
        """The two-hop path for a fresh entry. Returns ``(finished,
        failures, failovers, last_error)``: finished=True means the
        ticket is resolved; False means fall back to the monolithic
        machinery in ``_drive`` — with the first token (and any
        partial decode stream) already journaled when hop 1 ever
        completed, so the fallback CONTINUES, never regenerates.
        Hedging never applies here (a handoff is already two
        dispatches of real capacity)."""
        pf_excluded = set()
        while True:                                    # ---- hop 1
            remaining = self._remaining_ms(entry)
            if remaining is not None and remaining <= 0:
                self._finish_error(entry, ticket, "deadline",
                                   failures, failovers, hedged,
                                   t_start)
                return (True, failures, failovers, "deadline")
            t_bk = time.perf_counter()
            now = self._clock()
            self.refresh()
            pf_rid = self._select_prefill(pf_excluded, now)
            self._account_overhead(t_bk)
            if pf_rid is None:
                # no prefill tier (or none left): not a handoff
                # failure, just a monolithic fleet from here on
                return (False, failures, failovers, last_error)
            # the ONE router/dispatch span of a two-hop trace: hop-1
            # placement (hop-2 placement time lands inside kv/wire —
            # tiling the segments keeps the TTFT decomposition
            # overlap-free)
            self.trace.record(entry.trace, "router/dispatch",
                              self.trace.wall(t_bk),
                              time.perf_counter() - t_bk,
                              {"rid": entry.rid, "replica": pf_rid,
                               "hop": "prefill"})
            if entry.replica is not None and entry.replica != pf_rid:
                self.trace.record(entry.trace, "router/failover",
                                  time.time(), 0.0,
                                  {"rid": entry.rid,
                                   "from": entry.replica,
                                   "to": pf_rid,
                                   "attempt": entry.attempts + 1})
            entry.replica = pf_rid
            entry.attempts += 1
            self._c_dispatch.labels(pf_rid).inc()
            t_hop = time.perf_counter()
            pf_fn = self.transports[pf_rid].prefill
            pf_kw = {"deadline_ms": remaining}
            if _accepts_kw(pf_fn, "trace"):
                pf_kw["trace"] = entry.trace
            try:
                pf = pf_fn(entry.prompt, **pf_kw)
            except TransportRefused as e:
                self._release(pf_rid)
                self._c_dispatch_fail.labels(pf_rid, "refused").inc()
                pf_excluded.add(pf_rid)
                last_error = f"refused: {e}"[:160]
                continue
            except TransportError as e:
                self._release(pf_rid)
                self._c_dispatch_fail.labels(pf_rid, "error").inc()
                self._breaker_failure(pf_rid)
                self._note_handoff("prefill_died")
                pf_excluded.add(pf_rid)
                failures += 1
                last_error = str(e)[:160]
                if failures > self.config.max_retries:
                    return (False, failures, failovers, last_error)
                self._retry_pause(entry, failures)
                continue
            self._release(pf_rid)
            hop1_s = time.perf_counter() - t_hop
            t_wire0 = time.time()
            break
        first = int(pf["first_token"])
        handoff = pf["handoff"]
        # THE journaled handoff: the first token commits before any
        # decode dispatch, so a prefill SIGKILL from here on replays
        # bit-exact from prefill_ids on any survivor
        self.journal.commit(entry, 0, [first])
        self._breaker_success(pf_rid)
        dec_prev = None
        refusals = 0
        while True:                                    # ---- hop 2
            remaining = self._remaining_ms(entry)
            if remaining is not None and remaining <= 0:
                self._note_handoff("deadline")
                self._finish_error(entry, ticket, "deadline",
                                   failures, failovers, hedged,
                                   t_start)
                return (True, failures, failovers, "deadline")
            t_bk = time.perf_counter()
            now = self._clock()
            self.refresh()
            drid = self._select(fps, excluded, now)
            self._account_overhead(t_bk)
            if drid is None or not hasattr(
                    self.transports[drid], "decode_import"):
                if drid is not None:
                    self._release(drid)
                    excluded.add(drid)
                # the handoff has no taker: orphan it, let the
                # monolithic machinery (continuing from the
                # committed first token) own retries/shed
                self._note_handoff("orphaned")
                failures += 1
                last_error = "no_decode_replica"
                return (False, failures, failovers, last_error)
            if dec_prev is not None and dec_prev != drid:
                failovers += 1
                self._c_failovers.inc()
                with self._lock:
                    self._stats["failovers"] += 1
                self.trace.record(entry.trace, "router/failover",
                                  time.time(), 0.0,
                                  {"rid": entry.rid,
                                   "from": dec_prev, "to": drid,
                                   "attempt": entry.attempts + 1})
            dec_prev = drid
            entry.replica = drid
            entry.attempts += 1
            self._c_dispatch.labels(drid).inc()
            buf = []
            t_dec_call = time.time()
            try:
                res = self.transports[drid].decode_import(
                    handoff, entry.max_new_tokens,
                    eos_id=entry.eos_id, deadline_ms=remaining,
                    on_token=buf.append)
            except TransportRefused as e:
                # clean no (digest/shape drift, full pool,
                # draining): pool untouched, breaker unchanged —
                # try the next decode owner with the same payload.
                # A whole fleet refusing twice over means congestion,
                # not damage: hand the entry to the monolithic
                # fallback, whose dispatch QUEUES engine-side
                # instead of racing imports for free slots
                self._release(drid)
                self._c_dispatch_fail.labels(drid, "refused").inc()
                excluded.add(drid)
                last_error = f"refused: {e}"[:160]
                refusals += 1
                if refusals >= 2 * len(self.transports):
                    self._note_handoff("congested")
                    return (False, failures, failovers, last_error)
                continue
            except TransportError as e:
                self._release(drid)
                self._c_dispatch_fail.labels(drid, "error").inc()
                self._breaker_failure(drid)
                self._note_handoff("decode_died")
                excluded.add(drid)
                failures += 1
                if buf:   # partial greedy prefix after the first
                    # token: committed, the fallback continues it
                    self.journal.commit(entry, 1, buf)
                last_error = str(e)[:160]
                if failures <= self.config.max_retries:
                    self._retry_pause(entry, failures)
                return (False, failures, failovers, last_error)
            self._release(drid)
            if res.get("shed_reason"):
                excluded.add(drid)
                last_error = f"replica_shed: {res['shed_reason']}"
                continue
            t_bk = time.perf_counter()
            # kv/wire: hop-1 return -> the (successful) hop-2 call.
            # Covers payload custody at the router, hop-2 placement
            # and any refused-import shopping — the wire leg of the
            # TTFT decomposition (kv/import on the decode replica
            # picks up from the call)
            self.trace.record(entry.trace, "kv/wire", t_wire0,
                              max(0.0, t_dec_call - t_wire0),
                              {"rid": entry.rid, "replica": drid,
                               "wire_bytes":
                                   payload_wire_bytes(handoff)})
            tokens = res.get("tokens") or []
            commit = tokens if len(tokens) >= 1 + len(buf) \
                else [first] + buf
            self.journal.commit(entry, 0, commit)
            self._breaker_success(drid)
            if fps:
                self._note_sticky(fps, drid)
            self._note_handoff("ok",
                               wire_bytes=payload_wire_bytes(handoff),
                               wire_tokens=len(entry.prompt))
            self._h_handoff.observe(
                hop1_s + float(res.get("bind_s") or 0.0))
            self._account_overhead(t_bk)
            self._finish_ok(entry, ticket, drid, failures, failovers,
                            hedged, None, t_start)
            return (True, failures, failovers, last_error)

    def _begin(self, rid, entry, remaining_ms):
        """One dispatch: prefill_ids continuation + remaining token
        budget + remaining deadline, tokens streamed into a
        per-dispatch buffer (committed only when this dispatch is
        the one the router keeps)."""
        if self.chaos is not None:
            try:
                self.chaos.maybe_raise("router_dispatch",
                                       replica=rid, rid=entry.rid)
            except InjectedFault as e:
                raise TransportError(str(e)) from e
        buf = []
        begin = self.transports[rid].begin
        kw = {"eos_id": entry.eos_id, "deadline_ms": remaining_ms,
              "on_token": buf.append}
        if _accepts_kw(begin, "trace"):
            kw["trace"] = entry.trace
        call = begin(entry.prefill_ids,
                     max(1, entry.remaining_tokens), **kw)
        return (rid, call, buf)

    def _maybe_hedge(self, entry, remaining_ms, excluded, calls):
        delay = self.hedge_delay_s()
        deadline = time.monotonic() + delay
        rid0, call0, _ = calls[0]
        while time.monotonic() < deadline:
            if call0.done:
                return
            time.sleep(0.001)
        now = self._clock()
        rid_h = self._select([], excluded | {rid0}, now)
        if rid_h is None or rid_h == rid0:
            if rid_h is not None:
                self._release(rid_h)
            return
        try:
            calls.append(self._begin(rid_h, entry, remaining_ms))
            self._c_hedges.inc()
            self._c_dispatch.labels(rid_h).inc()
            with self._lock:
                self._stats["hedges"] += 1
            self.trace.record(entry.trace, "router/hedge",
                              time.time(), 0.0,
                              {"rid": entry.rid, "primary": rid0,
                               "hedge": rid_h})
        except (TransportError, TransportRefused):
            self._release(rid_h)

    def _await_first(self, entry, calls, remaining_ms):
        """First completed call wins. Returns (rid, result, buffer)
        or None when every call failed (TransportError / refusal /
        timeout)."""
        timeout_at = None
        if remaining_ms is not None:
            timeout_at = time.monotonic() + remaining_ms / 1000.0 + 5.0
        live = list(calls)
        while live:
            for item in list(live):
                rid, call, buf = item
                if not call.done:
                    continue
                try:
                    return (rid, call.result(timeout=5.0), buf)
                except (TransportError, TransportRefused) as e:
                    kind = "refused" \
                        if isinstance(e, TransportRefused) else "error"
                    self._c_dispatch_fail.labels(rid, kind).inc()
                    if kind == "error":
                        self._breaker_failure(rid)
                    live.remove(item)
            if not live:
                return None
            if timeout_at is not None \
                    and time.monotonic() > timeout_at:
                for rid, call, _buf in live:
                    self._c_dispatch_fail.labels(rid, "error").inc()
                    self._breaker_failure(rid)
                    call.cancel()
                return None
            time.sleep(0.001)
        return None

    def _backoff(self, who, attempt, ctx=None):
        base = min(self.config.backoff_max_s,
                   self.config.backoff_base_s * (2 ** (attempt - 1)))
        stretch = 1.0 + self.config.backoff_jitter \
            * backoff_jitter_unit(self.config.seed, who, attempt)
        delay = min(self.config.backoff_max_s, base * stretch)
        t0 = time.time()
        time.sleep(delay)
        # the retry wall, annotated on the trace: backoff sleeps are
        # TTFT the client paid that no replica span accounts for
        self.trace.record(ctx, "router/retry", t0, time.time() - t0,
                          {"attempt": attempt})

    # ------------------------------------------------------- results
    def _finish_ok(self, entry, ticket, rid, failures, failovers,
                   hedged, hedge_winner, t_start):
        self.journal.complete(entry.rid)
        self._g_journal.set(self.journal.depth)
        latency = time.perf_counter() - t_start
        self._h_latency.observe(latency)
        self._latencies.add(latency)
        self._c_requests.labels("ok").inc()
        with self._lock:
            self._stats["ok"] += 1
        self.trace.record_root(
            entry.trace, "router/request", self.trace.wall(t_start),
            latency, {"rid": entry.rid, "outcome": "ok",
                      "replica": rid, "attempts": entry.attempts,
                      "failovers": failovers})
        remaining = self._remaining_ms(entry)
        ticket._finish({
            "rid": entry.rid, "ok": True, "shed": False,
            "reason": "deadline" if remaining is not None
            and remaining <= 0 else "ok",
            "tokens": list(entry.tokens), "replica_id": rid,
            "attempts": entry.attempts, "failures": failures,
            "failovers": failovers, "hedged": hedged,
            "hedge_winner": hedge_winner,
            "latency_s": round(latency, 6)})

    def _finish_error(self, entry, ticket, reason, failures,
                      failovers, hedged, t_start):
        self.journal.complete(entry.rid)
        self._g_journal.set(self.journal.depth)
        latency = time.perf_counter() - t_start
        self._h_latency.observe(latency)
        self._c_requests.labels("error").inc()
        with self._lock:
            self._stats["error"] += 1
        self.trace.record_root(
            entry.trace, "router/request", self.trace.wall(t_start),
            latency, {"rid": entry.rid, "outcome": reason,
                      "replica": entry.replica,
                      "attempts": entry.attempts,
                      "failovers": failovers})
        ticket._finish({
            "rid": entry.rid, "ok": False, "shed": False,
            "reason": reason, "tokens": list(entry.tokens),
            "replica_id": entry.replica,
            "attempts": entry.attempts, "failures": failures,
            "failovers": failovers, "hedged": hedged,
            "hedge_winner": None,
            "latency_s": round(latency, 6)})

    # -------------------------------------------------------- hedging
    def hedge_delay_s(self):
        """The hedge trigger: p99 of observed routed latency scaled
        by ``hedge_factor``, floored at ``hedge_min_s`` (cold start:
        the floor)."""
        p99 = self._latencies.percentile(99)
        if p99 is None:
            return self.config.hedge_min_s
        return max(self.config.hedge_min_s,
                   p99 * self.config.hedge_factor)

    # ----------------------------------------------------- telemetry
    def state(self):
        """The ``/router/state`` body (ROUTER_STATE_KEYS pinned)."""
        now = self._clock()
        with self._lock:
            replicas = []
            for rid in sorted(self.transports):
                posture = dict(self._posture.get(rid) or {})
                posture.pop("heat", None)
                replicas.append({
                    "replica_id": rid,
                    "posture": posture,
                    "admissible": self._admissible(
                        self._posture.get(rid) or {}),
                    "breaker": self.breakers[rid].describe(now),
                    "inflight": self._inflight[rid],
                })
            counters = dict(self._stats)
            prefill_tier = sorted(
                rid for rid in self.transports
                if (self._posture.get(rid) or {}).get("role")
                == "prefill")
        return {
            "config": self.config.describe(),
            "counters": counters,
            "disagg": {
                "prefill_replicas": prefill_tier,
                "handoffs": counters["handoffs"],
                "handoff_failures": counters["handoff_failures"],
                "wire_bytes": counters["wire_bytes"],
                "wire_tokens": counters["wire_tokens"],
            },
            "hedge": {"enabled": self.config.hedge,
                      "delay_s": round(self.hedge_delay_s(), 6)},
            "journal": self.journal.snapshot(),
            "journal_depth": self.journal.depth,
            "replicas": replicas,
        }

    def serve(self, port=0, addr="127.0.0.1"):
        """Expose the router's own registry + ``/router/state`` +
        ``/router/trace`` (the router's span ring)."""
        handle = start_metrics_server(
            self.registry, port=port, addr=addr,
            extra_routes={"/router/state": self.state,
                          "/router/trace": self.trace.debug_traces})
        self._servers.append(handle)
        return handle

    # ----------------------------------------------------- lifecycle
    def close(self, timeout=10.0):
        """Refuse new work, wait for in-flight dispatches, stop the
        state servers. Transports/replicas are NOT closed (the router
        does not own them)."""
        self._closed = True
        with self._lock:
            threads = list(self._threads)
        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        servers, self._servers = self._servers, []
        for h in servers:
            h.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
