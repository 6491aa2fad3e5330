"""The per-engine tenant accounting ledger.

Design constraints, in order:

1. **Conservation.** Every accrual happens inside the ServingMetrics
   call that moves the matching GLOBAL counter (admission, first
   token, completion, shed, timeout, abort, prefix reuse), receiving
   the same request/verdict that call judged — so per-tenant sums
   equal the global counters exactly, not approximately. The SLO
   verdict in particular is the engine's OWN ``observe_request``
   result passed through, never re-derived here.
2. **Bounded cardinality.** At most ``max_tenants`` live tenant ids;
   the (max_tenants+1)-th unique id folds into ``OVERFLOW_TENANT``
   and bumps ``serving_tenant_overflow_total``. Folding happens
   BEFORE any registry label is minted, so the ``tenant=``-labelled
   families hold at most ``max_tenants + 1`` series no matter how
   adversarial the id stream is.
3. **Hot-path cost.** Per request lifecycle: a handful of dict/int
   ops and two reservoir adds — nothing per token, nothing per step.
"""
import threading

from ..registry import Reservoir

__all__ = [
    "DEFAULT_TENANT", "OVERFLOW_TENANT", "TENANT_ENTRY_KEYS",
    "TENANT_KEYS", "TenantLedger", "disabled_tenant_report",
]

DEFAULT_TENANT = "default"
OVERFLOW_TENANT = "~other"

# snapshot()["tenants"] schema (pinned in tests/test_observability.py):
# same key set whether the ledger is enabled or not
TENANT_KEYS = ("enabled", "max_tenants", "tenant_count", "overflow",
               "tenants")
# one per-tenant entry's key set (also pinned)
TENANT_ENTRY_KEYS = (
    "requests", "completed", "tokens_in", "tokens_out",
    "goodput_tokens", "attained", "attainment", "violations", "shed",
    "timeouts", "aborts", "cache_saved_tokens", "cache_saved_ms",
    "queued", "queue_wait", "ttft",
)

_QUANTILES = ((50, "p50"), (90, "p90"), (99, "p99"))


def _pct(reservoir):
    entry = {"count": reservoir.seen}
    for q, label in _QUANTILES:
        p = reservoir.percentile(q)
        entry[f"{label}_ms"] = None if p is None \
            else round(p * 1000.0, 3)
    return entry


class _Account:
    """One tenant's accrual cell (ints + two bounded reservoirs)."""

    __slots__ = ("requests", "completed", "tokens_in", "tokens_out",
                 "goodput_tokens", "attained", "violations", "shed",
                 "timeouts", "aborts", "cache_saved_tokens",
                 "cache_saved_ms", "queue_wait", "ttft")

    def __init__(self):
        self.requests = 0
        self.completed = 0
        self.tokens_in = 0
        self.tokens_out = 0
        self.goodput_tokens = 0
        self.attained = 0
        self.violations = {}          # dimension -> count
        self.shed = {}                # reason -> count
        self.timeouts = 0
        self.aborts = 0
        self.cache_saved_tokens = 0
        self.cache_saved_ms = 0.0
        self.queue_wait = Reservoir(512)
        self.ttft = Reservoir(512)


def disabled_tenant_report(max_tenants=0):
    """The ``snapshot()["tenants"]`` body of an engine with tenant
    accounting off — SAME key shape as the live report (schema
    contract), inert values."""
    return {
        "enabled": False,
        "max_tenants": int(max_tenants),
        "tenant_count": 0,
        "overflow": {"folded_events": 0},
        "tenants": {},
    }


class TenantLedger:
    """Bounded per-tenant accounting over a MetricsRegistry.

    ``registry`` gets the ``tenant=``-labelled Prometheus families
    (what the fleet federation sums); the ledger's own dicts feed the
    richer JSON report (reservoir percentiles, per-dimension
    violations, shed reasons). ``max_tenants=0`` disables the ledger
    entirely: every note_* is a no-op and ``report()`` returns the
    disabled shape.
    """

    def __init__(self, registry, max_tenants=32):
        self.max_tenants = int(max_tenants)
        self.enabled = self.max_tenants > 0
        self._lock = threading.Lock()
        self._accounts = {}
        self._overflow_events = 0
        self._queue_probe = None
        if not self.enabled:
            return
        r = registry
        self._c_requests = r.counter(
            "serving_tenant_requests_total",
            "requests admitted, by tenant", labelnames=("tenant",))
        self._c_completed = r.counter(
            "serving_tenant_completed_total",
            "requests completed, by tenant", labelnames=("tenant",))
        self._c_tokens_in = r.counter(
            "serving_tenant_tokens_in_total",
            "prompt tokens admitted, by tenant",
            labelnames=("tenant",))
        self._c_tokens_out = r.counter(
            "serving_tenant_tokens_out_total",
            "tokens generated by completed requests, by tenant",
            labelnames=("tenant",))
        self._c_goodput = r.counter(
            "serving_tenant_goodput_tokens_total",
            "tokens from SLO-met requests, by tenant",
            labelnames=("tenant",))
        self._c_attained = r.counter(
            "serving_tenant_slo_attained_total",
            "requests that met every configured SLO, by tenant",
            labelnames=("tenant",))
        self._c_violations = r.counter(
            "serving_tenant_slo_violations_total",
            "SLO violations, by tenant (summed over dimensions)",
            labelnames=("tenant",))
        self._c_shed = r.counter(
            "serving_tenant_shed_total",
            "requests shed before admission, by tenant",
            labelnames=("tenant",))
        self._c_cache_saved = r.counter(
            "serving_tenant_cache_saved_tokens_total",
            "prefill tokens served from the prefix cache, by tenant",
            labelnames=("tenant",))
        self._c_overflow = r.counter(
            "serving_tenant_overflow_total",
            "unique tenant ids folded into ~other because the ledger "
            "hit max_tenants")

    # ------------------------------------------------------- plumbing
    def _acct(self, tenant_id):
        """(folded_id, account) for ``tenant_id``, creating the cell
        under the cardinality cap — past it, the OVERFLOW_TENANT cell
        absorbs the accrual and the fold is counted."""
        t = str(tenant_id) if tenant_id else DEFAULT_TENANT
        with self._lock:
            a = self._accounts.get(t)
            if a is None:
                if len(self._accounts) >= self.max_tenants \
                        and t != OVERFLOW_TENANT:
                    self._overflow_events += 1
                    overflowed = True
                    t = OVERFLOW_TENANT
                    a = self._accounts.get(t)
                else:
                    overflowed = False
                if a is None:
                    a = self._accounts[t] = _Account()
                if overflowed:
                    self._c_overflow.inc()
        return t, a

    def set_queue_probe(self, fn):
        """``fn() -> {tenant_id: queued_count}`` evaluated at report
        time (the engine points this at its live scheduler queue, so
        ``queued`` reflects NOW, not an accrual race)."""
        self._queue_probe = fn

    # ------------------------------------------------------ accruals
    # Each is called from exactly one ServingMetrics record_* site —
    # the conservation contract (module docstring) lives or dies on
    # that 1:1 mapping, so add new call sites with care.
    def note_admission(self, tenant_id, prompt_tokens, queue_wait_s):
        if not self.enabled:
            return
        t, a = self._acct(tenant_id)
        a.requests += 1
        a.tokens_in += int(prompt_tokens)
        a.queue_wait.add(max(0.0, float(queue_wait_s)))
        self._c_requests.labels(t).inc()
        self._c_tokens_in.labels(t).inc(int(prompt_tokens))

    def note_first_token(self, tenant_id, ttft_s):
        if not self.enabled:
            return
        _, a = self._acct(tenant_id)
        a.ttft.add(max(0.0, float(ttft_s)))

    def note_completion(self, tenant_id, tokens, violations):
        """``violations`` is the engine's own SLOTracker verdict for
        this request (empty/None = attained) — passed through, never
        re-judged, so tenant attainment mirrors the global counters
        exactly."""
        if not self.enabled:
            return
        t, a = self._acct(tenant_id)
        tokens = int(tokens)
        a.completed += 1
        a.tokens_out += tokens
        self._c_completed.labels(t).inc()
        self._c_tokens_out.labels(t).inc(tokens)
        if violations:
            for dim in violations:
                a.violations[dim] = a.violations.get(dim, 0) + 1
            self._c_violations.labels(t).inc(len(violations))
        else:
            a.attained += 1
            a.goodput_tokens += tokens
            self._c_attained.labels(t).inc()
            self._c_goodput.labels(t).inc(tokens)

    def note_shed(self, tenant_id, reason):
        """Mirrors SLOTracker.observe_shed: a shed is a judged
        violation (dimension = reason) with zero goodput."""
        if not self.enabled:
            return
        t, a = self._acct(tenant_id)
        reason = str(reason)
        a.shed[reason] = a.shed.get(reason, 0) + 1
        a.violations[reason] = a.violations.get(reason, 0) + 1
        self._c_shed.labels(t).inc()
        self._c_violations.labels(t).inc()

    def note_timeout(self, tenant_id):
        if not self.enabled:
            return
        _, a = self._acct(tenant_id)
        a.timeouts += 1

    def note_abort(self, tenant_id):
        if not self.enabled:
            return
        _, a = self._acct(tenant_id)
        a.aborts += 1

    def note_cache_savings(self, tenant_id, saved_tokens, saved_ms):
        if not self.enabled:
            return
        t, a = self._acct(tenant_id)
        a.cache_saved_tokens += int(saved_tokens)
        a.cache_saved_ms += float(saved_ms or 0.0)
        self._c_cache_saved.labels(t).inc(int(saved_tokens))

    # ------------------------------------------------------- reporting
    @property
    def tenant_count(self):
        with self._lock:
            return len(self._accounts)

    @property
    def overflow_events(self):
        return self._overflow_events

    def report(self):
        """The JSON-safe ``snapshot()["tenants"]`` section."""
        if not self.enabled:
            return disabled_tenant_report(self.max_tenants)
        queued = {}
        if self._queue_probe is not None:
            try:
                queued = dict(self._queue_probe() or {})
            except Exception:   # noqa: BLE001 - scrape must not raise
                queued = {}
        with self._lock:
            accounts = dict(self._accounts)
            overflow_events = self._overflow_events
        # queued work for a tenant the cap would fold renders under
        # ~other (report-side only — reporting never mints accounts)
        folded_queued = {}
        for t, n in queued.items():
            t = str(t) if t else DEFAULT_TENANT
            if t not in accounts and len(accounts) >= self.max_tenants:
                t = OVERFLOW_TENANT
            folded_queued[t] = folded_queued.get(t, 0) + int(n)
        tenants = {}
        for t, a in sorted(accounts.items()):
            tenants[t] = {
                "requests": a.requests,
                "completed": a.completed,
                "tokens_in": a.tokens_in,
                "tokens_out": a.tokens_out,
                "goodput_tokens": a.goodput_tokens,
                "attained": a.attained,
                "attainment": round(a.attained / a.completed, 4)
                if a.completed else None,
                "violations": dict(sorted(a.violations.items())),
                "shed": dict(sorted(a.shed.items())),
                "timeouts": a.timeouts,
                "aborts": a.aborts,
                "cache_saved_tokens": a.cache_saved_tokens,
                "cache_saved_ms": round(a.cache_saved_ms, 3),
                "queued": folded_queued.get(t, 0),
                "queue_wait": _pct(a.queue_wait),
                "ttft": _pct(a.ttft),
            }
        # a tenant with queued work but no accrual yet still shows up
        empty = _Account()
        for t, n in sorted(folded_queued.items()):
            if t not in tenants:
                tenants[t] = {
                    "requests": 0, "completed": 0, "tokens_in": 0,
                    "tokens_out": 0, "goodput_tokens": 0,
                    "attained": 0, "attainment": None,
                    "violations": {}, "shed": {}, "timeouts": 0,
                    "aborts": 0, "cache_saved_tokens": 0,
                    "cache_saved_ms": 0.0, "queued": n,
                    "queue_wait": _pct(empty.queue_wait),
                    "ttft": _pct(empty.ttft),
                }
        return {
            "enabled": True,
            "max_tenants": self.max_tenants,
            "tenant_count": len(tenants),
            "overflow": {"folded_events": overflow_events},
            "tenants": tenants,
        }

    def top(self, k=8):
        """Top-``k`` tenants by generated-token share — the incident
        bundle's "who was hammering us" section."""
        with self._lock:
            rows = [(t, a.tokens_out, a.requests, a.completed)
                    for t, a in self._accounts.items()]
        total = sum(r[1] for r in rows)
        rows.sort(key=lambda r: (-r[1], r[0]))
        return [{
            "tenant": t,
            "tokens_out": toks,
            "token_share": round(toks / total, 4) if total else None,
            "requests": reqs,
            "completed": done,
        } for t, toks, reqs, done in rows[:max(0, int(k))]]
