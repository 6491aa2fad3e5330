"""Serving counters (a slim port of ``paddle_tpu/serving/metrics.py``).

Keeps what the engine writes: tokens, decode steps, prefills and their
group sizes, admissions, prefix-cache hits and misses, the last TTFT
samples, the scheduler's decisions (chunk dispatches, shed and deferred
requests), speculative decoding's economy and the KV handoffs' wire
bytes, as plain numbers. ``snapshot()["prefix_cache"]``,
``["scheduler"]`` and ``["spec"]`` have the reference's keys (the
reference reports ``spec`` under ``perf``).

The resilience accounting (dispatch failures, retries, timeouts,
aborts, callback errors, quarantines, injected faults, supervisor
restarts), the replica identity and the health monitor's anomaly
counters live in a per-engine ``observability.MetricsRegistry`` under
the reference's metric names, which ``/metrics`` serves; their
``snapshot()`` sections (``resilience``, ``health``, ``replica``) have
the reference's keys. The perf, cache, tenant, SLO and trace
observatories are not ported.
"""
import collections
import statistics
import time

from ..observability.registry import MetricsRegistry


def _series(family):
    return {labels[0]: int(child.value)
            for labels, child in family.series()}


class ServingMetrics:
    PREFIX_WINDOW_S = 60.0
    SAMPLES_KEEP = 4096

    def __init__(self, registry=None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        r = self.registry
        self._c_dispatch_failures = r.counter(
            "serving_dispatch_failures_total",
            "dispatch attempts that raised (rolled back, then retried "
            "or escalated)", labelnames=("kind",))
        self._c_retries = r.counter(
            "serving_dispatch_retries_total",
            "failed dispatches absorbed by the bounded-retry budget")
        self._c_timeouts = r.counter(
            "serving_requests_timed_out_total",
            "requests retired at their deadline_ms")
        self._c_aborted = r.counter(
            "serving_requests_aborted_total",
            "requests retired unfinished (engine close with in-flight "
            "work, or dispatch retry budget exhausted)")
        self._c_callback_errors = r.counter(
            "serving_callback_errors_total",
            "user on_token callbacks that raised (caught and counted; "
            "the step loop kept streaming)")
        self._c_quarantine = r.counter(
            "serving_slots_quarantined_total",
            "slots excluded from admission after repeated same-slot "
            "dispatch failures")
        self._c_faults = r.counter(
            "serving_faults_injected_total",
            "chaos-harness fault injections by site",
            labelnames=("site",))
        self._c_restarts = r.counter(
            "supervisor_restarts_total",
            "in-process supervisor recoveries (pools reset, programs "
            "rebuilt, in-flight requests replayed)")
        self._resilience_fn = None
        self._health_fn = None
        self._identity = None
        # wall seconds issuing device work / blocked on reads (the
        # health ledger's dispatch_s / sync_s)
        self.dispatch_s = 0.0
        self.sync_s = 0.0
        self.tokens_generated = 0
        self.decode_steps = 0
        self.prefills = 0
        self.requests_admitted = 0
        self.requests_completed = 0
        self.speculative_masked = 0   # masked in-flight tokens past EOS
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_cached_tokens = 0
        self.prefill_tokens = 0
        self.prefill_requests = 0
        self.prefill_group_hist = {}   # group size -> dispatches
        # scheduler decisions
        self._sched_info = {"policy": "fifo", "prefill_chunk": None,
                            "prefill_token_budget": None}
        self.shed = {}                 # reason -> requests
        self.deprioritized = 0
        self.prefill_chunks = 0
        self.chunked_requests = 0
        # speculative decoding
        self._spec_info = {"enabled": False, "k": None}
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_rejected = 0
        self.spec_tokens_emitted = 0
        self.spec_verify_steps = 0
        self.spec_slot_steps = 0
        self.spec_fallback_steps = 0
        # KV handoffs: count and raw tile bytes each way
        self.kv_exports = 0
        self.kv_export_bytes = 0
        self.kv_imports = 0
        self.kv_import_bytes = 0
        self.ttft_s = collections.deque(maxlen=self.SAMPLES_KEEP)
        self._prefix_window = collections.deque()   # (t, cached_tokens)
        self._prefix_pool_stats = None
        self._t_first_work = None
        self._t_last_work = None

    # ------------------------------------------------------- resilience
    def record_dispatch_failure(self, kind):
        self._c_dispatch_failures.labels(str(kind)).inc()

    def record_retry(self):
        self._c_retries.inc()

    def record_timeout(self):
        self._c_timeouts.inc()

    def record_abort(self):
        self._c_aborted.inc()

    def record_callback_error(self):
        self._c_callback_errors.inc()

    def record_quarantine(self):
        self._c_quarantine.inc()

    def record_fault(self, site):
        self._c_faults.labels(str(site)).inc()

    def record_restart(self):
        self._c_restarts.inc()

    def set_resilience(self, state_fn):
        """Attach the engine's live resilience state (quarantined slots,
        draining flag, supervisor and chaos reports) as the pull source
        of ``snapshot()["resilience"]``."""
        self._resilience_fn = state_fn

    def resilience_report(self):
        """The ``snapshot()["resilience"]`` section: the failure, retry,
        timeout and abort counters plus the engine's live quarantine,
        supervisor and chaos state."""
        fails = _series(self._c_dispatch_failures)
        state = self._resilience_fn() if self._resilience_fn is not None \
            else {"quarantined_slots": [], "draining": False,
                  "supervisor": {"enabled": False},
                  "chaos": {"enabled": False}}
        return dict({
            "dispatch_failures": fails,
            "dispatch_failures_total": sum(fails.values()),
            "dispatch_retries": int(self._c_retries.value),
            "requests_timed_out": int(self._c_timeouts.value),
            "requests_aborted": int(self._c_aborted.value),
            "callback_errors": int(self._c_callback_errors.value),
            "slots_quarantined_total": int(self._c_quarantine.value),
            "faults_injected": _series(self._c_faults),
            "supervisor_restarts": int(self._c_restarts.value),
        }, **state)

    # ------------------------------------------------ identity, health
    def set_identity(self, identity, version=None, torch_version=None):
        """Stamp the replica identity into the registry:
        ``serving_uptime_seconds`` (a pull gauge: uptime going backwards
        between scrapes means the process bounced) and the
        ``paddle_tpu_torch_build_info{replica, version, torch_version}``
        info gauge (value 1)."""
        self._identity = identity
        self.registry.gauge(
            "serving_uptime_seconds",
            "seconds since this engine replica was constructed"
        ).set_function(identity.uptime_s)
        self.registry.gauge(
            "paddle_tpu_torch_build_info",
            "replica identity + build info (value is always 1; the "
            "labels are the payload)",
            labelnames=("replica", "version", "torch_version"),
        ).labels(identity.replica_id, str(version or "unknown"),
                 str(torch_version or "unknown")).set(1)

    def identity_report(self):
        """The ``snapshot()["replica"]`` section."""
        if self._identity is None:
            return {"replica_id": None, "uptime_s": None,
                    "started_at": None}
        return self._identity.report()

    def set_health(self, summary_fn):
        """Attach the health monitor's ``summary()`` as the pull source
        of ``snapshot()["health"]``."""
        self._health_fn = summary_fn

    def health_report(self):
        if self._health_fn is not None:
            return self._health_fn()
        from ..observability.health import disabled_health_summary
        return disabled_health_summary()

    def prometheus_text(self):
        return self.registry.prometheus_text()

    # -------------------------------------------------------- serving
    def note_work(self, t0, t1):
        """A step that did work ran from ``t0`` to ``t1`` (perf_counter):
        the busy window ``tokens_per_sec`` divides by."""
        if self._t_first_work is None:
            self._t_first_work = t0
        self._t_last_work = t1

    def record_first_token(self, request):
        request.t_first_token = time.perf_counter()
        self.ttft_s.append(request.t_first_token - request.t_arrival)

    def record_completion(self, request):
        self.requests_completed += 1

    def record_prefix_reuse(self, cached_tokens, computed_tokens):
        """One paged admission's prefix economy: ``cached_tokens`` came
        from radix-matched blocks (a hit when > 0), ``computed_tokens``
        is the tail the prefill ran."""
        if cached_tokens > 0:
            self.prefix_hits += 1
            self.prefix_cached_tokens += int(cached_tokens)
        else:
            self.prefix_misses += 1
        self.prefill_tokens += int(computed_tokens)
        now = time.perf_counter()
        self._prefix_window.append((now, int(cached_tokens)))
        self._trim_window(now)

    def record_prefill_group(self, size, tokens):
        """One prefill dispatch of ``size`` requests computing ``tokens``
        prompt tokens (a paged tail's count with its prefix reuse)."""
        self.prefill_group_hist[size] = \
            self.prefill_group_hist.get(size, 0) + 1
        self.prefill_tokens += int(tokens)

    def set_scheduler_info(self, policy_name, prefill_chunk,
                           prefill_token_budget):
        self._sched_info = {"policy": str(policy_name),
                            "prefill_chunk": prefill_chunk,
                            "prefill_token_budget": prefill_token_budget}

    def record_shed(self, reason):
        self.shed[reason] = self.shed.get(reason, 0) + 1

    def record_prefill_chunk(self, computed_tokens):
        """One chunk dispatch; its tokens (overlap recompute included)
        are prefill compute."""
        self.prefill_chunks += 1
        self.prefill_tokens += int(computed_tokens)

    def scheduler_report(self):
        """The ``snapshot()["scheduler"]`` section."""
        return dict(self._sched_info, shed=dict(self.shed),
                    shed_total=sum(self.shed.values()),
                    deprioritized=self.deprioritized,
                    prefill_chunks=self.prefill_chunks,
                    chunked_requests=self.chunked_requests)

    def set_spec(self, enabled, k):
        self._spec_info = {"enabled": bool(enabled),
                           "k": int(k) if enabled else None}

    def spec_report(self):
        """The ``snapshot()["spec"]`` section (the reference's
        ``perf["spec"]``)."""
        drafted, slot_steps = self.spec_drafted, self.spec_slot_steps
        return {
            "enabled": self._spec_info["enabled"],
            "k": self._spec_info["k"],
            "drafted_tokens": drafted,
            "accepted_tokens": self.spec_accepted,
            "rejected_tokens": self.spec_rejected,
            "emitted_tokens": self.spec_tokens_emitted,
            "verify_steps": self.spec_verify_steps,
            "slot_steps": slot_steps,
            "fallback_steps": self.spec_fallback_steps,
            "acceptance_rate": round(self.spec_accepted / drafted, 4)
            if drafted else None,
            # tokens one slot yields from one verify leg (a plain decode
            # leg yields 1.0)
            "effective_tokens_per_dispatch":
                round(self.spec_tokens_emitted / slot_steps, 4)
                if slot_steps else None,
        }

    def _trim_window(self, now):
        w = self._prefix_window
        while w and now - w[0][0] > self.PREFIX_WINDOW_S:
            w.popleft()

    def set_prefix_pool(self, stats_fn):
        """Attach the pool's ``stats()`` as snapshot's prefix_cache pool
        section."""
        self._prefix_pool_stats = stats_fn

    def tokens_per_sec(self):
        """Generated tokens over the busy window (first to last step
        that did work)."""
        if self._t_first_work is None:
            return 0.0
        dt = self._t_last_work - self._t_first_work
        return self.tokens_generated / dt if dt > 0 else 0.0

    def prefix_cache_report(self):
        hits, misses = self.prefix_hits, self.prefix_misses
        cached, computed = self.prefix_cached_tokens, self.prefill_tokens
        total = hits + misses
        self._trim_window(time.perf_counter())
        w = self._prefix_window
        return {
            "hits": hits,
            "misses": misses,
            "hit_rate": round(hits / total, 4) if total else None,
            "cached_tokens": cached,
            "computed_tokens": computed,
            "cached_fraction": round(cached / (cached + computed), 4)
            if (cached + computed) else None,
            "windowed": {
                "window_s": self.PREFIX_WINDOW_S,
                "admissions": len(w),
                "hit_rate": round(sum(1 for _, c in w if c > 0) / len(w), 4)
                if w else None,
                "cached_tokens_per_s": round(
                    sum(c for _, c in w) / self.PREFIX_WINDOW_S, 3),
            },
            "pool": self._prefix_pool_stats()
            if self._prefix_pool_stats is not None else None,
        }

    def snapshot(self):
        ttft = list(self.ttft_s)
        return {
            "tokens_generated": self.tokens_generated,
            "decode_steps": self.decode_steps,
            "prefills": self.prefills,
            "requests_admitted": self.requests_admitted,
            "requests_completed": self.requests_completed,
            "speculative_masked": self.speculative_masked,
            "tokens_per_sec": self.tokens_per_sec(),
            "ttft_avg_ms": statistics.fmean(ttft) * 1000.0 if ttft else None,
            "ttft_p50_ms": statistics.median(ttft) * 1000.0
            if ttft else None,
            "prefill_requests": self.prefill_requests,
            "prefill_group_hist": dict(sorted(
                self.prefill_group_hist.items())),
            "prefix_cache": self.prefix_cache_report(),
            "scheduler": self.scheduler_report(),
            "spec": self.spec_report(),
            "kv_wire": {"exports": self.kv_exports,
                        "export_bytes": self.kv_export_bytes,
                        "imports": self.kv_imports,
                        "import_bytes": self.kv_import_bytes},
            "dispatch_s": round(self.dispatch_s, 4),
            "sync_s": round(self.sync_s, 4),
            "health": self.health_report(),
            "resilience": self.resilience_report(),
            "replica": self.identity_report(),
        }
