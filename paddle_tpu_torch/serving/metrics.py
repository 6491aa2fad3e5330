"""Serving metrics (a port of ``paddle_tpu/serving/metrics.py``): a
facade over a per-engine ``observability.MetricsRegistry``.

Every counter lives in the registry under the reference's metric name,
so one accounting point feeds both ``snapshot()`` and the Prometheus
text ``/metrics`` serves, and a fleet poller of either package reads a
port replica. The engine's hot path keeps the plain attribute surface
(``metrics.tokens_generated += 1``) through counter properties.

Latency series are bounded: TTFT, request latency and queue wait each
record into a fixed-bucket histogram (the Prometheus view, exact
average) plus a fixed-size reservoir (p50/p90/p99,
``snapshot()["latency_percentiles"]``).

The observatories hang off the same registry, with the reference's
``snapshot()`` sections and key sets: ``slo`` (observability.SLOTracker:
attainment, violations, goodput, sliding windows), ``tenants``
(observability.TenantLedger), ``perf`` (observability.ProgramPerf:
per-program dispatch/sync seconds and roofline fractions, with
speculation's economy under ``perf["spec"]``), ``cache``
(observability.CacheObservatory over the paged pool) and ``trace`` (the
engine's span ring). ``resilience``, ``health`` and ``replica`` are the
hardened engine's. The port adds ``kv_wire`` (handoff counts and
bytes).

Differences from the reference: the engine opens no
``profiler.record_scope`` (the reference's prefill, decode and compile
scopes), so it accrues only the ``serving/step`` span (the perf report's denominator)
and keeps the dispatch and sync legs as plain seconds
(``dispatch_sync_split``); it compiles nothing, so ``compiles`` is 0;
and the decode cost behind ``estimated_mfu`` is the mean price of the
priced decode dispatches (``set_decode_cost``), not XLA's
``cost_analysis``.
"""
import time

from ..observability import (CacheObservatory, MetricsRegistry,
                             ProgramPerf, Reservoir, SLOTracker,
                             TenantLedger, WindowedReservoir)

_PCTS = ((50, "p50_ms"), (90, "p90_ms"), (99, "p99_ms"))


def _series(family):
    return {labels[0]: int(child.value)
            for labels, child in family.series()}


def _counter_property(attr):
    def get(self):
        v = getattr(self, attr).value
        return int(v) if float(v).is_integer() else v

    def set_(self, value):
        getattr(self, attr).set_to(value)

    return property(get, set_)


class ServingMetrics:
    """Engine-scoped metrics facade. ``slo_ttft_ms`` / ``slo_tpot_ms`` /
    ``slo_window_s`` configure the SLO tracker; ``perf``, ``cache`` (with
    ``cache_sample_rate``) and ``max_tenants`` (0 disables the ledger)
    the observatories, as the reference's do."""

    RESERVOIR_SIZE = 1024
    PREFIX_WINDOW_S = 60.0

    def __init__(self, registry=None, slo_ttft_ms=None, slo_tpot_ms=None,
                 slo_window_s=60.0, perf=True, cache=True,
                 cache_sample_rate=0.125, max_tenants=32):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        r = self.registry
        self.slo = SLOTracker(r, slo_ttft_ms=slo_ttft_ms,
                              slo_tpot_ms=slo_tpot_ms,
                              window_s=slo_window_s)
        self.tenants = TenantLedger(r, max_tenants=max_tenants)
        self.perf = ProgramPerf(r, enabled=perf)
        self.cache = CacheObservatory(r, enabled=cache,
                                      sample_rate=cache_sample_rate)
        self.cache.bind_cost_source(
            self.perf, lambda: self._c_prefill_tokens.value)
        self._peak_flops = None
        self._g_decode_flops = r.gauge(
            "serving_decode_flops_per_step",
            "flops of ONE pooled decode dispatch (the mean price of the "
            "priced decode dispatches)")
        self._g_decode_bytes = r.gauge(
            "serving_decode_bytes_per_step",
            "bytes accessed by ONE pooled decode dispatch (the mean "
            "price of the priced decode dispatches)")
        self._g_mfu = r.gauge(
            "serving_estimated_mfu",
            "estimated model-flops utilization: decode flops issued "
            "over busy wall time against the device's bf16 peak FLOP/s "
            "(0 when the peak or the decode price is unknown)")
        self._g_mfu.set_function(self.estimated_mfu)
        self._c_compiles = r.counter(
            "serving_compiles_total",
            "programs built (the port builds none per shape)")
        self._c_prefills = r.counter(
            "serving_prefill_dispatches_total",
            "prefill dispatches (one per group)")
        self._c_prefill_requests = r.counter(
            "serving_prefill_requests_total",
            "requests prefilled (sum of group sizes)")
        self._c_decode_steps = r.counter(
            "serving_decode_steps_total", "pooled decode dispatches")
        self._c_tokens = r.counter(
            "serving_tokens_generated_total", "tokens emitted")
        self._c_spec_masked = r.counter(
            "serving_speculative_masked_total",
            "pipelined tokens discarded at harvest (request stopped "
            "while its next step was in flight)")
        self._c_admitted = r.counter(
            "serving_requests_admitted_total", "requests admitted")
        self._c_completed = r.counter(
            "serving_requests_completed_total", "requests completed")
        self._g_queue_depth = r.gauge(
            "serving_queue_depth", "queued requests (per engine step)")
        self._g_occupancy = r.gauge(
            "serving_slot_occupancy", "live slots / num_slots")
        self._c_groups = r.counter(
            "serving_prefill_groups_total",
            "prefill dispatches by group size",
            labelnames=("group_size",))
        self._c_span = r.counter(
            "serving_span_seconds_total",
            "wall seconds accrued per engine scope",
            labelnames=("span",))
        self._span_step = self._c_span.labels("serving/step")
        self._h_ttft = r.histogram(
            "serving_ttft_seconds", "arrival -> first token")
        self._h_latency = r.histogram(
            "serving_request_latency_seconds", "arrival -> done")
        self._h_queue_wait = r.histogram(
            "serving_queue_wait_seconds", "arrival -> slot admission")
        self._c_prefix_hits = r.counter(
            "serving_prefix_cache_hits_total",
            "admissions that reused a cached prompt prefix")
        self._c_prefix_misses = r.counter(
            "serving_prefix_cache_misses_total",
            "admissions with no reusable cached prefix")
        self._c_prefix_cached_tokens = r.counter(
            "serving_prefix_cached_tokens_total",
            "prompt tokens served from the prefix cache instead of "
            "being prefill-computed")
        self._c_prefill_tokens = r.counter(
            "serving_prefill_tokens_computed_total",
            "prompt tokens actually computed by prefill dispatches "
            "(excludes prefix-cache hits and bucket padding)")
        # sliding-window prefix-cache effectiveness
        self._w_prefix_hits = WindowedReservoir(
            window_s=self.PREFIX_WINDOW_S, capacity=4096)
        self._w_prefix_cached = WindowedReservoir(
            window_s=self.PREFIX_WINDOW_S, capacity=4096)
        r.gauge(
            "serving_prefix_cache_windowed_hit_rate",
            "prefix-cache hit rate over the sliding window (admissions "
            "with a cached prefix / admissions; 0 when the window is "
            "empty)").set_function(self.windowed_prefix_hit_rate)
        r.gauge(
            "serving_prefix_cached_tokens_per_sec",
            "prompt tokens served from the prefix cache per second, "
            "sliding window").set_function(
                self.windowed_cached_tokens_per_sec)
        self._c_shed = r.counter(
            "serving_requests_shed_total",
            "requests dropped by the admission policy before serving "
            "(by reason)", labelnames=("reason",))
        self._c_deprioritized = r.counter(
            "serving_requests_deprioritized_total",
            "requests moved behind still-SLO-viable queue members by "
            "the admission policy")
        self._c_chunks = r.counter(
            "serving_prefill_chunks_total",
            "chunked-prefill dispatches (one per chunk)")
        self._c_chunked_reqs = r.counter(
            "serving_chunked_requests_total",
            "requests whose prefill ran chunk-by-chunk")
        self._g_policy = r.gauge(
            "serving_scheduler_policy",
            "active scheduling policy (the labeled policy reads 1)",
            labelnames=("scheduler_policy",))
        self._c_dispatch_failures = r.counter(
            "serving_dispatch_failures_total",
            "dispatch attempts that raised (rolled back, then retried "
            "or escalated)", labelnames=("kind",))
        self._c_retries = r.counter(
            "serving_dispatch_retries_total",
            "failed dispatches absorbed by the bounded-retry budget")
        self._c_timeouts = r.counter(
            "serving_requests_timed_out_total",
            "requests retired at their deadline_ms (SLO-judged as "
            "violations)")
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
        self._c_spec_drafted = r.counter(
            "serving_spec_drafted_tokens_total",
            "draft tokens shipped to verify dispatches")
        self._c_spec_accepted = r.counter(
            "serving_spec_accepted_tokens_total",
            "draft tokens accepted (longest-accepted-prefix)")
        self._c_spec_rejected = r.counter(
            "serving_spec_rejected_tokens_total",
            "draft tokens rejected at verify (including drafts masked "
            "with a retired request)")
        self._c_spec_emitted = r.counter(
            "serving_spec_emitted_tokens_total",
            "tokens emitted by verify dispatches (accepted drafts plus "
            "the bonus token, after stop masking)")
        self._c_spec_verify_steps = r.counter(
            "serving_spec_verify_steps_total",
            "k-token verify dispatches")
        self._c_spec_slot_steps = r.counter(
            "serving_spec_slot_steps_total",
            "per-slot verify legs harvested")
        self._c_spec_fallback_steps = r.counter(
            "serving_spec_fallback_steps_total",
            "decode-capable steps on a speculative engine dispatched on "
            "the plain decode program (no slot drafted)")
        self._spec_info = {"enabled": False, "k": None}
        self._resilience_fn = None
        self._sched_info = {"policy": "fifo", "prefill_chunk": None,
                            "prefill_token_budget": None}
        self._prefix_pool_stats = None
        self._health_fn = None
        self._identity = None
        self._trace_fn = None
        # plain-int mirror of the labeled shed counter (the health tick
        # reads a shed total on every step)
        self.shed_count = 0
        self._res = {
            "ttft": Reservoir(self.RESERVOIR_SIZE),
            "request_latency": Reservoir(self.RESERVOIR_SIZE),
            "queue_wait": Reservoir(self.RESERVOIR_SIZE),
        }
        self.kv_donation = {"enabled": False, "effective": False}
        # wall seconds issuing device work / blocked on reads (the
        # health ledger's dispatch_s / sync_s)
        self.dispatch_s = 0.0
        self.sync_s = 0.0
        # KV handoffs: count and raw tile bytes each way
        self.kv_exports = 0
        self.kv_export_bytes = 0
        self.kv_imports = 0
        self.kv_import_bytes = 0
        self._t_first_work = None
        self._t_last_work = None

    # ------------------------------------------ attribute facade
    compiles = _counter_property("_c_compiles")
    prefills = _counter_property("_c_prefills")
    prefill_requests = _counter_property("_c_prefill_requests")
    decode_steps = _counter_property("_c_decode_steps")
    tokens_generated = _counter_property("_c_tokens")
    speculative_masked = _counter_property("_c_spec_masked")
    requests_admitted = _counter_property("_c_admitted")
    requests_completed = _counter_property("_c_completed")
    prefix_hits = _counter_property("_c_prefix_hits")
    prefix_misses = _counter_property("_c_prefix_misses")
    prefill_tokens = _counter_property("_c_prefill_tokens")
    prefill_chunks = _counter_property("_c_chunks")
    chunked_requests = _counter_property("_c_chunked_reqs")
    deprioritized = _counter_property("_c_deprioritized")
    spec_drafted = _counter_property("_c_spec_drafted")
    spec_accepted = _counter_property("_c_spec_accepted")
    spec_rejected = _counter_property("_c_spec_rejected")
    spec_tokens_emitted = _counter_property("_c_spec_emitted")
    spec_verify_steps = _counter_property("_c_spec_verify_steps")
    spec_slot_steps = _counter_property("_c_spec_slot_steps")
    spec_fallback_steps = _counter_property("_c_spec_fallback_steps")

    @property
    def queue_depth(self):
        return int(self._g_queue_depth.value)

    @queue_depth.setter
    def queue_depth(self, value):
        self._g_queue_depth.set(value)

    @property
    def slot_occupancy(self):
        return self._g_occupancy.value

    @slot_occupancy.setter
    def slot_occupancy(self, value):
        self._g_occupancy.set(value)

    @property
    def prefill_group_hist(self):
        """group size -> dispatch count (a view of the labeled
        counter)."""
        return {int(labels[0]): int(child.value)
                for labels, child in self._c_groups.series()}

    @property
    def span_s(self):
        """scope name -> accrued seconds."""
        return {labels[0]: child.value
                for labels, child in self._c_span.series()}

    @property
    def ttft_s(self):
        """The TTFT reservoir's samples, seconds."""
        return list(self._res["ttft"].samples())

    @property
    def request_latency_s(self):
        return list(self._res["request_latency"].samples())

    # ------------------------------------------------------- resilience
    def record_dispatch_failure(self, kind):
        self._c_dispatch_failures.labels(str(kind)).inc()

    def record_retry(self):
        self._c_retries.inc()

    def record_timeout(self, tenant=None):
        """A request retired at its deadline: counted, and SLO-judged as
        a violation (dimension "deadline", no goodput)."""
        self._c_timeouts.inc()
        self.slo.observe_shed("deadline")
        self.tenants.note_timeout(tenant)

    def record_abort(self, tenant=None):
        self._c_aborted.inc()
        self.tenants.note_abort(tenant)

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

    def set_trace(self, snapshot_fn):
        """Attach the trace recorder's ``snapshot()`` as the pull source
        of ``snapshot()["trace"]``."""
        self._trace_fn = snapshot_fn

    def trace_report(self):
        """The ``snapshot()["trace"]`` section (the disabled shape when
        no recorder is attached)."""
        if self._trace_fn is not None:
            return self._trace_fn()
        return {"enabled": False, "spans_recorded": 0,
                "spans_dropped": 0, "ring_occupancy": 0,
                "ring_capacity": 0}

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
        the busy window ``tokens_per_sec`` and ``estimated_mfu`` divide
        by."""
        if self._t_first_work is None:
            self._t_first_work = t0
        self._t_last_work = t1

    def note_step(self, dt):
        """Accrue one engine step's wall seconds (the ``serving/step``
        span, the perf report's attribution denominator)."""
        self._span_step.inc(dt)

    def record_admission(self, request):
        """Queue-wait accounting at slot-claim time."""
        wait = 0.0
        if request.t_admitted is not None:
            wait = request.t_admitted - request.t_arrival
            self._h_queue_wait.observe(wait)
            self._res["queue_wait"].add(wait)
        self.tenants.note_admission(request.tenant_id, len(request.prompt),
                                    wait)

    def record_first_token(self, request):
        request.t_first_token = time.perf_counter()
        ttft = request.t_first_token - request.t_arrival
        self._h_ttft.observe(ttft)
        self._res["ttft"].add(ttft)
        self.tenants.note_first_token(request.tenant_id, ttft)

    def record_completion(self, request):
        """Completion accounting and the request's SLO verdict; returns
        the violated dimensions (empty: SLO attained)."""
        self._c_completed.inc()
        latency = request.t_done - request.t_arrival
        self._h_latency.observe(latency)
        self._res["request_latency"].add(latency)
        ttft = (None if request.t_first_token is None
                else request.t_first_token - request.t_arrival)
        violations = self.slo.observe_request(ttft, latency,
                                              len(request.generated))
        # the tenant ledger receives the engine's own verdict, so the
        # per-tenant sums match the global SLO counters exactly
        self.tenants.note_completion(request.tenant_id,
                                     len(request.generated), violations)
        return violations

    def record_prefix_reuse(self, cached_tokens, computed_tokens,
                            tenant=None):
        """One paged admission's prefix economy: ``cached_tokens`` came
        from radix-matched blocks (a hit when > 0), ``computed_tokens``
        is the tail the prefill ran. Returns the estimated TTFT ms this
        admission saved (None until prefill measurements exist)."""
        if cached_tokens > 0:
            self._c_prefix_hits.inc()
        else:
            self._c_prefix_misses.inc()
        if cached_tokens:
            self._c_prefix_cached_tokens.inc(int(cached_tokens))
        if computed_tokens:
            self._c_prefill_tokens.inc(int(computed_tokens))
        self._w_prefix_hits.add(1.0 if cached_tokens > 0 else 0.0)
        self._w_prefix_cached.add(float(cached_tokens or 0))
        saved_ms = self.cache.note_reuse(int(cached_tokens or 0))
        if cached_tokens:
            self.tenants.note_cache_savings(tenant, int(cached_tokens),
                                            saved_ms)
        return saved_ms

    def record_prefill_group(self, size, tokens):
        """One prefill dispatch of ``size`` requests computing ``tokens``
        prompt tokens (a paged tail's count goes through
        ``record_prefix_reuse``)."""
        self._c_groups.labels(str(int(size))).inc()
        if tokens:
            self._c_prefill_tokens.inc(int(tokens))

    def set_scheduler_info(self, policy_name, prefill_chunk,
                           prefill_token_budget):
        self._sched_info = {"policy": str(policy_name),
                            "prefill_chunk": prefill_chunk,
                            "prefill_token_budget": prefill_token_budget}
        self._g_policy.labels(str(policy_name)).set(1)

    def record_shed(self, reason, tenant=None):
        """One request dropped by the admission policy: counted by
        reason and SLO-judged as a violation with no goodput."""
        self._c_shed.labels(str(reason)).inc()
        self.shed_count += 1
        self.slo.observe_shed(str(reason))
        self.tenants.note_shed(tenant, str(reason))

    def record_deprioritized(self, n=1):
        if n:
            self._c_deprioritized.inc(n)

    def record_prefill_chunk(self, computed_tokens):
        """One chunk dispatch; its tokens (overlap recompute included)
        are prefill compute."""
        self._c_chunks.inc()
        if computed_tokens:
            self._c_prefill_tokens.inc(int(computed_tokens))

    def scheduler_report(self):
        """The ``snapshot()["scheduler"]`` section."""
        shed = _series(self._c_shed)
        return dict(self._sched_info, shed=shed,
                    shed_total=sum(shed.values()),
                    deprioritized=self.deprioritized,
                    prefill_chunks=self.prefill_chunks,
                    chunked_requests=self.chunked_requests)

    # ---------------------------------------------------- cost model
    def set_decode_cost(self, flops=None, bytes_accessed=None):
        """Per-decode-dispatch device cost (the engine passes the mean
        price of its priced decode dispatches)."""
        if flops is not None:
            self._g_decode_flops.set(flops)
        if bytes_accessed is not None:
            self._g_decode_bytes.set(bytes_accessed)

    def set_peak_flops(self, peak_flops):
        """Device peak FLOP/s the MFU estimate divides by (None =
        unknown -> the gauge reads 0). As in the reference it is the
        card's dense bf16 peak whatever the serving dtype, so an f32
        engine reads very low."""
        self._peak_flops = None if not peak_flops else float(peak_flops)

    def estimated_mfu(self):
        """Rough MFU: decode_steps * flops_per_decode over the busy wall
        window, against peak FLOP/s. An estimate: prefill flops are
        excluded and the busy window includes host time."""
        peak = self._peak_flops
        flops = self._g_decode_flops.value
        if not peak or not flops or self._t_first_work is None:
            return 0.0
        busy = self._t_last_work - self._t_first_work
        if busy <= 0:
            return 0.0
        return self.decode_steps * flops / (busy * peak)

    def enable_device_memory(self, stats_fn):
        """Register HBM pull gauges backed by ``stats_fn()`` (a dict with
        ``bytes_in_use`` and ``bytes_free``). The engine calls it on a
        CUDA device only: the CPU serves no HBM gauges rather than
        zeros."""

        def field(name):
            stats = stats_fn()
            v = (stats or {}).get(name)
            return 0.0 if v is None else float(v)

        self.registry.gauge(
            "serving_hbm_bytes_in_use", "device memory in use (bytes)"
        ).set_function(lambda: field("bytes_in_use"))
        self.registry.gauge(
            "serving_hbm_bytes_free",
            "device memory headroom: bytes_limit - bytes_in_use"
        ).set_function(lambda: field("bytes_free"))

    # --------------------------------------------------------- derived
    def tokens_per_sec(self):
        """Generated tokens over the busy window (first to last step
        that did work)."""
        if self._t_first_work is None:
            return 0.0
        dt = self._t_last_work - self._t_first_work
        return self.tokens_generated / dt if dt > 0 else 0.0

    def dispatch_sync_split(self):
        """(dispatch_s, sync_s): wall seconds issuing device work vs
        blocked on device->host reads."""
        return self.dispatch_s, self.sync_s

    def latency_percentiles(self):
        """{"ttft", "request_latency", "queue_wait"}: count and
        p50/p90/p99 ms from the bounded reservoirs (None when empty)."""
        out = {}
        for name, res in self._res.items():
            entry = {"count": res.seen}
            for q, key in _PCTS:
                p = res.percentile(q)
                entry[key] = None if p is None else round(p * 1000.0, 3)
            out[name] = entry
        return out

    def set_prefix_pool(self, stats_fn):
        """Attach the pool's ``stats()`` as snapshot's prefix_cache pool
        section."""
        self._prefix_pool_stats = stats_fn

    def windowed_prefix_hit_rate(self):
        vals = self._w_prefix_hits.values()
        return sum(vals) / len(vals) if vals else 0.0

    def windowed_cached_tokens_per_sec(self):
        return sum(self._w_prefix_cached.values()) / self.PREFIX_WINDOW_S

    def prefix_cache_report(self):
        hits, misses = self.prefix_hits, self.prefix_misses
        cached = int(self._c_prefix_cached_tokens.value)
        computed = self.prefill_tokens
        total = hits + misses
        w_admissions = self._w_prefix_hits.count()
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
                "admissions": w_admissions,
                "hit_rate": round(self.windowed_prefix_hit_rate(), 4)
                if w_admissions else None,
                "cached_tokens_per_s": round(
                    self.windowed_cached_tokens_per_sec(), 3),
            },
            "pool": self._prefix_pool_stats()
            if self._prefix_pool_stats is not None else None,
        }

    def cache_report(self):
        """The ``snapshot()["cache"]`` / ``/debug/cache`` body (the
        disabled shape until a paged pool is attached)."""
        return self.cache.report()

    def set_spec(self, enabled, k):
        self._spec_info = {"enabled": bool(enabled),
                           "k": int(k) if enabled else None}

    def spec_report(self):
        """The ``perf["spec"]`` section (observability.PERF_SPEC_KEYS)."""
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

    def perf_report(self):
        """The ``snapshot()["perf"]`` / ``/debug/perf`` body: per-program
        measured time and roofline fractions over the accrued
        ``serving/step`` seconds, plus speculation's economy under
        ``spec``."""
        report = self.perf.report(
            step_total_s=self.span_s.get("serving/step"))
        report["spec"] = self.spec_report()
        return report

    def tenant_report(self):
        """The ``snapshot()["tenants"]`` / ``/debug/tenants`` body."""
        return self.tenants.report()

    def snapshot(self):
        n_ttft = self._h_ttft.count
        ttft_p50 = self._res["ttft"].percentile(50)
        return {
            "tokens_generated": self.tokens_generated,
            "tokens_per_sec": self.tokens_per_sec(),
            "ttft_avg_ms": self._h_ttft.sum / n_ttft * 1000.0
            if n_ttft else None,
            "ttft_p50_ms": None if ttft_p50 is None
            else ttft_p50 * 1000.0,
            "queue_depth": self.queue_depth,
            "slot_occupancy": round(self.slot_occupancy, 4),
            "prefills": self.prefills,
            "prefill_requests": self.prefill_requests,
            "prefill_groups": {str(k): v for k, v in
                               sorted(self.prefill_group_hist.items())},
            "decode_steps": self.decode_steps,
            "speculative_masked": self.speculative_masked,
            "kv_donation": dict(self.kv_donation),
            "compiles": self.compiles,
            "requests_admitted": self.requests_admitted,
            "requests_completed": self.requests_completed,
            "dispatch_s": round(self.dispatch_s, 4),
            "sync_s": round(self.sync_s, 4),
            "span_s": {k: round(v, 4) for k, v in self.span_s.items()},
            "latency_percentiles": self.latency_percentiles(),
            "slo": self.slo.report(),
            "prefix_cache": self.prefix_cache_report(),
            "scheduler": self.scheduler_report(),
            "kv_wire": {"exports": self.kv_exports,
                        "export_bytes": self.kv_export_bytes,
                        "imports": self.kv_imports,
                        "import_bytes": self.kv_import_bytes},
            "health": self.health_report(),
            "resilience": self.resilience_report(),
            "perf": self.perf_report(),
            "cache": self.cache_report(),
            "replica": self.identity_report(),
            "trace": self.trace_report(),
            "tenants": self.tenant_report(),
        }
