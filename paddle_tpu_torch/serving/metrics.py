"""Serving counters (a slim port of ``paddle_tpu/serving/metrics.py``).

Keeps what the engine writes: tokens, decode steps, prefills and their
group sizes, admissions, prefix-cache hits and misses, the last TTFT
samples, the scheduler's decisions (chunk dispatches, shed and deferred
requests), speculative decoding's economy and the KV handoffs' wire
bytes. ``snapshot()["prefix_cache"]``, ``["scheduler"]`` and
``["spec"]`` have the reference's keys (the reference reports ``spec``
under ``perf``). The Prometheus registry and the health, perf, tenant
and trace observatories are not ported.
"""
import collections
import statistics
import time


class ServingMetrics:
    PREFIX_WINDOW_S = 60.0
    SAMPLES_KEEP = 4096

    def __init__(self):
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
        }
