"""Serving counters (a slim port of ``paddle_tpu/serving/metrics.py``).

Keeps what the engine writes: tokens, decode steps, prefills,
admissions, prefix-cache hits and misses, and the last TTFT samples.
``snapshot()["prefix_cache"]`` has the reference's keys. The Prometheus
registry and the health, perf, tenant and trace observatories are not
ported.
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
            "prefix_cache": self.prefix_cache_report(),
        }
