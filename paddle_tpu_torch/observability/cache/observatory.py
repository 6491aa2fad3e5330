"""The cache observatory: one attach point on the paged KV pool that
turns the block economy's raw events into operator answers (a copy of
``paddle_tpu/observability/cache/observatory.py``) —

  * "how big should the cache be"  -> reuse-distance sampler + MRC
    (mrc.ReuseDistanceSampler; a spill tier's sizing tool);
  * "which prefixes are hot"       -> per-node heat digest
    (heat.top_prefix_digest over the radix index's hit counters;
    a router's affinity signal);
  * "what is the cache worth"      -> per-request savings attribution
    (cached tokens x measured per-token prefill cost from the perf
    observatory -> estimated TTFT ms saved);
  * "is eviction thrashing"        -> block-lifetime reservoir +
    the radix eviction-then-reinsert counter.

Observatory playbook: every structure bounded, hooks are a few
dict/int ops on the admission path, the report is
schema-pinned (``CACHE_KEYS``), disabled engines report the same key
set (``disabled_cache_report``), and the class survives a supervisor
pool swap (``attach_pool`` re-points every pull source at the new
pool; counters and the sampler keep their history — a restart does
not forget the workload).
"""
import time

from .heat import top_prefix_digest
from .mrc import ReuseDistanceSampler
from ..registry import Reservoir

__all__ = ["CacheObservatory", "disabled_cache_report", "CACHE_KEYS",
           "MRC_CAPACITY_FACTORS"]

# snapshot()["cache"] schema contract (additions only, never renames)
CACHE_KEYS = (
    "enabled", "accesses", "hits", "hit_rate", "capacity_blocks",
    "sampled", "mrc", "heat", "savings", "churn",
)

# the capacities the MRC is evaluated at, as multiples of the pool's
# current usable capacity — 0.5x/1x answer "could we shrink", 2x/4x
# answer "what would a host-RAM spill tier buy"
MRC_CAPACITY_FACTORS = (0.5, 1.0, 2.0, 4.0)

_PREFILL_KINDS = ("prefill", "paged_prefill", "chunk_prefill")


def disabled_cache_report():
    """The ``snapshot()["cache"]`` section of an engine without a
    cache observatory (cache=False, or a legacy non-paged pool) —
    same key set as a live report, so the snapshot schema contract
    holds either way."""
    return {"enabled": False, "accesses": 0, "hits": 0,
            "hit_rate": None, "capacity_blocks": None, "sampled": None,
            "mrc": None, "heat": None, "savings": None, "churn": None}


class CacheObservatory:
    """Registry-backed cache telemetry, attached to a PagedKVPool via
    ``attach_pool`` (which sets itself as ``pool.observer``).
    ``enabled=False`` registers nothing and every hook no-ops."""

    LIFETIME_RESERVOIR = 1024
    HEAT_TOP_K = 8

    def __init__(self, registry, enabled=True, sample_rate=0.125,
                 heat_top_k=None, clock=time.perf_counter):
        self.enabled = bool(enabled)
        self._pool = None
        if not self.enabled:
            return
        self._clock = clock
        self.heat_top_k = int(heat_top_k or self.HEAT_TOP_K)
        self.sampler = ReuseDistanceSampler(rate=sample_rate)
        # exact (unsampled) block-access counters: the measured hit
        # rate the MRC estimate at 1x capacity is judged against
        self.accesses = 0
        self.hits = 0
        # savings attribution state (per-token cost joined lazily from
        # the perf observatory via bind_cost_source)
        self._perf = None
        self._computed_tokens_fn = None
        self._birth = {}          # block -> clock() at allocation
        self._lifetimes = Reservoir(self.LIFETIME_RESERVOIR)
        self._h_lifetime = registry.histogram(
            "serving_cache_block_lifetime_seconds",
            "allocation -> free/eviction wall seconds per KV block "
            "(evictable parking time counts as alive: the block is "
            "still serving hits)")
        self._c_saved_tokens = registry.counter(
            "serving_cache_saved_tokens_total",
            "prompt tokens served from the prefix cache (the savings "
            "attribution numerator; mirrors "
            "serving_prefix_cached_tokens_total at admission points "
            "the observatory sees)")
        self._c_saved_ms = registry.counter(
            "serving_cache_saved_ttft_ms_total",
            "estimated TTFT milliseconds saved by prefix-cache hits: "
            "cached tokens x measured per-token prefill wall (perf "
            "observatory join; accrues 0 until prefill measurements "
            "exist)")
        # pull gauges read THROUGH self so a supervisor pool swap
        # re-points them automatically (attach_pool only sets _pool)
        registry.gauge(
            "serving_cache_block_accesses_total",
            "block-granular prefix-cache accesses (full prompt blocks "
            "probed at admission)"
        ).set_function(lambda: float(self.accesses))
        registry.gauge(
            "serving_cache_block_hits_total",
            "block-granular prefix-cache hits (prompt blocks found "
            "cached at admission)"
        ).set_function(lambda: float(self.hits))
        registry.gauge(
            "serving_cache_thrash_reinserts_total",
            "evicted-then-reinserted radix paths (each one is a block "
            "the cache gave up and then recomputed — sustained growth "
            "means the pool is too small for the working set)"
        ).set_function(self._thrash_count)

    # ------------------------------------------------------- wiring
    def attach_pool(self, pool):
        """Point the observatory at a (possibly new) pool and make it
        the pool's event observer. Called at engine construction and
        again after a supervisor restart swaps the pool — history
        (sampler, savings, lifetime reservoir) survives the swap."""
        if not self.enabled:
            return
        self._pool = pool
        pool.observer = self

    def bind_cost_source(self, perf, computed_tokens_fn):
        """Join the perf observatory: per-token prefill cost =
        measured prefill-family wall seconds over prefill-computed
        tokens (both live accumulators, read at attribution time)."""
        if not self.enabled:
            return
        self._perf = perf
        self._computed_tokens_fn = computed_tokens_fn

    def _thrash_count(self):
        pool = self._pool
        return float(pool.index.thrash_count) if pool is not None \
            else 0.0

    # ------------------------------------------------ pool callbacks
    # (hot path: a dict store / pop and a few int ops per block event;
    # the sampler's spatial filter rejects most accesses in O(1))
    def on_block_alloc(self, block):
        self._birth[block] = self._clock()

    def on_block_free(self, block, evicted):
        t0 = self._birth.pop(block, None)
        if t0 is not None:
            dt = self._clock() - t0
            self._lifetimes.add(dt)
            self._h_lifetime.observe(dt)

    def on_admission(self, fps, n_hit):
        """One admission's block-granular prefix probe: ``fps`` are
        the stable path fingerprints of the prompt's full blocks (in
        path order), ``n_hit`` how many were found cached."""
        self.accesses += len(fps)
        self.hits += int(n_hit)
        record = self.sampler.record
        for fp in fps:
            record(fp)

    # --------------------------------------------------- attribution
    def per_token_prefill_ms(self):
        """Measured per-token prefill cost in ms: prefill-family
        program wall (dispatch + sync) over prefill-computed tokens.
        None until both sides have data — early admissions attribute
        no savings rather than invented ones."""
        if self._perf is None or self._computed_tokens_fn is None:
            return None
        tokens = self._computed_tokens_fn()
        if not tokens:
            return None
        wall_s = self._perf.prefill_seconds()
        if not wall_s:
            return None
        return wall_s / float(tokens) * 1000.0

    def estimate_saved_ms(self, cached_tokens):
        """Estimated TTFT ms a prefix hit of ``cached_tokens`` saves,
        WITHOUT accruing it (the flight-recorder detail is stamped at
        dispatch time; the counter accrues once, in note_reuse)."""
        if not self.enabled or not cached_tokens:
            return None
        per_ms = self.per_token_prefill_ms()
        if per_ms is None:
            return None
        return int(cached_tokens) * per_ms

    def note_reuse(self, cached_tokens):
        """One admission's savings: called with the cached-token count
        at the same point ServingMetrics.record_prefix_reuse accounts
        it. Returns the estimated ms saved (None before the perf join
        has data) so the engine can stamp it onto the flight-recorder
        prefix_hit detail."""
        if not self.enabled or not cached_tokens:
            return None
        self._c_saved_tokens.inc(int(cached_tokens))
        per_ms = self.per_token_prefill_ms()
        if per_ms is None:
            return None
        saved = int(cached_tokens) * per_ms
        self._c_saved_ms.inc(saved)
        return saved

    # ----------------------------------------------------- reporting
    def measured_hit_rate(self):
        return self.hits / self.accesses if self.accesses else None

    def mrc_points(self, capacity_blocks=None):
        """The MRC evaluated at MRC_CAPACITY_FACTORS multiples of the
        pool's usable capacity (trash block excluded), each point
        carrying its factor so readers need no division."""
        if capacity_blocks is None:
            pool = self._pool
            if pool is None:
                return None
            capacity_blocks = pool.num_blocks - 1
        caps = [max(1, int(round(capacity_blocks * f)))
                for f in MRC_CAPACITY_FACTORS]
        points = self.sampler.mrc(caps)
        for pt, f in zip(points, MRC_CAPACITY_FACTORS):
            pt["factor"] = f
        return points

    def report(self):
        """The ``snapshot()["cache"]`` / ``/debug/cache`` body (key
        set pinned by tests/test_observability.py)."""
        if not self.enabled or self._pool is None:
            return disabled_cache_report()
        pool = self._pool
        cap = pool.num_blocks - 1
        entries = pool.index.heat_entries()
        heat = top_prefix_digest(entries, k=self.heat_top_k)
        hit_rate = self.measured_hit_rate()
        per_ms = self.per_token_prefill_ms()
        life = {"count": self._lifetimes.seen}
        for q, key in ((50, "p50_ms"), (90, "p90_ms"), (99, "p99_ms")):
            p = self._lifetimes.percentile(q)
            life[key] = None if p is None else round(p * 1000.0, 3)
        return {
            "enabled": True,
            "accesses": self.accesses,
            "hits": self.hits,
            "hit_rate": round(hit_rate, 4) if hit_rate is not None
            else None,
            "capacity_blocks": cap,
            "sampled": self.sampler.report(),
            "mrc": self.mrc_points(cap),
            "heat": {
                "top": heat,
                "indexed_blocks": len(pool.index),
                "total_hits": sum(e["hits"] for e in entries),
            },
            "savings": {
                "saved_tokens": int(self._c_saved_tokens.value),
                "saved_ttft_ms": round(self._c_saved_ms.value, 3),
                "per_token_prefill_ms": round(per_ms, 6)
                if per_ms is not None else None,
            },
            "churn": {
                "evictions": pool.evictions,
                "thrash_reinserts": pool.index.thrash_count,
                "block_lifetime_ms": life,
            },
        }
