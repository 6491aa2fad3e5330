"""Cache observatory: reuse-distance/MRC profiling, prefix heat
analytics, per-request cache-savings attribution, and eviction-churn
telemetry for the paged KV block economy (a copy of
``paddle_tpu/observability/cache``).

Three modules, one attach point:

  * ``mrc``         — SHARDS-style spatially-sampled reuse-distance
                      histogram + miss-ratio-curve estimation, with
                      the exact small-trace simulator it is validated
                      against (``exact_mrc``) and the fleet-exact
                      curve merge (``merge_mrc_points``);
  * ``heat``        — top-K hot-prefix digest over the radix index's
                      per-node hit/tick/tokens-saved counters, and
                      its fleet merge (``merge_heat_digests``);
  * ``observatory`` — CacheObservatory: the PagedKVPool observer that
                      feeds all of the above plus block-lifetime and
                      TTFT-savings accounting, reported as the
                      schema-pinned ``snapshot()["cache"]`` /
                      ``/debug/cache`` body (``CACHE_KEYS``,
                      ``disabled_cache_report``).
"""
from .heat import (  # noqa: F401
    merge_heat_digests, top_prefix_digest,
)
from .mrc import (  # noqa: F401
    ReuseDistanceSampler, exact_mrc, merge_mrc_points,
)
from .observatory import (  # noqa: F401
    CACHE_KEYS, CacheObservatory, MRC_CAPACITY_FACTORS,
    disabled_cache_report,
)
