"""Reuse-distance sampling + miss-ratio-curve (MRC) estimation for the
paged KV block economy (a copy of
``paddle_tpu/observability/cache/mrc.py``).

"How big should the cache be" is a reuse-distance question: an access
to a block whose LRU stack distance is d hits any cache of capacity
> d, so the distance histogram IS the hit-rate-vs-capacity curve. The
exact histogram needs the full LRU stack (one entry per distinct block
path ever seen) — fine for tests, unbounded online. The online
sampler uses SHARDS-style SPATIAL sampling (Waldspurger et al.,
FAST'15): keep only block paths whose stable hash lands under a
threshold (rate R), track exact distances WITHIN the sampled
population, and scale distances by 1/R. Hit-rate estimates then come
from sampled counts alone (both numerator and denominator are sampled
at the same rate, so no count rescaling is needed).

Bounded three ways: the sampled population is capped (oldest sampled
path dropped, later re-accesses count cold — a conservative bias
toward predicting misses), scaled distances beyond ``max_distance``
lump into one overflow bucket (they are misses at every capacity we
would ever evaluate), and the histogram itself is keyed by scaled
distance, at most one bucket per tracked path.

``exact_mrc`` is the oracle the estimator is validated against
in-tree and the sizing tool for small offline
traces; the estimator is the production path.
"""
import collections

__all__ = ["ReuseDistanceSampler", "exact_mrc", "merge_mrc_points"]

# Knuth multiplicative hash: spreads sequential fingerprints uniformly
# over 32 bits so "hash < rate * 2^32" is an unbiased spatial sample
_HASH_MULT = 2654435761
_HASH_MOD = 1 << 32


def _spatial_hash(obj):
    return (int(obj) * _HASH_MULT) % _HASH_MOD


class ReuseDistanceSampler:
    """Spatially-sampled reuse-distance histogram over an access
    stream of integer object ids (stable block-path fingerprints).

    ``record(obj)`` per access; ``est_hit_rate(capacity)`` /
    ``mrc(capacities)`` to read the curve. ``rate=1.0`` degenerates to
    the exact (unsampled) histogram — the property tests pin that
    equivalence against ``exact_mrc``.
    """

    def __init__(self, rate=0.125, max_tracked=2048,
                 max_distance=1 << 16):
        if not (0.0 < rate <= 1.0):
            raise ValueError(f"rate must be in (0, 1], got {rate}")
        if max_tracked < 1:
            raise ValueError("max_tracked must be >= 1")
        self.rate = float(rate)
        self.max_tracked = int(max_tracked)
        self.max_distance = int(max_distance)
        self._threshold = int(self.rate * _HASH_MOD)
        # sampled population in LRU order (most recent LAST); value
        # unused — the OrderedDict is the recency stack
        self._last = collections.OrderedDict()
        self._hist = {}          # scaled distance -> sampled accesses
        self.cold = 0            # sampled first-touches (infinite d)
        self.overflow = 0        # sampled reuses at d >= max_distance
        self.reuses = 0          # sampled reuses binned in _hist
        self.dropped = 0         # sampled paths aged out of tracking

    # ----------------------------------------------------- recording
    def sampled(self, obj):
        return _spatial_hash(obj) < self._threshold

    def record(self, obj):
        """One access to ``obj``. Non-sampled objects return
        immediately (the common case at low rates — this is the whole
        overhead story of the sampler)."""
        if _spatial_hash(obj) >= self._threshold:
            return
        last = self._last
        if obj in last:
            # exact stack distance within the sampled population:
            # walk back from the most recent entry. O(distance), and
            # hot paths (the ones that matter) have SMALL distances.
            d = 0
            for o in reversed(last):
                if o == obj:
                    break
                d += 1
            last.move_to_end(obj)
            scaled = int(d / self.rate)
            if scaled >= self.max_distance:
                self.overflow += 1
            else:
                self.reuses += 1
                self._hist[scaled] = self._hist.get(scaled, 0) + 1
        else:
            self.cold += 1
            last[obj] = None
            if len(last) > self.max_tracked:
                last.popitem(last=False)
                self.dropped += 1

    # ----------------------------------------------------- estimates
    @property
    def sampled_accesses(self):
        return self.cold + self.overflow + self.reuses

    @property
    def tracked(self):
        return len(self._last)

    def est_hit_rate(self, capacity_blocks):
        """Estimated hit rate of an LRU cache holding
        ``capacity_blocks`` blocks: the fraction of sampled accesses
        whose scaled reuse distance fits. None before any sampled
        traffic."""
        total = self.sampled_accesses
        if not total:
            return None
        cap = int(capacity_blocks)
        hits = sum(n for d, n in self._hist.items() if d < cap)
        return hits / total

    def mrc(self, capacities):
        """[{"blocks": C, "est_hit_rate": r}] for each capacity, in
        one cumulative pass over the histogram (sorted distances)."""
        caps = sorted(int(c) for c in capacities)
        total = self.sampled_accesses
        out = []
        if not total:
            return [{"blocks": c, "est_hit_rate": None} for c in caps]
        dists = sorted(self._hist.items())
        i, cum = 0, 0
        for cap in caps:
            while i < len(dists) and dists[i][0] < cap:
                cum += dists[i][1]
                i += 1
            out.append({"blocks": cap,
                        "est_hit_rate": round(cum / total, 6)})
        return out

    def report(self):
        """The ``sampled`` sub-dict of the cache report (bounded:
        scalar counters only — the MRC curve carries the histogram's
        information at the capacities that matter)."""
        return {
            "rate": self.rate,
            "accesses": self.sampled_accesses,
            "cold": self.cold,
            "overflow": self.overflow,
            "tracked": self.tracked,
            "dropped": self.dropped,
        }


def exact_mrc(trace, capacities):
    """Exact LRU hit rate per capacity over a full access trace, one
    pass (the validation oracle: unbounded state, offline only).
    Returns {capacity: hit_rate-or-None-when-empty}."""
    caps = [int(c) for c in capacities]
    last = collections.OrderedDict()
    hits = {c: 0 for c in caps}
    total = 0
    for obj in trace:
        total += 1
        if obj in last:
            d = 0
            for o in reversed(last):
                if o == obj:
                    break
                d += 1
            last.move_to_end(obj)
            for c in caps:
                if d < c:
                    hits[c] += 1
        else:
            last[obj] = None
    if not total:
        return {c: None for c in caps}
    return {c: hits[c] / total for c in caps}


def merge_mrc_points(point_lists, weights):
    """Fleet-exact merge of per-replica MRC curves: at each capacity
    the fleet estimate is the access-weighted mean of replica
    estimates — algebraically identical to pooling the replicas'
    sampled histograms, so the merge is exact, never an average of
    averages with equal weights. Capacities present in every replica
    survive; None estimates (no traffic yet) contribute zero weight."""
    common = None
    for pts in point_lists:
        caps = {p["blocks"] for p in (pts or [])}
        common = caps if common is None else (common & caps)
    if not common:
        return []
    out = []
    for cap in sorted(common):
        num = den = 0.0
        for pts, w in zip(point_lists, weights):
            est = next(p["est_hit_rate"] for p in pts
                       if p["blocks"] == cap)
            if est is None or not w:
                continue
            num += est * float(w)
            den += float(w)
        out.append({"blocks": cap,
                    "est_hit_rate": round(num / den, 6) if den
                    else None})
    return out
