"""Prefix heat analytics: which cached prefixes earn their blocks (a
copy of ``paddle_tpu/observability/cache/heat.py``).

The radix index already stamps per-node LRU ticks; the cache
observatory adds per-node hit counts, and this module rolls both into
the top-K HOT-PREFIX digest — the signal a prefix-affinity router
needs: "requests matching fingerprint F save
T tokens here", without ever shipping raw prompt tokens (the
fingerprint is a stable 32-bit hash of the token path, computed by
serving.paged.radix.path_fingerprint).

Digest entries are JSON-scalar only and the digest is top-K bounded,
so it rides along in ``snapshot()["cache"]`` and the fleet state body
for free. ``merge_heat_digests`` is the fleet rollup rule: entries
combine BY FINGERPRINT (hits and tokens-saved sum exactly — the same
prefix hot on two replicas is one fleet-wide prefix), then the merged
set is re-ranked and re-truncated to K.
"""

__all__ = ["top_prefix_digest", "merge_heat_digests"]


def top_prefix_digest(entries, k=8):
    """Rank per-node heat entries (dicts with fp/depth/hits/last_tick/
    tokens_saved, as produced by RadixPrefixIndex.heat_entries) and
    keep the top ``k`` by tokens saved; fingerprint breaks ties so the
    digest is deterministic."""
    ranked = sorted(
        (e for e in entries if e.get("hits")),
        key=lambda e: (-e["tokens_saved"], -e["hits"], e["fp"]))
    return [dict(e) for e in ranked[:int(k)]]


def merge_heat_digests(digests, k=8):
    """Exact fleet merge of per-replica top-K digests: sum hits and
    tokens_saved per fingerprint, keep the deepest depth seen (the
    same fp always names the same path, but replicas may disagree
    transiently during eviction churn), take the max last_tick (ticks
    are per-replica monotone — max is "most recently hot anywhere"),
    then re-rank."""
    by_fp = {}
    for digest in digests:
        for e in digest or ():
            cur = by_fp.get(e["fp"])
            if cur is None:
                by_fp[e["fp"]] = dict(e)
            else:
                cur["hits"] += e["hits"]
                cur["tokens_saved"] += e["tokens_saved"]
                cur["depth"] = max(cur["depth"], e["depth"])
                cur["last_tick"] = max(cur["last_tick"], e["last_tick"])
    return top_prefix_digest(by_fp.values(), k=k)
