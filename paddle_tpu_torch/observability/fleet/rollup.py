"""Federated fleet rollups: many replica scrapes, one pinned snapshot
(a copy of ``paddle_tpu/observability/fleet/rollup.py``; the schema
strings are the reference's wire values).

The poller hands this module each replica's last-known scrape bodies
(``/metrics.json`` snapshot, ``/debug/health``, ``/debug/state``) plus
its own availability bookkeeping; this module folds them into the
``FleetSnapshot`` — the ``/fleet/state`` body and the surface a
router consumes. Two merge rules, applied EXACTLY:

  * **counters sum** — tokens, goodput, completions are additive
    facts; the fleet total is the sum over replicas' last-known
    cumulative counters (down replicas keep contributing their last
    observed totals: a crashed replica's already-served tokens
    happened);
  * **histograms merge bucket-wise** — fleet TTFT / request-latency
    percentiles come from ``registry.merge_histogram_snapshots`` over
    the per-replica fixed-bucket histograms and
    ``registry.percentile_from_buckets`` over the MERGED distribution.
    Averaging per-replica percentiles is statistically meaningless
    (a p99 of averages is not an average of p99s); merged buckets are
    the one representation that aggregates exactly.

``FLEET_SNAPSHOT_KEYS`` / ``FLEET_REPLICA_KEYS`` / ``FLEET_AGG_KEYS``
are the schema contract (tests/test_fleet.py pins them — keys only
get added, never renamed).
"""
from ..cache import merge_heat_digests, merge_mrc_points
from ..registry import merge_histogram_snapshots, percentile_from_buckets

FLEET_SCHEMA = "paddle_tpu.fleet/v1"

# /fleet/state top level
FLEET_SNAPSHOT_KEYS = (
    "schema", "t", "polls", "interval_s", "replicas", "fleet",
    "health",
)

# one entry per replica (identity + availability + posture + load)
FLEET_REPLICA_KEYS = (
    "replica_id",     # self-reported id (configured id until learned)
    "url",            # scrape base URL
    "verdict",        # up | stale | down (availability)
    "healthy",        # the replica's own /debug/health verdict
    "degraded",       # supervisor-restart replay still draining
    "draining",       # graceful drain in progress
    "restarts",       # cumulative supervisor restarts
    "queue_depth",    # queued requests at last scrape
    "occupancy",      # live slots / num_slots at last scrape
    "steps",          # engine steps ever (health ledger)
    "step_rate",      # steps/sec between the last two scrapes
    "tokens_generated",
    "goodput_tokens",
    "requests_completed",
    "roofline_fraction",   # decode program, when priced
    "cache_hit_rate",      # block-granular prefix-cache hit rate
    "cache_saved_ttft_ms",  # estimated TTFT ms saved by cache hits
    "cache_thrash",        # evict-then-reinsert events (cumulative)
    "uptime_s",       # replica-reported process uptime
    "version",        # build-info version label
    "age_s",          # seconds since the last successful scrape
    "consecutive_failures",
    "polls",          # scrape attempts against this replica
    "failures",       # of those, failed
    "evictions",      # up->down verdict flips
    "readmissions",   # down->up verdict flips
    "scrape_ms",      # last successful scrape round-trip
    "last_error",     # last scrape failure, abbreviated (None when up)
)

# the fleet-level aggregate block
FLEET_AGG_KEYS = (
    "size", "up", "stale", "down", "healthy", "queue_depth",
    "occupancy", "step_rate", "tokens_generated", "goodput_tokens",
    "requests_completed", "latency", "roofline_fraction", "cache",
    "tenants",
)

# per-tenant fleet rollup: (entry key, tenant-labelled counter family)
# — every one an additive fact, so the fleet row is the exact sum of
# per-replica series (never a mean of per-replica rates)
_TENANT_COUNTERS = (
    ("requests", "serving_tenant_requests_total"),
    ("completed", "serving_tenant_completed_total"),
    ("tokens_in", "serving_tenant_tokens_in_total"),
    ("tokens_out", "serving_tenant_tokens_out_total"),
    ("goodput_tokens", "serving_tenant_goodput_tokens_total"),
    ("attained", "serving_tenant_slo_attained_total"),
    ("violations", "serving_tenant_slo_violations_total"),
    ("shed", "serving_tenant_shed_total"),
    ("cache_saved_tokens", "serving_tenant_cache_saved_tokens_total"),
)

FLEET_TENANT_ENTRY_KEYS = tuple(k for k, _ in _TENANT_COUNTERS) + (
    "queued", "attainment", "token_share",
)

_PCTS = ((50, "p50_ms"), (90, "p90_ms"), (99, "p99_ms"))
_LATENCY_FAMILIES = (("ttft", "serving_ttft_seconds"),
                     ("request_latency",
                      "serving_request_latency_seconds"))


def counter_value(snap, name, labels=""):
    """One series' value out of a registry ``snapshot()`` dict; None
    when the family or series is absent (an older replica, or a
    family that never accrued)."""
    fam = (snap or {}).get(name)
    if not fam:
        return None
    v = fam.get("values", {}).get(labels)
    return v if isinstance(v, (int, float)) else None


def histogram_value(snap, name, labels=""):
    """One histogram series ({count, sum, buckets}) or None."""
    fam = (snap or {}).get(name)
    if not fam or fam.get("type") != "histogram":
        return None
    v = fam.get("values", {}).get(labels)
    return v if isinstance(v, dict) else None


# the build-info families of the two packages' replicas (the port's
# labels are replica / version / torch_version, the reference's
# replica / version / jax_version)
BUILD_INFO_FAMILIES = ("paddle_tpu_torch_build_info",
                       "paddle_tpu_build_info")


def build_info_labels(snap):
    """The first build-info series' labels as a dict, {} when
    absent."""
    fam = None
    for name in BUILD_INFO_FAMILIES:
        fam = (snap or {}).get(name)
        if fam:
            break
    for key in (fam or {}).get("values", {}):
        out = {}
        for part in key.split(","):
            k, _, v = part.partition("=")
            out[k] = v
        return out
    return {}


def _sum_known(values):
    known = [v for v in values if v is not None]
    return round(sum(known), 3) if known else None


def _mean_known(values):
    known = [v for v in values if v is not None]
    return round(sum(known) / len(known), 4) if known else None


def merged_latency(snapshots):
    """{"ttft": {count, p50_ms, p90_ms, p99_ms}, "request_latency":
    {...}} from bucket-wise merged per-replica histograms."""
    out = {}
    for name, family in _LATENCY_FAMILIES:
        entries = [histogram_value(s, family) for s in snapshots]
        merged = merge_histogram_snapshots(entries)
        entry = {"count": merged["count"]}
        for q, key in _PCTS:
            p = percentile_from_buckets(merged["buckets"], q)
            entry[key] = None if p is None else round(p * 1000.0, 3)
        out[name] = entry
    return out


def replica_entry(st, now):
    """One ``FLEET_REPLICA_KEYS`` row from a poller ReplicaState."""
    snap, health, state = st.metrics, st.health, st.state
    hrep = health or {}
    srep = state or {}
    replica_sec = srep.get("replica") or {}
    info = build_info_labels(snap)
    roofline = counter_value(snap, "serving_roofline_fraction",
                             "program=decode")
    c_hits = counter_value(snap, "serving_cache_block_hits_total")
    c_accesses = counter_value(snap,
                               "serving_cache_block_accesses_total")
    c_saved_ms = counter_value(snap,
                               "serving_cache_saved_ttft_ms_total")
    c_thrash = counter_value(snap,
                             "serving_cache_thrash_reinserts_total")
    return {
        "replica_id": st.replica_id,
        "url": st.url,
        "verdict": st.verdict,
        "healthy": hrep.get("healthy"),
        "degraded": hrep.get("degraded"),
        "draining": hrep.get("draining"),
        "restarts": hrep.get("restarts"),
        "queue_depth": srep.get("queue_depth"),
        "occupancy": srep.get("slot_occupancy"),
        "steps": (hrep.get("ledger") or {}).get("steps"),
        "step_rate": round(st.step_rate, 2)
        if st.step_rate is not None else None,
        "tokens_generated": counter_value(
            snap, "serving_tokens_generated_total"),
        "goodput_tokens": counter_value(
            snap, "serving_goodput_tokens_total"),
        "requests_completed": counter_value(
            snap, "serving_requests_completed_total"),
        "roofline_fraction": round(roofline, 6)
        if roofline else None,
        "cache_hit_rate": round((c_hits or 0.0) / c_accesses, 4)
        if c_accesses else None,
        "cache_saved_ttft_ms": round(c_saved_ms, 3)
        if c_saved_ms is not None else None,
        "cache_thrash": int(c_thrash) if c_thrash is not None
        else None,
        "uptime_s": replica_sec.get("uptime_s"),
        "version": info.get("version"),
        "age_s": round(now - st.last_seen, 3)
        if st.last_seen is not None else None,
        "consecutive_failures": st.consecutive_failures,
        "polls": st.polls,
        "failures": st.failures,
        "evictions": st.evictions,
        "readmissions": st.readmissions,
        "scrape_ms": round(st.scrape_s * 1000.0, 3)
        if st.scrape_s is not None else None,
        "last_error": st.last_error,
    }


def fleet_cache(snapshots, states):
    """The fleet-level ``cache`` block: counters sum exactly (hits /
    accesses summed BEFORE dividing — the fleet hit rate is the true
    pooled rate, not a mean of per-replica rates), the MRC merges as
    the sampled-access-weighted mean per capacity (algebraically the
    pooled-histogram estimate), and the heat digest merges by stable
    fingerprint then re-ranks. ``states`` are the replicas' last-known
    ``/debug/state`` bodies (the MRC curve and heat digest live
    there). None when no replica reports a cache section."""
    accesses = _sum_known([counter_value(
        s, "serving_cache_block_accesses_total") for s in snapshots])
    if accesses is None:
        return None
    hits = _sum_known([counter_value(
        s, "serving_cache_block_hits_total") for s in snapshots])
    point_lists, weights, digests = [], [], []
    for state in states:
        cache = (state or {}).get("cache") or {}
        if not cache.get("enabled"):
            continue
        if cache.get("mrc"):
            point_lists.append(cache["mrc"])
            weights.append(
                (cache.get("sampled") or {}).get("accesses") or 0)
        top = (cache.get("heat") or {}).get("top")
        if top:
            digests.append(top)
    return {
        "accesses": accesses,
        "hits": hits,
        "hit_rate": round((hits or 0.0) / accesses, 4)
        if accesses else None,
        "saved_tokens": _sum_known([counter_value(
            s, "serving_cache_saved_tokens_total")
            for s in snapshots]),
        "saved_ttft_ms": _sum_known([counter_value(
            s, "serving_cache_saved_ttft_ms_total")
            for s in snapshots]),
        "thrash_reinserts": _sum_known([counter_value(
            s, "serving_cache_thrash_reinserts_total")
            for s in snapshots]),
        "mrc": merge_mrc_points(point_lists, weights)
        if point_lists else None,
        "heat_top": merge_heat_digests(digests) if digests else None,
    }


def fleet_tenants(snapshots, states):
    """The fleet-level ``tenants`` block: every per-tenant counter
    sums exactly across replicas (same merge rule as every other
    fleet counter), queue depths sum from the replicas' last-known
    ``/debug/state`` tenant sections, and the derived rates —
    ``attainment`` (attained / requests) and ``token_share``
    (tokens_out / fleet tokens_out) — divide the SUMS, never average
    per-replica ratios. None when no replica exposes tenant series
    (an all-disabled or pre-tenant fleet)."""
    rows = {}
    seen = False

    def _row(t):
        return rows.setdefault(
            t, dict({k: 0 for k, _ in _TENANT_COUNTERS}, queued=0))

    for snap in snapshots:
        for key, family in _TENANT_COUNTERS:
            fam = (snap or {}).get(family)
            if not fam:
                continue
            seen = True
            for labels, v in (fam.get("values") or {}).items():
                if not labels.startswith("tenant=") \
                        or not isinstance(v, (int, float)):
                    continue
                _row(labels[len("tenant="):])[key] += v
    folded = 0
    for state in states:
        sec = (state or {}).get("tenants") or {}
        if not sec.get("enabled"):
            continue
        seen = True
        folded += (sec.get("overflow") or {}).get("folded_events") or 0
        for t, entry in (sec.get("tenants") or {}).items():
            _row(t)["queued"] += entry.get("queued") or 0
    if not seen:
        return None
    total_out = sum(r["tokens_out"] for r in rows.values())
    for row in rows.values():
        row["attainment"] = round(
            row["attained"] / row["requests"], 4) \
            if row["requests"] else None
        row["token_share"] = round(
            row["tokens_out"] / total_out, 4) if total_out else None
    ordered = dict(sorted(rows.items(),
                          key=lambda kv: (-kv[1]["tokens_out"],
                                          kv[0])))
    return {
        "tenant_count": len(ordered),
        "overflow_folded": folded,
        "tenants": ordered,
    }


def fleet_aggregate(entries, snapshots, states=()):
    """The ``FLEET_AGG_KEYS`` block: availability census + exact
    counter sums + bucket-wise merged latency percentiles. ``entries``
    are the per-replica rows; ``snapshots`` the last-known metrics
    snapshots of every replica that ever scraped (down replicas'
    already-served work still counts); ``states`` the last-known
    ``/debug/state`` bodies (the cache MRC/heat merge sources)."""
    verdicts = [e["verdict"] for e in entries]
    up = sum(v == "up" for v in verdicts)
    stale = sum(v == "stale" for v in verdicts)
    down = len(verdicts) - up - stale
    healthy = bool(entries) and all(
        e["verdict"] == "up" and e["healthy"] is True
        and not e["degraded"] and not e["draining"] for e in entries)
    live = [e for e in entries if e["verdict"] != "down"]
    return {
        "size": len(entries),
        "up": up,
        "stale": stale,
        "down": down,
        "healthy": healthy,
        "queue_depth": _sum_known([e["queue_depth"] for e in live]),
        "occupancy": _mean_known([e["occupancy"] for e in live]),
        "step_rate": _sum_known([e["step_rate"] for e in live]),
        "tokens_generated": _sum_known(
            [e["tokens_generated"] for e in entries]),
        "goodput_tokens": _sum_known(
            [e["goodput_tokens"] for e in entries]),
        "requests_completed": _sum_known(
            [e["requests_completed"] for e in entries]),
        "latency": merged_latency(snapshots),
        "roofline_fraction": _mean_known(
            [e["roofline_fraction"] for e in live]),
        "cache": fleet_cache(snapshots, states),
        "tenants": fleet_tenants(snapshots, states),
    }
