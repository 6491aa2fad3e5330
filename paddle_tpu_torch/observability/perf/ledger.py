"""Cross-run perf ledger: one normalized JSONL row per
(scenario, metric) per benchmark run, plus the robust comparison logic
a regression gate runs (a copy of
``paddle_tpu/observability/perf/ledger.py``; the schema string is the
reference's, so either package reads the other's ledger).

The ledger is the durable, append-only record that makes performance
a TRAJECTORY: every benchmark run appends rows like::

    {"schema": "paddle_tpu.perf_ledger/v1", "timestamp": "...",
     "run_id": "serving_smoke_...json", "source": "live-smoke",
     "scenario": "overload", "metric": "goodput_improvement",
     "value": 4.2, "unit": "ratio", "direction": "higher_better",
     "config_digest": "1a2b3c4d5e6f", "device": "cpu",
     "rel_threshold": 0.35}

Rows are self-describing on purpose: ``direction`` says which way is
worse, ``config_digest`` isolates incomparable configurations (a
changed workload starts a fresh baseline instead of a false alarm),
and the optional per-row ``rel_threshold`` lets the WRITER declare a
metric's noise floor (raw CPU timings get a looser gate than ratios).
Timestamps are passed in by the caller — this module never reads a
clock, so replays and tests are deterministic.

``compare()`` implements the regression verdict: current (last) row
per group vs the median of its history, flagged only when the
relative worsening exceeds the threshold AND clears a MAD-based noise
gate over that history (a single noisy baseline row can't shadow-ban
a metric, a genuinely bimodal history widens its own gate).

Retention and triage are separate knobs: ``compact()`` bounds healthy
history (newest N rows per series), ``prune()`` retires poisoned
history — a host-overloaded run whose trailing rows keep the gate
red, or a renamed metric's stale series.

Deliberately dependency-free (stdlib only): a gate can load this file
directly via importlib.
"""
import hashlib
import json
import math

PERF_LEDGER_SCHEMA = "paddle_tpu.perf_ledger/v1"

# required row fields (rel_threshold is optional, writer-declared)
LEDGER_ROW_KEYS = (
    "schema", "timestamp", "run_id", "source", "scenario", "metric",
    "value", "unit", "direction", "config_digest", "device",
)

_DIRECTIONS = ("higher_better", "lower_better")

# optional writer-declared row provenance: "timed" rows ride wall
# clocks (noisy on a shared smoke runner), "deterministic" rows are
# measured from live run counters but fully determined by the seeded
# workload + code (zero variance across healthy runs — any movement
# IS a code-path change, so they carry tight thresholds)
MEASUREMENTS = ("timed", "deterministic")


def config_digest(config):
    """Short stable digest of a (JSON-serializable) config dict: rows
    from different workload configurations never compare against each
    other — a config change establishes a fresh baseline."""
    blob = json.dumps(config, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:12]


def make_row(*, timestamp, run_id, source, scenario, metric, value,
             unit, direction, config_digest, device,
             rel_threshold=None, measurement=None):
    """Validated ledger row. ``timestamp`` is caller-provided (no
    clock reads here); ``direction`` must name which way is worse;
    ``value`` must be a finite number; ``measurement`` optionally
    declares the row's provenance (see ``MEASUREMENTS``)."""
    if direction not in _DIRECTIONS:
        raise ValueError(f"direction must be one of {_DIRECTIONS}, "
                         f"got {direction!r}")
    v = float(value)
    if not math.isfinite(v):
        raise ValueError(f"value must be finite, got {value!r}")
    if not scenario or not metric:
        raise ValueError("scenario and metric must be non-empty")
    row = {
        "schema": PERF_LEDGER_SCHEMA,
        "timestamp": str(timestamp),
        "run_id": str(run_id),
        "source": str(source),
        "scenario": str(scenario),
        "metric": str(metric),
        "value": v,
        "unit": str(unit),
        "direction": direction,
        "config_digest": str(config_digest),
        "device": str(device),
    }
    if rel_threshold is not None:
        t = float(rel_threshold)
        if not (0.0 < t < 10.0):
            raise ValueError(f"rel_threshold out of range: {t}")
        row["rel_threshold"] = t
    if measurement is not None:
        if measurement not in MEASUREMENTS:
            raise ValueError(f"measurement must be one of "
                             f"{MEASUREMENTS}, got {measurement!r}")
        row["measurement"] = measurement
    return row


def append_rows(path, rows):
    """Append validated rows to the JSONL ledger (one object per
    line). Rows missing required keys are rejected before anything is
    written — a partial append never corrupts the ledger."""
    rows = list(rows)
    for row in rows:
        missing = [k for k in LEDGER_ROW_KEYS if k not in row]
        if missing:
            raise ValueError(f"ledger row missing {missing}: {row}")
    with open(path, "a") as fh:
        for row in rows:
            fh.write(json.dumps(row, sort_keys=True) + "\n")
    return len(rows)


def read_rows(path):
    """(rows, skipped): every parseable row carrying the ledger
    schema, in file (= append) order; junk lines and foreign schemas
    are counted, never fatal — one corrupt line must not kill the CI
    gate."""
    rows, skipped = [], 0
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError:
                skipped += 1
                continue
            if not isinstance(row, dict) \
                    or row.get("schema") != PERF_LEDGER_SCHEMA \
                    or not isinstance(row.get("value"), (int, float)):
                skipped += 1
                continue
            rows.append(row)
    return rows, skipped


def compact(path, keep_last):
    """Bound the ledger: rewrite it keeping only the NEWEST
    ``keep_last`` rows per (scenario, metric, config_digest) series,
    preserving append order. The ledger grows one row per (scenario,
    metric) per benchmark run forever — compaction is the retention
    knob. The rewrite is atomic (temp file + replace), so a
    crash mid-compaction never corrupts the ledger; junk lines and
    foreign schemas are dropped (they were already invisible to
    ``compare()``). Returns ``(kept, dropped)`` row counts."""
    keep_last = int(keep_last)
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    import os
    rows, skipped = read_rows(path)
    per_series = {}
    for row in rows:
        key = (row["scenario"], row["metric"],
               row.get("config_digest", ""))
        per_series.setdefault(key, []).append(row)
    keep = set()
    for series in per_series.values():
        for row in series[-keep_last:]:
            keep.add(id(row))
    kept = [r for r in rows if id(r) in keep]
    tmp = path + ".compact.tmp"
    with open(tmp, "w") as fh:
        for row in kept:
            fh.write(json.dumps(row, sort_keys=True) + "\n")
    os.replace(tmp, path)
    return len(kept), len(rows) - len(kept) + skipped


def prune(path, run_ids=(), series=()):
    """Triage the ledger: atomically rewrite it DROPPING every row
    whose ``run_id`` is in ``run_ids``, or whose (scenario, metric)
    matches a ``"scenario/metric"`` spec in ``series``.

    ``compact`` bounds healthy history; ``prune`` retires poisoned
    history — a host-overloaded run that left red verdicts behind
    (``compare()`` judges each series' LAST row, so one bad trailing
    run keeps the gate red until a newer run lands or the bad rows
    are pruned), or a retired metric name whose stale series would
    otherwise shadow the trajectory table forever. Junk lines and foreign
    schemas are dropped like ``compact`` does (they were already
    invisible to ``compare()``); the rewrite is atomic (temp file +
    replace). Returns ``(kept, dropped)`` row counts."""
    import os
    run_ids = {str(r) for r in run_ids}
    pairs = set()
    for spec in series:
        scenario, sep, metric = str(spec).partition("/")
        if not sep or not scenario or not metric:
            raise ValueError(f"series spec must be "
                             f"'scenario/metric', got {spec!r}")
        pairs.add((scenario, metric))
    rows, skipped = read_rows(path)
    kept = [r for r in rows
            if r.get("run_id") not in run_ids
            and (r.get("scenario"), r.get("metric")) not in pairs]
    tmp = path + ".prune.tmp"
    with open(tmp, "w") as fh:
        for row in kept:
            fh.write(json.dumps(row, sort_keys=True) + "\n")
    os.replace(tmp, path)
    return len(kept), len(rows) - len(kept) + skipped


def _median(xs):
    s = sorted(xs)
    n = len(s)
    if not n:
        return None
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _mad(xs, center):
    """Median absolute deviation around ``center``."""
    if not xs:
        return 0.0
    return _median([abs(x - center) for x in xs]) or 0.0


def compare(rows, default_rel_threshold=0.35, mad_k=3.0):
    """Judge the LAST row of every (scenario, metric, config_digest)
    group against the median of its earlier rows.

    Verdicts: ``baseline`` (no history — first run establishes it),
    ``ok``, ``improvement`` (better than baseline by more than the
    threshold), ``regression``. A regression requires BOTH gates:

      * relative: worse than baseline by > rel_threshold (the row's
        own ``rel_threshold`` when present, else the default);
      * noise: |current - baseline| > mad_k * 1.4826 * MAD(history)
        (vacuous when history is too short to estimate spread — the
        relative gate alone decides then).

    Returns a list of group results sorted by (scenario, metric),
    each carrying the trajectory (history values + current) so
    callers can print it."""
    groups = {}
    for row in rows:
        key = (row["scenario"], row["metric"],
               row.get("config_digest", ""))
        groups.setdefault(key, []).append(row)
    results = []
    for (scenario, metric, digest) in sorted(groups):
        grp = groups[(scenario, metric, digest)]
        cur = grp[-1]
        history = [float(r["value"]) for r in grp[:-1]]
        value = float(cur["value"])
        direction = cur.get("direction", "higher_better")
        threshold = float(cur.get("rel_threshold",
                                  default_rel_threshold))
        result = {
            "scenario": scenario,
            "metric": metric,
            "config_digest": digest,
            "unit": cur.get("unit", ""),
            "direction": direction,
            "runs": len(grp),
            "history": history,
            "current": value,
            "current_run": cur.get("run_id"),
            "threshold": threshold,
            "baseline": None,
            "worse_by": None,
            "verdict": "baseline",
        }
        if history:
            baseline = _median(history)
            result["baseline"] = baseline
            if baseline:
                delta = (value - baseline) / abs(baseline)
                worse_by = -delta if direction == "higher_better" \
                    else delta
                result["worse_by"] = round(worse_by, 4)
                noise = mad_k * 1.4826 * _mad(history, baseline)
                beyond_noise = abs(value - baseline) > noise
                if worse_by > threshold and beyond_noise:
                    result["verdict"] = "regression"
                elif worse_by < -threshold:
                    result["verdict"] = "improvement"
                else:
                    result["verdict"] = "ok"
            else:
                # a zero baseline carries no scale: judge on absolute
                # worsening direction only, never divide
                worse = (value < 0) if direction == "higher_better" \
                    else (value > 0)
                result["worse_by"] = None
                result["verdict"] = "regression" if worse else "ok"
        results.append(result)
    return results
