"""Thread-safe metrics registry: counters, gauges, fixed-bucket
histograms — with labels, a stable JSON snapshot, and Prometheus text
exposition (a copy of ``paddle_tpu/observability/registry.py``).

Pure stdlib: no prometheus_client dependency — the text format
(HELP/TYPE lines, label escaping, cumulative ``le`` histogram buckets)
is emitted directly, byte for byte the reference's
(tests/test_torch_observability.py).

Three metric kinds, one family model:

  * ``Counter``  — monotone float total, ``inc(n)``;
  * ``Gauge``    — settable float, ``set(v)`` / ``inc`` / ``dec``;
  * ``Histogram``— fixed upper-bound buckets declared at registration
                   (never resized: bounded memory under sustained
                   traffic), ``observe(v)`` with
                   cumulative bucket counts + sum + count exposition.

A family declared with ``labelnames`` hands out per-label-value
children via ``labels(...)``; without labelnames the family IS its
single child (``counter.inc()`` just works). ``MetricsRegistry`` is
fully lock-protected; ``default_registry()`` is one process-global
registry.

``start_metrics_server(registry)`` serves ``/metrics`` (Prometheus
text) and ``/metrics.json`` (the snapshot) from a stdlib
ThreadingHTTPServer daemon thread — the serving engine exposes it as
``ServingEngine.serve_metrics()``.
"""
import collections
import json
import math
import random
import threading
import time

# prometheus-style latency buckets (seconds): sub-ms to tens of seconds
DEFAULT_TIME_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

_NAME_OK = set("abcdefghijklmnopqrstuvwxyz"
               "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def _check_name(name):
    if not name or name[0].isdigit() or not set(name) <= _NAME_OK:
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _escape_label(value):
    """Prometheus label-value escaping: backslash, double-quote, LF."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text):
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v):
    """Sample-value formatting: integers without a trailing .0;
    non-finite values in canonical Prometheus spelling."""
    f = float(v)
    if not math.isfinite(f):
        return "NaN" if f != f else ("+Inf" if f > 0 else "-Inf")
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class _Child:
    """One (labelvalues) series of a counter/gauge family."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock):
        self._lock = lock
        self._value = 0.0

    @property
    def value(self):
        return self._value

    def inc(self, amount=1.0):
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self._value += amount

    def set_to(self, value):
        """Absolute set — the facade hook for code that keeps a python
        attribute in sync (ServingMetrics' ``metrics.compiles += 1``
        property pattern)."""
        with self._lock:
            self._value = float(value)


class _GaugeChild(_Child):
    __slots__ = ("_fn", "_on_error")

    def __init__(self, lock, on_error=None):
        super().__init__(lock)
        self._fn = None
        self._on_error = on_error

    @property
    def value(self):
        fn = self._fn
        if fn is not None:
            # called OUTSIDE the registry lock: the callback may take
            # its own locks (reservoir pruning); a failing callback
            # must not 500 the scrape — the series exports NaN and the
            # failure is counted in metrics_scrape_errors_total
            try:
                return float(fn())
            except Exception:
                if self._on_error is not None:
                    try:
                        self._on_error()
                    except Exception:
                        pass
                return float("nan")
        return self._value

    def inc(self, amount=1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount=1.0):
        self.inc(-amount)

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def set_function(self, fn):
        """Make this gauge PULL its value from ``fn()`` at every
        exposition (snapshot / Prometheus scrape) — the sliding-window
        percentile gauges use this so /metrics reflects the window at
        scrape time, not at the last observation."""
        with self._lock:
            self._fn = fn


class _HistogramChild:
    """Fixed-bucket histogram series: bucket counts stay per-bucket
    internally and cumulate only at exposition/snapshot time."""

    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count")

    def __init__(self, lock, bounds):
        self._lock = lock
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, value):
        v = float(value)
        with self._lock:
            i = 0
            for i, b in enumerate(self._bounds):
                if v <= b:
                    break
            else:
                i = len(self._bounds)
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def sum(self):
        return self._sum

    @property
    def count(self):
        return self._count

    def cumulative_buckets(self):
        """[(upper_bound_label, cumulative_count), ...] ending at +Inf."""
        out, acc = [], 0
        with self._lock:
            counts = list(self._counts)
        for b, c in zip(self._bounds, counts):
            acc += c
            out.append((format(b, "g"), acc))
        out.append(("+Inf", acc + counts[-1]))
        return out


# where an over-cardinality label value folds to: one shared overflow
# series per family instead of an unbounded child dict (an adversarial
# label flood — 10k unique tenant ids, say — must cost O(cap) memory)
OVERFLOW_LABEL = "~other"


class _Family:
    """A named metric family: help text, label names, children.

    Label cardinality is BOUNDED: once a family holds
    ``registry.max_label_values`` distinct label-value tuples, any NEW
    tuple folds into the ``OVERFLOW_LABEL`` series (every label
    position set to ``~other``) and the fold is counted in the
    lazily-registered ``metrics_label_overflow_total{family}`` counter
    — so a label flood degrades to one aggregate series plus an
    attributed alarm, never an unbounded registry."""

    kind = None

    def __init__(self, registry, name, help_text, labelnames):
        self.name = _check_name(name)
        self.help = help_text
        self.labelnames = tuple(labelnames)
        for ln in self.labelnames:
            _check_name(ln)
        self._registry = registry
        self._lock = registry._lock
        self._children = {}
        if not self.labelnames:
            self._children[()] = self._make_child()

    def _make_child(self):
        raise NotImplementedError

    def labels(self, *values, **kwvalues):
        if kwvalues:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "name, not both")
            values = tuple(kwvalues[ln] for ln in self.labelnames)
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got "
                f"{values}")
        folded = False
        with self._lock:
            child = self._children.get(values)
            if child is None:
                cap = getattr(self._registry, "max_label_values", 0)
                if cap and len(self._children) >= cap:
                    folded = True
                    values = tuple(OVERFLOW_LABEL for _ in values)
                    child = self._children.get(values)
                if child is None:
                    child = self._children[values] = self._make_child()
        if folded and self.name != "metrics_label_overflow_total":
            self._registry.label_overflow(self.name)
        return child

    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; call "
                f".labels(...) first")
        return self._children[()]

    def series(self):
        """Stable-ordered [(labelvalues, child)] view."""
        with self._lock:
            return sorted(self._children.items())


class Counter(_Family):
    kind = "counter"

    def _make_child(self):
        return _Child(self._lock)

    def inc(self, amount=1.0):
        self._default().inc(amount)

    def set_to(self, value):
        self._default().set_to(value)

    @property
    def value(self):
        return self._default().value


class Gauge(_Family):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild(self._lock, on_error=self._scrape_error)

    def _scrape_error(self):
        self._registry.scrape_error(self.name)

    def set(self, value):
        self._default().set(value)

    def inc(self, amount=1.0):
        self._default().inc(amount)

    def dec(self, amount=1.0):
        self._default().dec(amount)

    def set_function(self, fn):
        self._default().set_function(fn)

    @property
    def value(self):
        return self._default().value


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, registry, name, help_text, labelnames, buckets):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = bounds
        super().__init__(registry, name, help_text, labelnames)

    def _make_child(self):
        return _HistogramChild(self._lock, self.buckets)

    def observe(self, value):
        self._default().observe(value)

    @property
    def sum(self):
        return self._default().sum

    @property
    def count(self):
        return self._default().count


class Reservoir:
    """Fixed-size uniform sample of an unbounded observation stream
    (Vitter's Algorithm R) — exact percentiles over a bounded memory
    footprint. Deterministically seeded so snapshots are reproducible
    under test."""

    def __init__(self, capacity=1024, seed=0x5EED):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._rng = random.Random(seed)
        self._samples = []
        self._seen = 0
        self._lock = threading.Lock()

    def add(self, value):
        v = float(value)
        with self._lock:
            self._seen += 1
            if len(self._samples) < self.capacity:
                self._samples.append(v)
            else:
                j = self._rng.randrange(self._seen)
                if j < self.capacity:
                    self._samples[j] = v

    @property
    def seen(self):
        return self._seen

    def samples(self):
        with self._lock:
            return tuple(self._samples)

    def percentile(self, q):
        """Linear-interpolated percentile over the current sample,
        q in [0, 100]; None when empty."""
        with self._lock:
            xs = sorted(self._samples)
        return _interp_percentile(xs, q)


def _interp_percentile(xs, q):
    """Linear-interpolated percentile of a sorted list; None if empty."""
    if not xs:
        return None
    if len(xs) == 1:
        return xs[0]
    pos = (float(q) / 100.0) * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


# ------------------------------------------------ scrape-merge support
# The federation layer (observability.fleet) aggregates MANY replica
# registries from their scraped ``snapshot()`` JSON. Merging lives
# here, next to the exposition format it inverts: counters/gauges sum,
# histograms merge BUCKET-WISE (every engine histogram is fixed-bucket
# by construction, so bucket counts are additive and fleet percentiles
# come from the merged distribution — never from averaged per-replica
# percentiles, which is statistically meaningless).

def _bucket_bound(le):
    return float("inf") if le == "+Inf" else float(le)


def merge_histogram_snapshots(entries):
    """Merge snapshot-format histogram dicts (``{count, sum, buckets:
    {le: cumulative}}``) bucket-wise: counts and sums add, cumulative
    bucket counts add per ``le`` bound. Entries with different bucket
    layouts merge over the UNION of bounds (a missing bound inherits
    the entry's nearest lower cumulative count — exact for the
    fixed-bucket families this stack emits, conservative otherwise).
    Returns the same shape; ``None``/empty input merges to a zero
    histogram."""
    entries = [e for e in (entries or []) if e]
    bounds = sorted({b for e in entries for b in e.get("buckets", {})},
                    key=_bucket_bound)
    if "+Inf" not in bounds:
        bounds.append("+Inf")
    merged = {le: 0 for le in bounds}
    total_count = 0
    total_sum = 0.0
    for e in entries:
        total_count += int(e.get("count", 0))
        total_sum += float(e.get("sum", 0.0))
        ebuckets = sorted(e.get("buckets", {}).items(),
                          key=lambda kv: _bucket_bound(kv[0]))
        for le in bounds:
            cum = 0
            bound = _bucket_bound(le)
            for ele, ecum in ebuckets:
                if _bucket_bound(ele) <= bound:
                    cum = ecum
                else:
                    break
            if le == "+Inf":
                cum = int(e.get("count", 0))
            merged[le] += int(cum)
    return {"count": total_count, "sum": round(total_sum, 6),
            "buckets": merged}


def percentile_from_buckets(buckets, q):
    """Percentile estimate from cumulative fixed buckets (``{le:
    cumulative}``), Prometheus ``histogram_quantile`` style: find the
    bucket the q-quantile rank lands in and interpolate linearly
    inside it. The +Inf bucket clamps to the largest finite bound (no
    invented upper edge). None when empty."""
    if not buckets:
        return None
    items = sorted(buckets.items(), key=lambda kv: _bucket_bound(kv[0]))
    total = items[-1][1]
    if not total:
        return None
    target = (float(q) / 100.0) * total
    prev_cum, prev_bound = 0, 0.0
    largest_finite = max((_bucket_bound(le) for le, _ in items
                          if le != "+Inf"), default=0.0)
    for le, cum in items:
        bound = _bucket_bound(le)
        if cum >= target:
            if bound == float("inf"):
                return largest_finite
            in_bucket = cum - prev_cum
            frac = ((target - prev_cum) / in_bucket) if in_bucket else 1.0
            return prev_bound + frac * (bound - prev_bound)
        prev_cum, prev_bound = cum, (bound if bound != float("inf")
                                     else prev_bound)
    return largest_finite


def _parse_series_key(key):
    """Invert the snapshot series key format ('k=v,k=v', '' for
    unlabeled) back into label pairs. Exact for every label value this
    stack emits (program keys, detector names, span scopes, shed
    reasons — none contain ',' or '='); foreign values containing
    either would split lossily, which the fleet exposition accepts."""
    if not key:
        return []
    pairs = []
    for part in key.split(","):
        k, _, v = part.partition("=")
        pairs.append((k, v))
    return pairs


def prometheus_text_from_snapshots(labeled_snapshots,
                                   label="replica"):
    """Render MANY registry ``snapshot()`` dicts as ONE Prometheus
    text exposition, stamping each snapshot's series with an extra
    ``label`` (default ``replica``) — the scrape-merge step of the
    fleet federation surface (``/fleet/metrics``): per-replica series
    stay distinct (Prometheus-federation style), and any downstream
    aggregation can sum/merge them knowing which replica each sample
    came from. ``labeled_snapshots`` is an iterable of
    ``(label_value, snapshot_dict)``."""
    labeled = [(str(lv), snap or {}) for lv, snap in labeled_snapshots]
    names = sorted({n for _, snap in labeled for n in snap})
    lines = []
    for name in names:
        fams = [(lv, snap[name]) for lv, snap in labeled
                if name in snap]
        kind = fams[0][1].get("type", "gauge")
        help_text = next((f.get("help") for _, f in fams
                          if f.get("help")), "")
        if help_text:
            lines.append(f"# HELP {name} {_escape_help(help_text)}")
        lines.append(f"# TYPE {name} {kind}")
        for lv, fam in fams:
            if fam.get("type", kind) != kind:
                continue      # kind clash across replicas: skip, never 500
            for key in sorted(fam.get("values", {})):
                value = fam["values"][key]
                pairs = [(label, lv)] + _parse_series_key(key)
                body = ",".join(f'{k}="{_escape_label(v)}"'
                                for k, v in pairs)
                if kind == "histogram" and isinstance(value, dict):
                    buckets = sorted(
                        value.get("buckets", {}).items(),
                        key=lambda kv: _bucket_bound(kv[0]))
                    for le, cum in buckets:
                        lines.append(
                            f'{name}_bucket{{{body},le='
                            f'"{_escape_label(le)}"}} {_fmt(cum)}')
                    lines.append(f"{name}_sum{{{body}}} "
                                 f"{_fmt(value.get('sum', 0.0))}")
                    lines.append(f"{name}_count{{{body}}} "
                                 f"{_fmt(value.get('count', 0))}")
                else:
                    try:
                        sample = _fmt(value)
                    except (TypeError, ValueError):
                        continue
                    lines.append(f"{name}{{{body}}} {sample}")
    return "\n".join(lines) + "\n"


class WindowedReservoir:
    """Sliding-TIME-window observation buffer: percentiles over the
    last ``window_s`` seconds of traffic instead of process lifetime
    (the uniform Reservoir above never forgets — a latency spike from
    an hour ago still shapes its p99). Bounded two ways: observations
    older than the window are pruned at every add/read, and the buffer
    never holds more than ``capacity`` points (burst overflow drops
    the OLDEST — the window stays recency-faithful).

    ``clock`` is injectable (tests drive a fake monotonic clock); an
    explicit ``now=`` on any method overrides it per call.
    """

    def __init__(self, window_s=60.0, capacity=4096,
                 clock=time.monotonic):
        if window_s <= 0:
            raise ValueError("window_s must be > 0")
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.window_s = float(window_s)
        self.capacity = int(capacity)
        self._clock = clock
        self._buf = collections.deque()   # (t, value), t ascending
        self._seen = 0
        self._lock = threading.Lock()

    def _prune(self, now):
        cutoff = now - self.window_s
        while self._buf and self._buf[0][0] < cutoff:
            self._buf.popleft()

    def add(self, value, now=None):
        now = self._clock() if now is None else float(now)
        with self._lock:
            self._seen += 1
            self._prune(now)
            if len(self._buf) == self.capacity:
                self._buf.popleft()
            self._buf.append((now, float(value)))

    @property
    def seen(self):
        """Observations ever added (window pruning doesn't unsee)."""
        return self._seen

    def values(self, now=None):
        now = self._clock() if now is None else float(now)
        with self._lock:
            self._prune(now)
            return [v for _, v in self._buf]

    def count(self, now=None):
        return len(self.values(now))

    def percentile(self, q, now=None):
        """Linear-interpolated percentile over the CURRENT window,
        q in [0, 100]; None when the window is empty."""
        return _interp_percentile(sorted(self.values(now)), q)


class MetricsRegistry:
    """Named families, one namespace; snapshot() and prometheus_text()
    are the two exposition surfaces (JSON artifact / scrape)."""

    def __init__(self, max_label_values=128):
        self._lock = threading.RLock()
        self._families = {}
        # per-family distinct-label-value cap (0 disables): generous
        # enough that every legitimate family in this stack (span
        # scopes, detectors, shed reasons, bounded tenant ids) never
        # folds, small enough that an adversarial flood can't blow up
        # the registry — overflow folds into OVERFLOW_LABEL and counts
        # in metrics_label_overflow_total{family}
        self.max_label_values = int(max_label_values)

    def _register(self, cls, name, help_text, labelnames, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != cls.kind or \
                        fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered as a different "
                        f"kind/labelset")
                return fam
            fam = cls(self, name, help_text, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name, help_text="", labelnames=()):
        return self._register(Counter, name, help_text, labelnames)

    def gauge(self, name, help_text="", labelnames=()):
        return self._register(Gauge, name, help_text, labelnames)

    def histogram(self, name, help_text="", labelnames=(),
                  buckets=DEFAULT_TIME_BUCKETS):
        return self._register(Histogram, name, help_text, labelnames,
                              buckets=buckets)

    def scrape_error(self, metric_name):
        """Record one gauge pull-callback failure at scrape/snapshot
        time (the series exported NaN instead of 500ing the whole
        exposition). The ``metrics_scrape_errors_total{metric}``
        counter is registered LAZILY on the first failure, so a clean
        registry exposes no error family at all."""
        self.counter(
            "metrics_scrape_errors_total",
            "gauge set_function callbacks that raised at scrape time "
            "(the series exported NaN; the exposition survived)",
            labelnames=("metric",)).labels(str(metric_name)).inc()

    def label_overflow(self, family_name):
        """Record one over-cardinality label fold (see _Family.labels).
        The ``metrics_label_overflow_total{family}`` counter is
        registered LAZILY on the first fold, so a registry that never
        overflows exposes no overflow family at all."""
        self.counter(
            "metrics_label_overflow_total",
            "label-value tuples folded into the ~other overflow "
            "series because the family hit max_label_values",
            labelnames=("family",)).labels(str(family_name)).inc()

    def get(self, name):
        with self._lock:
            return self._families.get(name)

    def families(self):
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    # ---------------------------------------------------- exposition
    def snapshot(self):
        """Stable, JSON-serializable view: family name -> {type, help,
        values} with label series keyed 'k=v,k=v' ('' for unlabeled)."""
        out = {}
        for fam in self.families():
            values = {}
            for labelvalues, child in fam.series():
                key = ",".join(f"{k}={v}" for k, v in
                               zip(fam.labelnames, labelvalues))
                if fam.kind == "histogram":
                    values[key] = {
                        "count": child.count,
                        "sum": round(child.sum, 6),
                        "buckets": dict(child.cumulative_buckets()),
                    }
                else:
                    values[key] = child.value
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "values": values}
        return out

    def snapshot_json(self):
        return json.dumps(self.snapshot(), sort_keys=True)

    def prometheus_text(self):
        """Prometheus text exposition format 0.0.4: HELP/TYPE lines,
        escaped label values, cumulative histogram buckets with the
        canonical _bucket/_sum/_count triple."""
        lines = []
        for fam in self.families():
            if fam.help:
                lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for labelvalues, child in fam.series():
                pairs = [f'{k}="{_escape_label(v)}"' for k, v in
                         zip(fam.labelnames, labelvalues)]
                base = "{" + ",".join(pairs) + "}" if pairs else ""
                if fam.kind == "histogram":
                    for le, cum in child.cumulative_buckets():
                        bpairs = pairs + [f'le="{le}"']
                        lines.append(f"{fam.name}_bucket{{"
                                     + ",".join(bpairs) + f"}} {cum}")
                    lines.append(f"{fam.name}_sum{base} "
                                 f"{_fmt(child.sum)}")
                    lines.append(f"{fam.name}_count{base} "
                                 f"{child.count}")
                else:
                    lines.append(f"{fam.name}{base} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"


_default_registry = MetricsRegistry()


def default_registry():
    """The process-global registry."""
    return _default_registry


class MetricsServerHandle:
    """Cleanly-stoppable handle for a running metrics HTTP server:
    ``close()`` is idempotent (shutdown + socket close + thread join),
    the handle is a context manager, and the legacy server surface
    (``server_address``, ``shutdown()``) is preserved so existing
    callers keep working. The serving engine tracks every handle it
    hands out and closes them in ``ServingEngine.close()`` — the
    daemon thread no longer leaks across tests."""

    def __init__(self, server, thread):
        self._server = server
        self._thread = thread
        self._lock = threading.Lock()
        self._closed = False

    @property
    def server_address(self):
        return self._server.server_address

    @property
    def port(self):
        return self._server.server_address[1]

    @property
    def url(self):
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    @property
    def closed(self):
        return self._closed

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)

    def shutdown(self):  # legacy alias (pre-handle callers)
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def start_metrics_server(registry=None, port=0, addr="127.0.0.1",
                         extra_routes=None, post_routes=None,
                         max_body_bytes=1 << 20):
    """Serve ``/metrics`` (Prometheus text) and ``/metrics.json`` (the
    snapshot) on a stdlib HTTP server in a daemon thread.
    ``extra_routes`` maps additional paths to zero-arg callables: a
    JSON-serializable return value is served as application/json (the
    serving engine mounts ``/debug/requests`` and ``/debug/state``
    this way), a ``str`` return value is served as Prometheus-flavored
    text/plain (the fleet server mounts its merged ``/fleet/metrics``
    exposition this way). ``GET /debug`` serves the route index
    ({"routes": [every mounted path]}) so operators can discover the
    surface without reading source (an explicit ``/debug`` extra
    route overrides the built-in index). Every route — the built-in
    /metrics pair included — renders its FULL body before any byte
    goes on the wire, and a rendering failure turns into a 500, so a
    scraper racing an engine shutdown reads either a complete
    response or a clean error, never a truncated half-body.

    ``post_routes`` maps paths to one-arg callables receiving the
    request's parsed-JSON body (the serving gateway mounts
    ``POST /v1/generate`` this way). The callable returns either a
    payload (served as 200 application/json) or a ``(status,
    payload)`` tuple for explicit status codes (e.g. 503 while
    draining). The wire contract is defensive by construction: a body
    over ``max_body_bytes`` is refused with 413 before it is read, a
    missing/oversized-or-absent Content-Length is a 411/413, malformed
    JSON (or a non-object body) is a 400 with a JSON error envelope —
    never a traceback — and a handler exception is a clean 500.

    Returns a MetricsServerHandle: ``handle.port`` is the bound port
    (``port=0`` picks a free one), ``handle.close()`` stops it
    (idempotent; also a context manager)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    reg = registry if registry is not None else default_registry()
    routes = dict(extra_routes or {})
    posts = dict(post_routes or {})
    if "/debug" not in routes:
        index = sorted(["/metrics", "/metrics.json", "/debug"]
                       + list(routes) + list(posts))
        routes["/debug"] = lambda: {"routes": index}

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, status, payload):
            body = json.dumps(payload, sort_keys=True).encode("utf-8")
            try:
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass

        def do_POST(self):
            path = self.path.split("?", 1)[0].rstrip("/")
            handler = posts.get(path)
            if handler is None:
                self.send_error(405 if path in routes else 404)
                return
            try:
                length = int(self.headers.get("Content-Length", ""))
            except ValueError:
                self._reply(411, {"error": "Content-Length required"})
                return
            if length > max_body_bytes:
                self._reply(413, {
                    "error": "body too large",
                    "max_body_bytes": max_body_bytes})
                return
            raw = self.rfile.read(max(0, length))
            try:
                body = json.loads(raw.decode("utf-8"))
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except Exception as e:  # noqa: BLE001 - 400, no traceback
                self._reply(400, {
                    "error": "malformed JSON body",
                    "detail": f"{type(e).__name__}: {e}"[:200]})
                return
            try:
                out = handler(body)
            except Exception as e:  # noqa: BLE001 - 500, no traceback
                self._reply(500, {
                    "error": f"{type(e).__name__}: {e}"[:200]})
                return
            if (isinstance(out, tuple) and len(out) == 2
                    and isinstance(out[0], int)):
                self._reply(out[0], out[1])
            else:
                self._reply(200, out)

        def do_GET(self):
            path, _, query = self.path.partition("?")
            path = path.rstrip("/") or "/metrics"
            try:
                if path == "/metrics":
                    body = reg.prometheus_text().encode("utf-8")
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/metrics.json":
                    body = reg.snapshot_json().encode("utf-8")
                    ctype = "application/json"
                elif path in routes:
                    fn = routes[path]
                    if getattr(fn, "accepts_query", False):
                        # a route opting into query params (e.g. the
                        # engine's /debug/requests?tenant= filter)
                        # receives {param: last_value}
                        from urllib.parse import parse_qs
                        params = {k: v[-1] for k, v in
                                  parse_qs(query).items()}
                        payload = fn(params)
                    else:
                        payload = fn()
                    if isinstance(payload, str):
                        body = payload.encode("utf-8")
                        ctype = ("text/plain; version=0.0.4; "
                                 "charset=utf-8")
                    else:
                        body = json.dumps(
                            payload, sort_keys=True).encode("utf-8")
                        ctype = "application/json"
                else:
                    self.send_error(404)
                    return
            except Exception as e:  # noqa: BLE001 - 500, never half-body
                try:
                    self.send_error(500, f"{type(e).__name__}: {e}")
                except Exception:   # peer already gone mid-shutdown
                    pass
                return
            try:
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError, OSError):
                # the scraper hung up (or the server is closing the
                # socket under us mid-shutdown): nothing to answer
                pass

        def log_message(self, *args):  # silence per-request stderr spam
            pass

    server = ThreadingHTTPServer((addr, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="paddle-tpu-metrics")
    thread.start()
    return MetricsServerHandle(server, thread)
