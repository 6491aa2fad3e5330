"""Online anomaly detectors over the serving step ledger (a copy of
``paddle_tpu/observability/health/detectors.py``).

Each detector watches the per-step rows (health.ledger.StepLedger) for
ONE failure signature and returns a machine-readable verdict dict the
moment it fires — the HealthMonitor then counts it
(``serving_anomalies_total{detector=...}``), emits a flight-recorder-
style marker span, and (debounced) captures an incident bundle.

The framework mirrors ``analysis.lint.register_lint_pass``: detectors
are classes registered under a name via :func:`register_detector`;
:func:`build_detectors` instantiates the whole registry (with optional
per-detector kwarg overrides, e.g.
``{"queue_stall": {"stall_steps": 8}}``), so projects can plug their
own detectors in and tests can tighten thresholds.

Built-in detectors (every threshold errs on the quiet side — a clean
bench run must fire NOTHING; a wedge is never subtle):

``step_time_spike``
    step wall time far beyond the rolling window's median (MAD-scaled
    robust z plus an absolute floor and a median multiple). Steps that
    compiled are exempt — the steady-state-compile detector owns those
    (the port's engine compiles nothing, so none is).
``queue_stall``
    queued work with NO progress of any kind (no admissions, no
    tokens, no chunks, no completions) for N consecutive steps — the
    it-is-wedged-but-still-stepping signature.
``goodput_collapse``
    windowed SLO-met tokens/sec falling off a cliff: the previous
    window was healthy (>= healthy_frac of the engine's peak windowed
    rate) and the current adjacent window delivers < drop_frac of it
    while work is pending. Gradual degradation under deliberate
    overload passes through intermediate windows and does NOT fire —
    that regime belongs to the admission policy, not the alarm.
``kv_block_leak``
    a failed periodic ``PagedKVPool`` conservation audit, or blocks
    still referenced while the engine is completely idle (free-list
    drift — the slow leak that eventually starves admission).
``steady_state_compile``
    any executable built after ``declare_warmup()`` — the compile
    watchdog's violation surfaced as a first-class anomaly instead of
    a flag a human must go read.
``cache_thrash``
    sustained prefix-cache evict-then-reinsert churn (the radix
    index's thrash counter, per-step deltas summed over a
    rolling window) — the KV pool is smaller than the live prefix
    working set; a larger pool is the answer.
"""
import collections

# detector registries by SCOPE: "engine" detectors watch one engine's
# per-step ledger rows (the health observatory), "fleet" detectors watch
# the fleet poller's per-poll rollup rows (observability.fleet) — one
# framework, two row vocabularies, and a HealthMonitor never
# instantiates a fleet detector (or vice versa) because build_detectors
# only reads its own scope
_SCOPES = {"engine": {}}
_DETECTORS = _SCOPES["engine"]   # legacy alias (engine scope)


def _scope(scope):
    return _SCOPES.setdefault(scope, {})


def register_detector(name, scope="engine"):
    """Register a detector class/factory under ``name`` (zero-required-
    arg constructible; keyword thresholds only). Re-registering
    replaces — tests stub detectors this way. The instance's ``name``
    attribute is stamped to match. ``scope`` namespaces the registry:
    engine detectors (default) evaluate per-step ledger rows, fleet
    detectors (``scope="fleet"``) evaluate per-poll fleet rows."""
    def deco(factory):
        factory.name = name
        _scope(scope)[name] = factory
        return factory
    return deco


def unregister_detector(name, scope="engine"):
    """Remove a registered detector (test cleanup)."""
    return _scope(scope).pop(name, None)


def detector_names(scope="engine"):
    """All registered detector names in ``scope``, sorted."""
    return sorted(_scope(scope))


def build_detectors(overrides=None, only=None, scope="engine"):
    """Instantiate every detector registered in ``scope`` (or the
    ``only`` subset), passing ``overrides[name]`` as constructor
    kwargs when present — the ServingConfig(health_detectors=...) /
    FleetPoller(detector_config=...) plumbing."""
    overrides = dict(overrides or {})
    reg = _scope(scope)
    names = detector_names(scope) if only is None else list(only)
    out = []
    for n in names:
        if n not in reg:
            raise ValueError(f"unknown detector {n!r}; registered in "
                             f"scope {scope!r}: {detector_names(scope)}")
        out.append(reg[n](**overrides.get(n, {})))
    return out


class Detector:
    """Base: ``observe(row, ledger)`` returns a verdict dict when the
    anomaly fires this step, else None. Detectors keep their own
    rolling state; they are called from the engine's stepping thread
    only."""

    name = "detector"

    def observe(self, row, ledger):
        raise NotImplementedError

    def _verdict(self, row, reason, **extra):
        return dict({"detector": self.name, "step": row["step"],
                     "reason": reason}, **extra)


def _median(xs):
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


@register_detector("step_time_spike")
class StepTimeSpike(Detector):
    """Step wall time spike vs rolling median, MAD-based.

    Fires when a (non-compiling) step's wall time exceeds ALL of:
    ``min_wall_s`` (absolute floor — millisecond jitter is not an
    incident), ``spike_factor`` x the window median, and
    median + ``k_mad`` x 1.4826 x MAD (the robust z-score). Needs
    ``min_steps`` clean samples first. After firing the window resets:
    a new plateau becomes the new baseline instead of refiring every
    step. The median/MAD pair refreshes every ``refresh_every`` steps
    (the baseline drifts slowly; re-sorting the window per step is
    pure per-step overhead the observatory must not add)."""

    def __init__(self, window=64, min_steps=24, k_mad=8.0,
                 spike_factor=6.0, min_wall_s=0.5, refresh_every=8):
        self.window = int(window)
        self.min_steps = int(min_steps)
        self.k_mad = float(k_mad)
        self.spike_factor = float(spike_factor)
        self.min_wall_s = float(min_wall_s)
        self.refresh_every = int(refresh_every)
        self._hist = collections.deque(maxlen=self.window)
        self._stats = None          # (median, mad, threshold)
        self._since_refresh = 0

    def _refresh(self):
        med = _median(self._hist)
        mad = _median([abs(x - med) for x in self._hist])
        threshold = max(self.min_wall_s,
                        self.spike_factor * med,
                        med + self.k_mad * 1.4826 * mad)
        self._stats = (med, mad, threshold)
        self._since_refresh = 0

    def observe(self, row, ledger):
        if row.get("new_compiles"):
            # compile steps measure build time, not service — the
            # steady_state_compile detector owns post-warmup builds
            return None
        wall = float(row["wall_s"])
        if len(self._hist) >= self.min_steps:
            if self._stats is None \
                    or self._since_refresh >= self.refresh_every:
                self._refresh()
            self._since_refresh += 1
            med, mad, threshold = self._stats
            if wall > threshold:
                self._hist.clear()
                self._stats = None
                return self._verdict(
                    row,
                    f"step wall {wall * 1000.0:.1f}ms vs rolling "
                    f"median {med * 1000.0:.1f}ms",
                    wall_s=round(wall, 6),
                    rolling_median_s=round(med, 6),
                    rolling_mad_s=round(mad, 6),
                    threshold_s=round(threshold, 6))
        self._hist.append(wall)
        return None


@register_detector("queue_stall")
class QueueStall(Detector):
    """Queued work with zero progress for ``stall_steps`` consecutive
    steps. Progress = any admission, emitted token, prefill chunk, or
    completion; a full-but-decoding engine is NOT stalled. Fires once
    per stall episode (re-arms on the next progress)."""

    def __init__(self, stall_steps=32):
        self.stall_steps = int(stall_steps)
        self._streak = 0
        self._fired = False

    def observe(self, row, ledger):
        progress = (row["admitted"] or row["tokens"]
                    or row["prefill_chunks"] or row["completed"])
        if row["queue_depth"] > 0 and not progress:
            self._streak += 1
            if self._streak >= self.stall_steps and not self._fired:
                self._fired = True
                return self._verdict(
                    row,
                    f"{row['queue_depth']} queued request(s) with no "
                    f"admissions/tokens for {self._streak} steps",
                    steps_stalled=self._streak,
                    queue_depth=int(row["queue_depth"]),
                    queue_age_s=round(float(row["queue_age_s"]), 3))
        else:
            self._streak = 0
            self._fired = False
        return None


@register_detector("goodput_collapse")
class GoodputCollapse(Detector):
    """SLO-met tokens/sec cliff between adjacent windows.

    Tracks per-step goodput-token deltas in two adjacent ``window``-
    step windows. Fires when the previous window was HEALTHY (rate >=
    ``healthy_frac`` of the best windowed rate seen, with >=
    ``min_completions`` completions) and the current window collapses
    below ``drop_frac`` of it while work is still pending. The
    healthy-previous-window requirement is the false-positive gate: a
    deliberately overloaded FIFO engine degrades GRADUALLY through
    intermediate windows and never exhibits the healthy->collapsed
    cliff, while a true collapse (device wedged, SLO broken at once)
    does. Inert without SLO targets (no goodput to judge)."""

    def __init__(self, window=64, drop_frac=0.1, healthy_frac=0.5,
                 min_completions=4):
        self.window = int(window)
        self.drop_frac = float(drop_frac)
        self.healthy_frac = float(healthy_frac)
        self.min_completions = int(min_completions)
        self._rows = collections.deque(maxlen=2 * self.window)
        self._peak = 0.0

    @staticmethod
    def _rate(seg):
        wall = sum(w for _, w, _ in seg)
        good = sum(g for g, _, _ in seg)
        done = sum(c for _, _, c in seg)
        return (good / wall if wall > 0 else 0.0), done

    def observe(self, row, ledger):
        if not row.get("slo_on"):
            return None
        self._rows.append((float(row["goodput_tokens"]),
                           float(row["wall_s"]),
                           int(row["completed"])))
        if len(self._rows) < 2 * self.window:
            return None
        rows = list(self._rows)
        prev_rate, prev_done = self._rate(rows[:self.window])
        cur_rate, cur_done = self._rate(rows[self.window:])
        if prev_done >= self.min_completions and prev_rate > 0:
            self._peak = max(self._peak, prev_rate)
        work_pending = row["queue_depth"] > 0 or row["occupied_slots"] > 0
        if (work_pending
                and self._peak > 0
                and prev_done >= self.min_completions
                and cur_done >= self.min_completions
                and prev_rate >= self.healthy_frac * self._peak
                and cur_rate < self.drop_frac * prev_rate):
            self._rows.clear()
            return self._verdict(
                row,
                f"windowed goodput {cur_rate:.1f} tok/s collapsed "
                f"from {prev_rate:.1f} tok/s",
                window_steps=self.window,
                previous_rate_tps=round(prev_rate, 3),
                current_rate_tps=round(cur_rate, 3),
                peak_rate_tps=round(self._peak, 3))
        return None


@register_detector("kv_block_leak")
class KVBlockLeak(Detector):
    """Paged-pool block leak: a failed conservation audit (any step
    the engine ran one), or blocks still holding references while the
    engine is COMPLETELY idle (no queue, no slots, no chunk plans) —
    at idle every block must be free or parked evictable in the radix
    index. Inert on legacy-pool engines (pool fields are None). The
    idle branch fires once per leak episode."""

    def __init__(self):
        self._armed = True

    def observe(self, row, ledger):
        if row.get("conservation_ok") is False:
            return self._verdict(
                row, "paged pool conservation audit failed",
                audit_error=str(row.get("conservation_error")))
        live = row.get("pool_live_blocks")
        if live is None:
            return None
        idle = (row["queue_depth"] == 0 and row["occupied_slots"] == 0
                and row["chunked_inflight"] == 0)
        if idle and live > 0:
            if self._armed:
                self._armed = False
                return self._verdict(
                    row,
                    f"{live} block(s) still referenced with no live "
                    f"requests",
                    live_blocks=int(live),
                    free_blocks=int(row["pool_free_blocks"]),
                    evictable_blocks=int(row["pool_evictable_blocks"]))
        elif idle:
            self._armed = True
        return None


@register_detector("cache_thrash")
class CacheThrash(Detector):
    """Sustained prefix-cache thrash: the radix index keeps evicting
    paths and immediately recomputing them (the radix index's
    evict-then-reinsert counter, surfaced per step as
    the ledger's ``cache_thrash`` delta). A rolling ``window``-step
    sum >= ``min_thrash`` means the pool is materially smaller than
    the live working set — the operator answer is a larger pool.
    Conservative on
    purpose: occasional churn under admission pressure is the block
    economy WORKING; a clean bench run must fire nothing. Fires once
    per episode, re-arming after a thrash-free window. Inert on
    legacy-pool engines (field is None)."""

    def __init__(self, window=64, min_thrash=24):
        self.window = int(window)
        self.min_thrash = int(min_thrash)
        self._hist = collections.deque(maxlen=self.window)
        self._fired = False

    def observe(self, row, ledger):
        thrash = row.get("cache_thrash")
        if thrash is None:
            return None
        self._hist.append(int(thrash))
        total = sum(self._hist)
        if total >= self.min_thrash:
            if not self._fired:
                self._fired = True
                return self._verdict(
                    row,
                    f"{total} evict-then-reinsert event(s) over the "
                    f"last {len(self._hist)} steps — KV pool smaller "
                    f"than the live prefix working set",
                    thrash_events=int(total),
                    window_steps=len(self._hist),
                    evictable_blocks=row.get("pool_evictable_blocks"),
                    free_blocks=row.get("pool_free_blocks"))
        elif total == 0:
            self._fired = False
        return None


@register_detector("steady_state_compile")
class SteadyStateCompileAnomaly(Detector):
    """The compile watchdog's zero-recompile invariant surfaced as an
    anomaly: any executable built after declared warmup fires (per
    step, with the count) — the attribution details live in the
    incident bundle's watchdog section."""

    def observe(self, row, ledger):
        n = int(row.get("steady_compiles") or 0)
        if n > 0:
            return self._verdict(
                row, f"{n} compile(s) after declared warmup",
                compiles=n)
        return None
