"""Resilient multi-replica scrape poller (a copy of
``paddle_tpu/observability/fleet/poller.py``; it reads either
package's replicas).

``FleetPoller`` turns N per-replica debug surfaces (``/metrics.json``
+ ``/debug/health`` + ``/debug/state``, the endpoints every
``ServingEngine.serve_metrics()`` already exposes) into ONE fleet
view, with the failure discipline a fleet layer must have because
replicas die mid-scrape as a matter of course:

  * **per-replica timeout** — one wedged replica delays its own
    scrape, never the cycle (replicas scrape in parallel threads);
  * **exponential backoff with deterministic jitter** — a failing
    replica is re-probed at ``backoff_base_s * 2^(failures-1)``
    stretched by up to ``backoff_jitter`` (capped), so a dead host
    doesn't eat a timeout per cycle forever. The jitter fraction is
    a pure function of ``(jitter_seed, replica, failure count)`` —
    no global ``random`` state — so N pollers watching a bounced
    fleet de-synchronize their re-probes (different seeds spread
    out) while any single poller stays exactly reproducible;
  * **staleness marking** — every replica carries ``last_seen``; an
    ``up`` replica not successfully scraped within ``stale_after_s``
    is marked ``stale`` (distrust the numbers, don't evict yet);
  * **eviction / readmission verdicts** — ``down_after`` consecutive
    scrape failures evict (verdict ``down``); the next successful
    scrape readmits (``up``): the health-poll-driven replica lifecycle
    a router consumes rather than reimplements.

Every completed poll cycle appends one fleet row (``FLEET_ROW_KEYS``)
to a bounded ledger and runs the ``scope="fleet"`` detectors over it
(``replica_flap`` / ``fleet_goodput_collapse`` / ``load_skew`` /
``noisy_neighbor`` / ``tenant_starvation`` — the ``register_detector``
framework, fleet scope). Firings count in
``fleet_anomalies_total{detector}`` on the poller's own registry and
drop ``fleet/<detector>`` marker spans into the host timeline.

Targets are a static replica list — ``host:port`` strings, dicts
``{"id": ..., "url": ...}`` — or a JSON registry file via
:meth:`FleetPoller.from_registry`. Scrape transport is injectable
(``fetch=``) so tests drive the whole lifecycle without sockets.
"""
import json
import threading
import time
import urllib.request

from ..health.detectors import build_detectors
from ..health.ledger import StepLedger
from ..registry import MetricsRegistry, prometheus_text_from_snapshots
from ..tracing import default_recorder
from . import rollup
from .identity import backoff_jitter_unit

__all__ = ["FleetPoller", "ReplicaState", "FLEET_ROW_KEYS",
           "FLEET_TENANT_ROW_KEYS"]

# the per-poll fleet row the fleet detectors evaluate (``step`` is the
# poll sequence number, so the shared Detector/ledger machinery from
# the engine observatory applies unchanged)
FLEET_ROW_KEYS = (
    "step",           # poll cycle number (1-based, monotone)
    "t",              # wall-clock epoch seconds at cycle end
    "dt_s",           # seconds since the previous cycle
    "size", "up", "stale", "down",
    "transitions",    # [{replica, from, to}] verdict changes this cycle
    "queue_depths",   # {replica_id: queued} over non-down replicas
    "queue_depth",    # their sum
    "goodput_total",  # fleet cumulative SLO-met tokens (last known)
    "goodput_delta",  # of those, new since the previous cycle
    "work_pending",   # any replica reports queued work or occupancy
    "tenants",        # {tenant: per-cycle fairness facts} (see below)
)

# per-tenant per-cycle facts inside row["tenants"]: cumulative fleet
# sums of the tenant-labelled counters differenced between cycles
# (the noisy_neighbor / tenant_starvation detectors' evidence), plus
# the live queue depth from the replicas' /debug/state tenant sections
FLEET_TENANT_ROW_KEYS = (
    "tokens_delta", "requests_delta", "completed_delta",
    "attained_delta", "violated_delta", "queued",
)

_TENANT_ROW_COUNTERS = (
    ("tokens_delta", "serving_tenant_tokens_out_total"),
    ("requests_delta", "serving_tenant_requests_total"),
    ("completed_delta", "serving_tenant_completed_total"),
    ("attained_delta", "serving_tenant_slo_attained_total"),
    ("violated_delta", "serving_tenant_slo_violations_total"),
)


def _default_fetch(url, timeout):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _normalize_url(target):
    t = str(target)
    if not t.startswith("http://") and not t.startswith("https://"):
        t = "http://" + t
    return t.rstrip("/")


class ReplicaState:
    """One replica's availability bookkeeping + last-known scrape
    bodies. ``verdict`` reads ``down`` until the first verdict is
    established; internal transitions FROM the never-polled state are
    not reported (a fresh poller starting against a live fleet is not
    a flap)."""

    def __init__(self, replica_id, url):
        self.configured_id = replica_id
        self.replica_id = replica_id or url.split("//", 1)[-1]
        self.url = url
        self._verdict = None          # None until first established
        self.last_seen = None         # poller-clock time of last success
        self.consecutive_failures = 0
        self.polls = 0
        self.failures = 0
        self.evictions = 0
        self.readmissions = 0
        self.backoff_until = 0.0
        self.scrape_s = None
        self.last_error = None
        self.metrics = None           # last-known /metrics.json body
        self.health = None            # last-known /debug/health body
        self.state = None             # last-known /debug/state body
        self.step_rate = None
        self._prev_steps = None
        self._prev_steps_t = None

    @property
    def verdict(self):
        return self._verdict if self._verdict is not None else "down"

    def set_verdict(self, verdict):
        """Returns the transition record when the verdict CHANGED
        between established states, else None."""
        old = self._verdict
        self._verdict = verdict
        if old is None or old == verdict:
            return None
        return {"replica": self.replica_id, "from": old, "to": verdict}


class FleetPoller:
    """Poll a static replica list; aggregate availability, posture and
    metrics into the ``FleetSnapshot``. ``start()`` runs the cycle on
    a daemon thread every ``interval_s``; ``poll_once()`` drives it
    synchronously (tests, one-shot CLIs)."""

    def __init__(self, targets, interval_s=2.0, timeout_s=1.0,
                 stale_after_s=None, down_after=3, backoff_base_s=None,
                 backoff_max_s=None, backoff_jitter=0.25,
                 jitter_seed=0, ledger_keep=512, registry=None,
                 detector_config=None, fetch=None,
                 clock=time.monotonic):
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.stale_after_s = float(stale_after_s) \
            if stale_after_s is not None else 3.0 * self.interval_s
        self.down_after = int(down_after)
        if self.down_after < 1:
            raise ValueError("down_after must be >= 1")
        self.backoff_base_s = float(backoff_base_s) \
            if backoff_base_s is not None else self.interval_s
        self.backoff_max_s = float(backoff_max_s) \
            if backoff_max_s is not None else 8.0 * self.interval_s
        self.backoff_jitter = float(backoff_jitter)
        if not 0.0 <= self.backoff_jitter <= 1.0:
            raise ValueError(
                f"backoff_jitter must be in [0, 1], "
                f"got {backoff_jitter}")
        self.jitter_seed = jitter_seed
        self._clock = clock
        self._fetch = fetch if fetch is not None else _default_fetch
        self.replicas = []
        seen = set()
        for rid, url in self.parse_targets(targets):
            if url in seen:
                continue
            seen.add(url)
            self.replicas.append(ReplicaState(rid, url))
        if not self.replicas:
            raise ValueError("FleetPoller needs at least one target")
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._c_scrapes = self.registry.counter(
            "fleet_scrapes_total", "scrape attempts by outcome",
            labelnames=("outcome",))
        self._c_anomalies = self.registry.counter(
            "fleet_anomalies_total",
            "fleet-detector firings over the poll ledger",
            labelnames=("detector",))
        self._c_detector_errors = self.registry.counter(
            "fleet_detector_errors_total",
            "fleet detectors that raised while evaluating a poll "
            "(skipped for that cycle, never fatal)",
            labelnames=("detector",))
        self._g_replicas = self.registry.gauge(
            "fleet_replicas", "replica count by availability verdict",
            labelnames=("verdict",))
        self.detectors = build_detectors(detector_config, scope="fleet")
        self.ledger = StepLedger(keep=ledger_keep)
        self._recorder = default_recorder()
        self._detector_state = {}
        self._lock = threading.RLock()
        self._polls = 0
        self._last_poll_t = None
        self._prev_goodput = None
        self._prev_tenants = None   # tenant -> cumulative fleet sums
        self._stop = threading.Event()
        self._thread = None

    # ----------------------------------------------------- targets
    @staticmethod
    def parse_targets(targets):
        """[(replica_id_or_None, base_url)] from ``host:port`` / URL
        strings or ``{"id": ..., "url"|"target": ...}`` dicts."""
        out = []
        for t in targets:
            if isinstance(t, dict):
                url = t.get("url") or t.get("target")
                if not url:
                    raise ValueError(f"registry entry without url: {t}")
                out.append((t.get("id") or t.get("replica_id"),
                            _normalize_url(url)))
            else:
                out.append((None, _normalize_url(t)))
        return out

    @classmethod
    def from_registry(cls, path, **kw):
        """Build a poller from a JSON registry file: either a plain
        list of targets or ``{"replicas": [...]}`` with ``host:port``
        strings / ``{"id", "url"}`` entries."""
        with open(path) as fh:
            doc = json.load(fh)
        targets = doc.get("replicas", doc) if isinstance(doc, dict) \
            else doc
        return cls(targets, **kw)

    # ----------------------------------------------------- scraping
    def _scrape(self, st):
        """One replica's three-endpoint scrape. ``/metrics.json`` is
        the availability probe — its failure fails the scrape;
        ``/debug/health`` and ``/debug/state`` are best-effort (an
        engine mid-close may answer some routes and not others — the
        replica entry just carries None for the missing posture)."""
        t0 = time.perf_counter()
        metrics = self._fetch(st.url + "/metrics.json", self.timeout_s)
        if not isinstance(metrics, dict):
            raise ValueError("non-object /metrics.json body")
        health = state = None
        try:
            health = self._fetch(st.url + "/debug/health",
                                 self.timeout_s)
        except Exception:  # noqa: BLE001 - best-effort posture
            pass
        try:
            state = self._fetch(st.url + "/debug/state", self.timeout_s)
        except Exception:  # noqa: BLE001 - best-effort posture
            pass
        return {"metrics": metrics, "health": health, "state": state,
                "scrape_s": time.perf_counter() - t0}

    def _apply_success(self, st, result, now):
        st.polls += 1
        st.consecutive_failures = 0
        st.last_seen = now
        st.scrape_s = result["scrape_s"]
        st.last_error = None
        st.metrics = result["metrics"]
        if result["health"] is not None:
            st.health = result["health"]
        if result["state"] is not None:
            st.state = result["state"]
        # learn the replica's self-reported identity (configured ids
        # win only until the replica says who it actually is)
        reported = ((st.state or {}).get("replica") or {}) \
            .get("replica_id") \
            or rollup.build_info_labels(st.metrics).get("replica")
        if reported:
            st.replica_id = str(reported)
        # step rate between the last two successful scrapes
        steps = ((st.health or {}).get("ledger") or {}).get("steps")
        if steps is not None and st._prev_steps is not None \
                and now > st._prev_steps_t:
            st.step_rate = max(0.0, (steps - st._prev_steps)
                               / (now - st._prev_steps_t))
        if steps is not None:
            st._prev_steps = steps
            st._prev_steps_t = now
        self._c_scrapes.labels("ok").inc()
        tr = st.set_verdict("up")
        if tr is not None and tr["from"] == "down":
            st.readmissions += 1
        return tr

    def _apply_failure(self, st, exc, now):
        st.polls += 1
        st.failures += 1
        st.consecutive_failures += 1
        st.last_error = f"{type(exc).__name__}: {exc}"[:160]
        # exponential backoff stretched by deterministic seeded jitter
        # (a pure function of seed/replica/failure-count — N pollers
        # watching the same bounced fleet re-probe spread out instead
        # of in lockstep, yet each poller is exactly reproducible)
        stretch = 1.0 + self.backoff_jitter * backoff_jitter_unit(
            self.jitter_seed, st.replica_id or st.url,
            st.consecutive_failures)
        backoff = min(self.backoff_max_s,
                      self.backoff_base_s
                      * (2 ** (st.consecutive_failures - 1))
                      * stretch)
        st.backoff_until = now + backoff
        self._c_scrapes.labels("error").inc()
        if st.consecutive_failures >= self.down_after:
            tr = st.set_verdict("down")
            if tr is not None:
                st.evictions += 1
            return tr
        return None

    def poll_once(self):
        """One full poll cycle: scrape every non-backed-off replica in
        parallel, apply verdicts, append the fleet row, run the fleet
        detectors. Returns the verdicts that fired (often empty)."""
        now = self._clock()
        with self._lock:
            due = [st for st in self.replicas
                   if now >= st.backoff_until]
        results = {}

        def scrape(st):
            try:
                results[st.url] = ("ok", self._scrape(st))
            except Exception as e:  # noqa: BLE001 - per-replica fate
                results[st.url] = ("error", e)

        threads = [threading.Thread(target=scrape, args=(st,),
                                    daemon=True,
                                    name=f"fleet-scrape-{st.replica_id}")
                   for st in due]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.timeout_s * 4 + 1.0)
        now = self._clock()
        transitions = []
        with self._lock:
            for st in due:
                outcome = results.get(st.url)
                if outcome is None:      # scrape thread still wedged
                    outcome = ("error",
                               TimeoutError("scrape thread wedged"))
                kind, payload = outcome
                tr = self._apply_success(st, payload, now) \
                    if kind == "ok" \
                    else self._apply_failure(st, payload, now)
                if tr is not None:
                    transitions.append(tr)
            # staleness pass over EVERY replica (backed-off included):
            # an up replica we haven't successfully scraped within the
            # window is stale — numbers distrusted, not yet evicted
            for st in self.replicas:
                if st.verdict == "up" and st.last_seen is not None \
                        and now - st.last_seen > self.stale_after_s:
                    tr = st.set_verdict("stale")
                    if tr is not None:
                        transitions.append(tr)
            self._polls += 1
            dt = (now - self._last_poll_t) \
                if self._last_poll_t is not None else self.interval_s
            self._last_poll_t = now
            row = self._fleet_row(now, dt, transitions)
            for verdict in ("up", "stale", "down"):
                self._g_replicas.labels(verdict).set(row[verdict])
        fired = self._observe(row)
        return fired

    def _fleet_row(self, now, dt, transitions):
        verdicts = [st.verdict for st in self.replicas]
        depths = {}
        work_pending = False
        goodput = 0.0
        for st in self.replicas:
            if st.metrics is not None:
                goodput += rollup.counter_value(
                    st.metrics, "serving_goodput_tokens_total") or 0.0
            if st.verdict == "down" or st.state is None:
                continue
            q = st.state.get("queue_depth")
            if q is not None:
                depths[st.replica_id] = int(q)
            occ = st.state.get("slot_occupancy") or 0
            if (q or 0) > 0 or occ > 0:
                work_pending = True
        prev_good = self._prev_goodput
        self._prev_goodput = goodput
        # per-tenant fleet sums this cycle (cumulative, last-known):
        # differenced against the previous cycle's sums into the
        # fairness deltas the tenant detectors judge. A replica that
        # died keeps contributing its last-known totals, so deltas
        # never go negative on eviction.
        cum = {}
        queued = {}
        for st in self.replicas:
            if st.metrics is not None:
                for key, family in _TENANT_ROW_COUNTERS:
                    fam = st.metrics.get(family)
                    for labels, v in ((fam or {}).get("values")
                                      or {}).items():
                        if not labels.startswith("tenant=") \
                                or not isinstance(v, (int, float)):
                            continue
                        t = labels[len("tenant="):]
                        cell = cum.setdefault(
                            t, dict.fromkeys(
                                (k for k, _ in _TENANT_ROW_COUNTERS),
                                0.0))
                        cell[key] += v
            if st.verdict != "down" and st.state is not None:
                sec = st.state.get("tenants") or {}
                for t, entry in (sec.get("tenants") or {}).items():
                    queued[t] = queued.get(t, 0) \
                        + (entry.get("queued") or 0)
        prev_ten = self._prev_tenants
        self._prev_tenants = cum
        tenants = {}
        for t in sorted(set(cum) | set(queued)):
            cell = cum.get(t) or {}
            prev = (prev_ten or {}).get(t) or {}
            fact = {key: max(0.0, (cell.get(key) or 0.0)
                             - (prev.get(key) or 0.0))
                    if prev_ten is not None else 0.0
                    for key, _ in _TENANT_ROW_COUNTERS}
            fact["queued"] = int(queued.get(t, 0))
            tenants[t] = fact
        return {
            "step": self._polls,
            "t": time.time(),
            "dt_s": round(dt, 6),
            "size": len(self.replicas),
            "up": sum(v == "up" for v in verdicts),
            "stale": sum(v == "stale" for v in verdicts),
            "down": sum(v == "down" for v in verdicts),
            "transitions": transitions,
            "queue_depths": depths,
            "queue_depth": sum(depths.values()),
            "goodput_total": goodput,
            "goodput_delta": goodput - prev_good
            if prev_good is not None else 0.0,
            "work_pending": work_pending,
            "tenants": tenants,
        }

    def _observe(self, row):
        """Ledger + detectors + anomaly accounting (the fleet-scope
        mirror of HealthMonitor.observe)."""
        self.ledger.append(row)
        fired = []
        for det in self.detectors:
            try:
                verdict = det.observe(row, self.ledger)
            except Exception:  # noqa: BLE001 - detectors can't be fatal
                self._c_detector_errors.labels(det.name).inc()
                continue
            if verdict:
                self._c_anomalies.labels(det.name).inc()
                args = {k: v for k, v in verdict.items()
                        if isinstance(v, (int, float, str, bool))}
                self._recorder.record(f"fleet/{det.name}",
                                      self._clock(), 0.0, args=args)
                with self._lock:
                    st = self._detector_state.setdefault(
                        det.name, {"fired": 0, "last_verdict": None})
                    st["fired"] += 1
                    st["last_verdict"] = dict(verdict)
                fired.append(verdict)
        return fired

    # ----------------------------------------------------- lifecycle
    def start(self):
        """Run the poll cycle on a daemon thread every ``interval_s``
        until :meth:`stop`. Idempotent."""
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="fleet-poller")
            self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            t0 = self._clock()
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - the loop must survive
                pass
            elapsed = self._clock() - t0
            self._stop.wait(max(0.0, self.interval_s - elapsed))

    def stop(self):
        """Stop the background cycle (idempotent); poll state is kept."""
        self._stop.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=self.timeout_s * 4 + 5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # ----------------------------------------------------- reporting
    def detector_counts(self):
        with self._lock:
            return {d.name: self._detector_state.get(
                d.name, {}).get("fired", 0) for d in self.detectors}

    def _health_block(self):
        counts = self.detector_counts()
        with self._lock:
            last = {n: dict(st["last_verdict"])
                    for n, st in self._detector_state.items()
                    if st.get("last_verdict")}
        return {
            "anomalies_total": sum(counts.values()),
            "detectors": counts,
            "last_verdicts": last,
        }

    def snapshot(self):
        """The pinned-schema ``FleetSnapshot`` (``/fleet/state``)."""
        now = self._clock()
        with self._lock:
            entries = [rollup.replica_entry(st, now)
                       for st in self.replicas]
            snapshots = [st.metrics for st in self.replicas
                         if st.metrics is not None]
            states = [st.state for st in self.replicas
                      if st.state is not None]
            polls = self._polls
        replicas = {}
        for e in entries:
            key = e["replica_id"]
            while key in replicas:       # colliding ids stay visible
                key += "+"
            replicas[key] = e
        return {
            "schema": rollup.FLEET_SCHEMA,
            "t": time.time(),
            "polls": polls,
            "interval_s": self.interval_s,
            "replicas": replicas,
            "fleet": rollup.fleet_aggregate(entries, snapshots,
                                            states),
            "health": self._health_block(),
        }

    def fleet_tenants(self):
        """The ``/fleet/tenants`` body: the federated per-tenant
        rollup (exact counter sums across replicas) plus the tenant
        detectors' firing state — the one-page noisy-neighbor view."""
        with self._lock:
            snapshots = [st.metrics for st in self.replicas
                         if st.metrics is not None]
            states = [st.state for st in self.replicas
                      if st.state is not None]
            polls = self._polls
        counts = self.detector_counts()
        with self._lock:
            last = {n: dict(st["last_verdict"])
                    for n, st in self._detector_state.items()
                    if st.get("last_verdict")
                    and n in ("noisy_neighbor", "tenant_starvation")}
        return {
            "polls": polls,
            "fleet": rollup.fleet_tenants(snapshots, states),
            "detectors": {n: counts.get(n, 0)
                          for n in ("noisy_neighbor",
                                    "tenant_starvation")
                          if n in counts},
            "last_verdicts": last,
        }

    def fleet_health(self):
        """The ``/fleet/health`` body — the router's one-poll answer:
        fleet-level healthy verdict, the availability census, each
        replica's posture, and the fleet-detector rollup."""
        snap = self.snapshot()
        fleet = snap["fleet"]
        return {
            "healthy": fleet["healthy"],
            "size": fleet["size"],
            "up": fleet["up"],
            "stale": fleet["stale"],
            "down": fleet["down"],
            "replicas": {
                rid: {k: e[k] for k in
                      ("verdict", "healthy", "degraded", "draining",
                       "restarts", "age_s")}
                for rid, e in snap["replicas"].items()},
            "anomalies_total": snap["health"]["anomalies_total"],
            "detectors": snap["health"]["detectors"],
            "polls": snap["polls"],
        }

    def prometheus_text(self):
        """The ``/fleet/metrics`` body: every non-down replica's
        last-known snapshot re-exposed as ONE Prometheus text
        exposition with a ``replica`` label stamped on every series —
        scrape-merge-time labeling, Prometheus-federation style."""
        with self._lock:
            labeled = [(st.replica_id, st.metrics)
                       for st in self.replicas
                       if st.verdict != "down"
                       and st.metrics is not None]
        return prometheus_text_from_snapshots(labeled)
