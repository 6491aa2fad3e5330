"""Black-box incident capture + the health monitor that drives it (a
copy of ``paddle_tpu/observability/health/incidents.py``).

``IncidentRecorder`` writes one JSON bundle per (debounced) detector
firing — last-K ledger rows, metrics snapshot, active request traces,
host-span tail, watchdog report, the detector's verdict — to a
directory with keep-last-N rotation, so the evidence of WHAT the
engine was doing at the moment of anomaly survives the process.

``HealthMonitor`` is the per-engine orchestrator: the engine feeds it
one ledger row per step; it appends to the ledger, evaluates every
detector, and on each firing (1) increments
``serving_anomalies_total{detector=...}``, (2) emits a
``health/<detector>`` marker span into the host-span recorder (visible
in the chrome trace next to the step it fired on), and (3) captures an
incident bundle when the per-detector debounce allows. ``report()`` is
the ``/debug/health`` body — ``{healthy, detectors, last_incident}``,
the per-replica signal the router polls; ``summary()`` is the lighter ``snapshot()["health"]`` section.
"""
import itertools
import json
import os
import threading
import time

from ..tracing import default_recorder
from .detectors import build_detectors
from .ledger import StepLedger

INCIDENT_SCHEMA = "paddle_tpu.health.incident/v1"

# bundle sections every incident carries. ``chaos`` is the active
# FaultPlan + fault log when the engine runs under the fault-injection
# harness (None otherwise) — a chaos-found incident is replayable from
# the bundle alone. ``replica`` is the writing engine's identity
# (replica_id / uptime) — a bundle collected off one member of a
# fleet stays attributable after the fact. ``traces`` holds the
# assembled distributed traces of the requests in flight at capture
# time, and ``tenants`` the top tenants by token share (the
# noisy-neighbor suspect list).
INCIDENT_KEYS = (
    "schema", "written_at", "detector", "verdict", "ledger_tail",
    "metrics", "watchdog", "requests", "spans_tail", "health",
    "chaos", "replica", "traces", "tenants",
)


def disabled_health_summary():
    """The ``snapshot()["health"]`` section of an engine built with
    health=False — same key set as a live summary, so the schema
    contract holds either way."""
    return {"enabled": False, "healthy": True, "anomalies_total": 0,
            "detectors": {}, "incidents_written": 0,
            "last_incident": None, "ledger_steps": 0,
            "degraded": False, "draining": False, "restarts": 0,
            "replica_id": None, "uptime_s": None}


class IncidentRecorder:
    """Debounced incident-bundle writer with keep-last-N rotation.

    ``debounce_s`` bounds disk churn per detector (the first firing of
    an episode captures; a flapping detector doesn't write a bundle
    per step); ``keep_last`` bounds the DIRECTORY — rotation prunes
    the oldest ``incident_*.json`` regardless of which recorder wrote
    them, so a long-lived fleet's incident dir never grows without
    bound. Capture is best-effort everywhere: a failing context
    callable contributes an error stub, never an exception into the
    serve loop."""

    def __init__(self, directory, keep_last=16, ledger_tail=64,
                 span_tail=120, debounce_s=60.0, clock=time.time):
        if keep_last < 1:
            raise ValueError("keep_last must be >= 1")
        self.directory = str(directory)
        self.keep_last = int(keep_last)
        self.ledger_tail = int(ledger_tail)
        self.span_tail = int(span_tail)
        self.debounce_s = float(debounce_s)
        self._clock = clock
        self._last = {}
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self.written = 0
        self.last_path = None

    def should_capture(self, detector):
        with self._lock:
            last = self._last.get(detector)
        return last is None or (self._clock() - last) >= self.debounce_s

    def _section(self, context, key):
        fn = context.get(key)
        if fn is None:
            return None
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - capture must not raise
            return {"error": f"{type(e).__name__}: {e}"}

    def capture(self, detector, verdict, ledger, context,
                health_report=None):
        """Write one bundle; returns its path. ``context`` maps section
        names (metrics / watchdog / requests / spans_tail) to zero-arg
        callables evaluated NOW — the moment-of-anomaly snapshot."""
        with self._lock:
            self._last[detector] = self._clock()
            seq = next(self._seq)
        bundle = {
            "schema": INCIDENT_SCHEMA,
            "written_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                        time.gmtime()),
            "detector": str(detector),
            "verdict": dict(verdict),
            "ledger_tail": ledger.rows(last=self.ledger_tail)
            if ledger is not None else [],
            "metrics": self._section(context, "metrics"),
            "watchdog": self._section(context, "watchdog"),
            "requests": self._section(context, "requests"),
            "spans_tail": self._section(context, "spans_tail"),
            "health": health_report,
            "chaos": self._section(context, "chaos"),
            "replica": self._section(context, "replica"),
            "traces": self._section(context, "traces"),
            "tenants": self._section(context, "tenants"),
        }
        os.makedirs(self.directory, exist_ok=True)
        stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        fname = f"incident_{stamp}_{seq:03d}_{detector}.json"
        path = os.path.join(self.directory, fname)
        with open(path, "w") as fh:
            json.dump(bundle, fh, indent=1, default=str)
        with self._lock:
            self.written += 1
            self.last_path = path
        self._rotate()
        return path

    def _rotate(self):
        try:
            files = sorted(f for f in os.listdir(self.directory)
                           if f.startswith("incident_")
                           and f.endswith(".json"))
        except OSError:
            return
        for f in files[:-self.keep_last]:
            try:
                os.unlink(os.path.join(self.directory, f))
            except OSError:
                pass

    def list_incidents(self):
        try:
            return sorted(
                os.path.join(self.directory, f)
                for f in os.listdir(self.directory)
                if f.startswith("incident_") and f.endswith(".json"))
        except OSError:
            return []


class HealthMonitor:
    """Per-engine health orchestrator: ledger + detectors + anomaly
    accounting + (optional) incident capture.

    ``registry`` hosts ``serving_anomalies_total{detector}`` and
    ``serving_detector_errors_total{detector}`` (a broken detector is
    counted and skipped, never allowed to take down the serve loop).
    ``context`` maps incident-bundle section names to zero-arg
    callables the engine provides (metrics snapshot, watchdog report,
    request traces, span tail)."""

    def __init__(self, registry, ledger_keep=512, detectors=None,
                 detector_config=None, incidents=None, recorder=None,
                 context=None, clock=time.perf_counter):
        self.ledger = StepLedger(keep=ledger_keep)
        self.detectors = build_detectors(detector_config) \
            if detectors is None else list(detectors)
        self.incidents = incidents
        self._recorder = recorder if recorder is not None \
            else default_recorder()
        self._context = dict(context or {})
        self._clock = clock
        self._c_anomalies = registry.counter(
            "serving_anomalies_total",
            "health-detector firings over the step ledger",
            labelnames=("detector",))
        self._c_errors = registry.counter(
            "serving_detector_errors_total",
            "health detectors that raised while evaluating a step "
            "(the detector is skipped for that step, never fatal)",
            labelnames=("detector",))
        self._state = {}
        self._resolved_total = 0   # anomalies acknowledged-recovered
        self._resilience_fn = None  # engine's degraded/draining state
        self._identity_fn = None    # engine's replica identity
        self._lock = threading.Lock()

    def attach_resilience(self, state_fn):
        """Attach the engine's resilience state (``{"degraded",
        "draining", "restarts"}``) so ``/debug/health`` tells the
        router the replica's TRUE serving posture, not just its
        anomaly history."""
        self._resilience_fn = state_fn

    def attach_identity(self, identity_fn):
        """Attach the engine's replica identity report (``{
        "replica_id", "uptime_s", ...}``) so ``/debug/health`` and
        ``snapshot()["health"]`` name WHICH replica they describe —
        the attribution a fleet poller's merged view depends on."""
        self._identity_fn = identity_fn

    def _identity(self):
        if self._identity_fn is None:
            return {"replica_id": None, "uptime_s": None}
        return self._identity_fn()

    def _resilience(self):
        if self._resilience_fn is None:
            return {"degraded": False, "draining": False, "restarts": 0}
        return self._resilience_fn()

    def resolve(self):
        """Mark every anomaly fired so far RECOVERED (the supervisor
        calls this when its restart's replay set drains): ``healthy``
        goes back to true unless NEW anomalies fire. The cumulative
        firing counters are untouched — resolution is a health-status
        fact, not an eraser."""
        with self._lock:
            self._resolved_total = sum(
                st["fired"] for st in self._state.values())

    # ------------------------------------------------------- stepping
    def observe(self, row):
        """Feed one ledger row; returns the verdicts that fired (often
        empty). Called from the engine's stepping thread."""
        self.ledger.append(row)
        fired = []
        for det in self.detectors:
            try:
                verdict = det.observe(row, self.ledger)
            except Exception:  # noqa: BLE001 - detectors can't be fatal
                self._c_errors.labels(det.name).inc()
                continue
            if verdict:
                self._fire(det.name, verdict)
                fired.append(verdict)
        return fired

    def _fire(self, name, verdict):
        self._c_anomalies.labels(name).inc()
        # marker span at the firing instant: the anomaly is visible in
        # the chrome/Perfetto timeline right next to the step it hit
        args = {k: v for k, v in verdict.items()
                if isinstance(v, (int, float, str, bool))}
        self._recorder.record(f"health/{name}", self._clock(), 0.0,
                              args=args)
        # state FIRST, so the incident bundle's health section already
        # reflects this firing (healthy: false, detector counted)
        with self._lock:
            st = self._state.setdefault(
                name, {"fired": 0, "last_step": None,
                       "last_verdict": None, "last_incident": None})
            st["fired"] += 1
            st["last_step"] = verdict.get("step")
            st["last_verdict"] = dict(verdict)
        if self.incidents is not None \
                and self.incidents.should_capture(name):
            try:
                incident = self.incidents.capture(
                    name, verdict, self.ledger, self._context,
                    health_report=self.summary())
            except Exception:  # noqa: BLE001 - capture is best-effort
                incident = None
            if incident is not None:
                with self._lock:
                    self._state[name]["last_incident"] = incident

    # ------------------------------------------------------- querying
    @property
    def anomalies_total(self):
        with self._lock:
            return sum(st["fired"] for st in self._state.values())

    @property
    def unresolved_total(self):
        """Anomalies fired since the last supervisor-declared
        recovery (= all of them when nothing ever resolved)."""
        with self._lock:
            total = sum(st["fired"] for st in self._state.values())
            return max(0, total - self._resolved_total)

    @property
    def healthy(self):
        """No unresolved anomalies AND not currently degraded — the
        bar a router's readiness poll should use."""
        return self.unresolved_total == 0 \
            and not self._resilience()["degraded"]

    def detector_counts(self):
        """{detector name: firings} for EVERY configured detector
        (zeros included — the detector list is part of the surface)."""
        with self._lock:
            return {d.name: self._state.get(d.name, {}).get("fired", 0)
                    for d in self.detectors}

    def report(self):
        """The ``/debug/health`` JSON body — the per-replica health
        signal a scale-out router polls."""
        with self._lock:
            detectors = {
                d.name: dict(self._state.get(
                    d.name, {"fired": 0, "last_step": None,
                             "last_verdict": None,
                             "last_incident": None}))
                for d in self.detectors}
        total = sum(st["fired"] for st in detectors.values())
        with self._lock:
            resolved = self._resolved_total
        res = self._resilience()
        ident = self._identity()
        unresolved = max(0, total - resolved)
        return {
            "healthy": unresolved == 0 and not res["degraded"],
            # which replica this health body describes (the fleet
            # poller's merged view keys on it)
            "replica_id": ident.get("replica_id"),
            "uptime_s": ident.get("uptime_s"),
            "anomalies_total": total,
            "anomalies_resolved": resolved,
            # the router-facing replica posture: degraded while a
            # supervisor restart's replay is still draining, draining
            # during a graceful engine drain, restarts cumulative
            "degraded": res["degraded"],
            "draining": res["draining"],
            "restarts": res["restarts"],
            "detectors": detectors,
            "last_incident": self.incidents.last_path
            if self.incidents is not None else None,
            "incidents_written": self.incidents.written
            if self.incidents is not None else 0,
            "ledger": {"steps": self.ledger.steps,
                       "kept": len(self.ledger),
                       "last_step": self.ledger.last_step_id},
        }

    def summary(self):
        """The ``snapshot()["health"]`` section (lighter than
        report(): firing counts only, no verdict payloads)."""
        total = self.anomalies_total
        res = self._resilience()
        ident = self._identity()
        return {
            "enabled": True,
            "healthy": self.healthy,
            "replica_id": ident.get("replica_id"),
            "uptime_s": ident.get("uptime_s"),
            "anomalies_total": total,
            "detectors": self.detector_counts(),
            "incidents_written": self.incidents.written
            if self.incidents is not None else 0,
            "last_incident": self.incidents.last_path
            if self.incidents is not None else None,
            "ledger_steps": self.ledger.steps,
            "degraded": res["degraded"],
            "draining": res["draining"],
            "restarts": res["restarts"],
        }

    def debug_ledger(self):
        """The ``/debug/ledger`` JSON body."""
        return self.ledger.as_dict()
