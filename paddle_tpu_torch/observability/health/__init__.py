"""Serving health observatory: per-step ledger, online anomaly
detectors, black-box incident capture (a port of
``paddle_tpu/observability/health``).

  * **ledger.StepLedger** — a bounded ring of per-step structured
    rows appended by the engine (wall seconds, queue and slot state,
    token/shed deltas, paged-pool block economy); ``/debug/ledger``
    serves it, incident bundles snapshot it;
  * **detectors** — a pluggable ``register_detector`` framework
    evaluated every step: step-time spike (rolling-median MAD), queue
    stall, goodput collapse, KV-block leak, cache thrash, steady-state
    compile; each firing increments
    ``serving_anomalies_total{detector}`` and drops a
    ``health/<detector>`` marker span into the host timeline;
  * **incidents.IncidentRecorder / HealthMonitor** — on (debounced)
    firing, a JSON incident bundle lands on disk with keep-last-N
    rotation, and ``/debug/health`` returns ``{healthy, detectors,
    last_incident}`` — the per-replica signal the router polls.

Engine wiring: ``ServingConfig(health=True)`` (default),
``health_audit_every=`` for the periodic paged-pool conservation audit,
``incident_dir=`` to enable bundle capture, ``health_detectors=`` for
per-detector threshold overrides.
"""
from .detectors import (  # noqa: F401
    Detector, GoodputCollapse, KVBlockLeak, QueueStall,
    SteadyStateCompileAnomaly, StepTimeSpike, build_detectors,
    detector_names, register_detector, unregister_detector,
)
from .incidents import (  # noqa: F401
    INCIDENT_KEYS, INCIDENT_SCHEMA, HealthMonitor, IncidentRecorder,
    disabled_health_summary,
)
from .ledger import LEDGER_ROW_KEYS, StepLedger  # noqa: F401
