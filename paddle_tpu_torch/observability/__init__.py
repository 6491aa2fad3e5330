"""Observability for the port's serving fleet (a port of part of
``paddle_tpu/observability``): the metrics registry and its HTTP
server, the host-span recorder, the compile watchdog's interface,
replica identity, the health observatory and the distributed trace
context. All of it is stdlib Python with no device code; the serving
engine and the router instrument through it.

Quick start::

    from paddle_tpu_torch import observability as obs

    reg = obs.MetricsRegistry()
    reqs = reg.counter("requests_total", "requests served")
    reqs.inc()
    print(reg.prometheus_text())            # scrape format
    server = obs.start_metrics_server(reg)  # GET /metrics, /metrics.json
    server.close()

Not ported yet: the flight recorder, the SLO tracker, the perf, cache
and tenant observatories, the fleet poller and server, and the trace
assembler.
"""
from .fleet import ReplicaIdentity, default_replica_id  # noqa: F401
from .health import (  # noqa: F401
    HealthMonitor, IncidentRecorder, LEDGER_ROW_KEYS, StepLedger,
    build_detectors, detector_names, disabled_health_summary,
    register_detector, unregister_detector,
)
from .registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, MetricsServerHandle,
    Reservoir, WindowedReservoir, DEFAULT_TIME_BUCKETS,
    default_registry, merge_histogram_snapshots,
    percentile_from_buckets, prometheus_text_from_snapshots,
    start_metrics_server,
)
from .tracing import (  # noqa: F401
    FlowEvent, HostSpan, HostSpanRecorder, default_recorder, span_timer,
)
from .watchdog import (  # noqa: F401
    CompileAfterWarmupError, CompileWatchdog, abstract_signature,
)
