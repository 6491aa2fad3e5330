"""Observability for the port's serving fleet (a port of part of
``paddle_tpu/observability``): the metrics registry and its HTTP
server, the host-span recorder, the compile watchdog's interface,
replica identity, the health observatory, the distributed trace context
and assembler, the request flight recorder, the SLO tracker, the perf,
cache and tenant observatories, and the fleet poller, rollup and server.
All of it is stdlib Python with no device code; the serving engine and
the router instrument through it.

Quick start::

    from paddle_tpu_torch import observability as obs

    reg = obs.MetricsRegistry()
    reqs = reg.counter("requests_total", "requests served")
    reqs.inc()
    print(reg.prometheus_text())            # scrape format
    server = obs.start_metrics_server(reg)  # GET /metrics, /metrics.json
    server.close()
"""
from .cache import (  # noqa: F401
    CACHE_KEYS, CacheObservatory, ReuseDistanceSampler,
    disabled_cache_report, exact_mrc, merge_heat_digests,
    merge_mrc_points, top_prefix_digest,
)
from .fleet import (  # noqa: F401
    FleetPoller, FleetServer, ReplicaIdentity, default_replica_id,
)
from .flight import FlightRecorder, RequestTrace  # noqa: F401
from .health import (  # noqa: F401
    HealthMonitor, IncidentRecorder, LEDGER_ROW_KEYS, StepLedger,
    build_detectors, detector_names, disabled_health_summary,
    register_detector, unregister_detector,
)
from .perf import (  # noqa: F401
    PERF_KEYS, PERF_PROGRAM_KEYS, PERF_SPEC_KEYS, ProgramPerf,
    disabled_perf_report, disabled_spec_report, format_program_key,
    hbm_bps_for, peak_flops_for,
)
from .registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, MetricsServerHandle,
    Reservoir, WindowedReservoir, DEFAULT_TIME_BUCKETS,
    default_registry, merge_histogram_snapshots,
    percentile_from_buckets, prometheus_text_from_snapshots,
    start_metrics_server,
)
from .slo import SLOTracker  # noqa: F401
from .tenant import (  # noqa: F401
    TENANT_ENTRY_KEYS, TENANT_KEYS, TenantLedger, disabled_tenant_report,
)
from .tracing import (  # noqa: F401
    FlowEvent, HostSpan, HostSpanRecorder, default_recorder, span_timer,
)
from .watchdog import (  # noqa: F401
    CompileAfterWarmupError, CompileWatchdog, abstract_signature,
    device_memory_stats,
)
