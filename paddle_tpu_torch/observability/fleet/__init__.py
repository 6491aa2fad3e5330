"""Fleet observatory (a port of ``paddle_tpu/observability/fleet``):
replica identity, resilient multi-replica scraping, and federated
fleet-level health/perf/SLO/tenant rollups.

  * **identity** — every engine carries a stable replica id,
    ``serving_uptime_seconds`` and a build-info gauge;
  * **poller.FleetPoller** — scrapes a static replica list (``host:port``
    / JSON registry file) on an interval with per-replica timeout,
    exponential backoff, staleness marking and consecutive-failure
    eviction / readmission verdicts (``up | stale | down``);
  * **rollup** — the pinned-schema ``FleetSnapshot``: per-replica
    posture plus fleet aggregates that merge exactly (counters sum,
    fixed-bucket histograms merge bucket-wise), judged by
    ``scope="fleet"`` detectors (``replica_flap`` /
    ``fleet_goodput_collapse`` / ``load_skew`` / ``noisy_neighbor`` /
    ``tenant_starvation``);
  * **server.FleetServer** — ``/fleet/health``, ``/fleet/state``,
    ``/fleet/metrics`` and ``/fleet/tenants``.

The wire is the reference's: this poller reads the reference's
replicas and the reference's poller reads the port's.
"""
from . import detectors as _fleet_detectors  # noqa: F401 - registers
from .identity import ReplicaIdentity, backoff_jitter_unit, default_replica_id
from .poller import FLEET_ROW_KEYS, FLEET_TENANT_ROW_KEYS, FleetPoller, ReplicaState
from .rollup import (FLEET_AGG_KEYS, FLEET_REPLICA_KEYS, FLEET_SCHEMA,
                     FLEET_SNAPSHOT_KEYS, FLEET_TENANT_ENTRY_KEYS,
                     fleet_aggregate, fleet_cache, fleet_tenants,
                     merged_latency, replica_entry)
from .server import FleetServer

__all__ = [
    "ReplicaIdentity", "backoff_jitter_unit", "default_replica_id",
    "FLEET_ROW_KEYS", "FLEET_TENANT_ROW_KEYS", "FleetPoller",
    "ReplicaState", "FLEET_AGG_KEYS", "FLEET_REPLICA_KEYS", "FLEET_SCHEMA",
    "FLEET_SNAPSHOT_KEYS", "FLEET_TENANT_ENTRY_KEYS", "fleet_aggregate",
    "fleet_cache", "fleet_tenants", "merged_latency", "replica_entry",
    "FleetServer",
]
