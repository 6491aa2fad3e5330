"""Replica identity and the deterministic backoff jitter (a part of
``paddle_tpu/observability/fleet``; the fleet poller, rollup, detectors
and server are not ported)."""
from .identity import ReplicaIdentity, backoff_jitter_unit, default_replica_id

__all__ = ["ReplicaIdentity", "backoff_jitter_unit", "default_replica_id"]
