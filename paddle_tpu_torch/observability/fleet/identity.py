"""Replica identity: who IS this engine, in a fleet of lookalikes (a
copy of ``paddle_tpu/observability/fleet/identity.py``, plus the
poller's ``backoff_jitter_unit``).

Every serving replica needs a stable, human-readable identity: results
must be attributable to one process (two replicas on one host differ
only by pid), incident bundles must name which member wrote them, and a
router's state must say which replica it placed a request on. The
identity is

  * configured — ``ServingConfig(replica_id=...)``, else
  * derived — ``<hostname>:<pid>`` (:func:`default_replica_id`):
    stable for the process lifetime, unique across a host's replicas,
    and meaningful in logs without a lookup table.

The engine stamps it into ``snapshot()["replica"]``, ``/debug/state``,
``/debug/health`` and incident bundles, and exposes
``serving_uptime_seconds`` (uptime going BACKWARDS between scrapes
means the process bounced) and a ``paddle_tpu_torch_build_info{replica,
version, torch_version}`` info gauge (value 1).
"""
import random
import os
import socket
import time

__all__ = ["default_replica_id", "ReplicaIdentity",
           "backoff_jitter_unit"]


def default_replica_id():
    """A stable host:pid-derived replica id — unique per process on a
    host, stable for the process lifetime, readable in a log line."""
    try:
        host = socket.gethostname() or "localhost"
    except OSError:
        host = "localhost"
    return f"{host.split('.')[0]}:{os.getpid()}"


class ReplicaIdentity:
    """One replica's identity + uptime clock, shared by every surface
    that stamps it (snapshot / debug routes / incident bundles)."""

    def __init__(self, replica_id=None, clock=time.perf_counter):
        self.replica_id = str(replica_id) if replica_id \
            else default_replica_id()
        self._clock = clock
        self._t0 = clock()
        self.started_at = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                        time.gmtime())

    def uptime_s(self):
        return self._clock() - self._t0

    def report(self):
        """The ``snapshot()["replica"]`` / ``/debug/state["replica"]``
        body."""
        return {
            "replica_id": self.replica_id,
            "uptime_s": round(self.uptime_s(), 3),
            "started_at": self.started_at,
        }


def backoff_jitter_unit(seed, who, attempt):
    """Deterministic unit-interval jitter fraction for backoff
    spreading: a pure function of ``(seed, who, attempt)`` via a local
    ``random.Random`` stream — the global ``random`` state is never
    touched, so jittered backoff is exactly reproducible per seed and
    de-correlated across seeds. The router's retry backoff uses it."""
    return random.Random(f"{seed}:{who}:{attempt}").random()
