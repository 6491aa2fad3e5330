"""The fleet federation HTTP surface (a copy of
``paddle_tpu/observability/fleet/server.py``).

``FleetServer`` wraps a :class:`~.poller.FleetPoller` with the same
stdlib HTTP machinery every engine already uses
(``registry.start_metrics_server``) and mounts the routes a router
consumes:

  * ``/fleet/health`` — fleet-level healthy verdict + availability
    census + per-replica posture + fleet-detector rollup;
  * ``/fleet/state``  — the full pinned-schema ``FleetSnapshot``
    (per-replica entries, exact counter sums, bucket-wise merged
    latency percentiles);
  * ``/fleet/metrics`` — every non-down replica's metrics re-exposed
    as one Prometheus text exposition with a ``replica`` label on
    every series (scrape-merge-time labeling);
  * ``/fleet/tenants`` — the federated per-tenant attribution rollup
    plus the noisy_neighbor / tenant_starvation detector state.

``/metrics`` + ``/metrics.json`` serve the poller's OWN registry
(scrape outcomes, availability gauges, ``fleet_anomalies_total``) —
the observatory observes itself, same as every layer below it.
"""
from ..registry import start_metrics_server
from .poller import FleetPoller

__all__ = ["FleetServer"]


class FleetServer:
    """Own a poller + serve the fleet surface. ``poller`` may be a
    ready FleetPoller or a target list (poller kwargs pass through).
    ``serve()`` starts the poll loop and the HTTP server; ``close()``
    stops both (idempotent; also a context manager)."""

    def __init__(self, poller, **poller_kw):
        if not isinstance(poller, FleetPoller):
            poller = FleetPoller(poller, **poller_kw)
        elif poller_kw:
            raise TypeError("pass a FleetPoller OR targets + kwargs, "
                            "not both")
        self.poller = poller
        self.handle = None
        self._closed = False

    def routes(self):
        return {
            "/fleet/health": self.poller.fleet_health,
            "/fleet/state": self.poller.snapshot,
            "/fleet/metrics": self.poller.prometheus_text,
            "/fleet/tenants": self.poller.fleet_tenants,
        }

    def serve(self, port=0, addr="127.0.0.1", poll=True):
        """Start the HTTP surface (and, with ``poll=True``, the
        background poll loop). Returns the MetricsServerHandle —
        ``handle.port`` is the bound port."""
        if self.handle is not None:
            return self.handle
        if poll:
            self.poller.start()
        self.handle = start_metrics_server(
            self.poller.registry, port=port, addr=addr,
            extra_routes=self.routes())
        return self.handle

    @property
    def port(self):
        return self.handle.port if self.handle is not None else None

    def close(self):
        if self._closed:
            return
        self._closed = True
        self.poller.stop()
        if self.handle is not None:
            self.handle.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
