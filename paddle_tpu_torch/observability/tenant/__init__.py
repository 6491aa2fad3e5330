"""Tenant observatory: per-tenant attribution for the serving stack (a
copy of ``paddle_tpu/observability/tenant``).

One :class:`TenantLedger` per
engine accrues, per tenant id: tokens in/out, goodput tokens, SLO
attainment/violations per dimension, queue-wait + TTFT reservoirs,
shed/timeout/abort counts, and cache-savings attribution — hooked at
the SAME ServingMetrics call sites as the global counters, so the
per-tenant sums equal the global counters exactly (a conservation
property tests assert bit-exactly).

Cardinality is bounded by construction: at most ``max_tenants`` live
tenant ids; any further unique id folds into ``"~other"`` with an
overflow counter — a 10k-unique-tenant flood costs O(max_tenants)
memory and one aggregate series, never a registry blowup (the generic
registry-level guard in ``observability.registry`` backstops every
other labelled family the same way).

The tenant id itself rides the trace-context baggage end-to-end
(``POST /v1/generate`` body -> router admission baggage -> both
disaggregation hops -> KV handoff payload -> failover journal), so
attribution survives replica death and two-tier serving without any
wire-format change. Fleet-side, ``observability.fleet`` federates the
per-tenant series (counters sum, never mean-of-rates) and judges
fairness with the ``noisy_neighbor`` / ``tenant_starvation`` fleet
detectors.
"""
from .ledger import (  # noqa: F401
    DEFAULT_TENANT, OVERFLOW_TENANT, TENANT_ENTRY_KEYS, TENANT_KEYS,
    TenantLedger, disabled_tenant_report,
)

__all__ = [
    "DEFAULT_TENANT", "OVERFLOW_TENANT", "TENANT_ENTRY_KEYS",
    "TENANT_KEYS", "TenantLedger", "disabled_tenant_report",
]
