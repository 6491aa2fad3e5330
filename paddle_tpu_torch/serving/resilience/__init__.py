"""Chaos-hardened serving: deterministic fault injection, the
hardening it forces, and a self-healing supervisor (a port of
``paddle_tpu/serving/resilience``).

  * **fault injection** (chaos) — ``FaultPlan`` / ``FaultInjector``:
    seeded, deterministic failures at the engine's real seams
    (dispatches, transfers, pool exhaustion, poisoned callbacks), each
    fire counted, marker-spanned and fault-logged so a chaos run
    replays from its seed. Armed via ``ServingConfig(chaos=...)``; off
    by default;
  * **hardening** — per-request deadlines (``add_request(...,
    deadline_ms=)``), bounded dispatch retry (``max_dispatch_retries=``
    — leak-free rollback, retried next step), slot quarantine after
    repeated same-slot failures (``quarantine_after=``) and graceful
    drain (``engine.drain()``); it lives in the engine, scheduler and
    pools;
  * **supervisor** (supervisor.EngineSupervisor) — consumes wedge
    verdicts (queue stall, KV-block leak, dispatch failure past the
    retry budget) and performs an in-process restart: fresh pools,
    rebuilt programs, in-flight requests re-queued for re-prefill with
    exact greedy replay; ``/debug/health`` reports ``degraded`` until
    the replay drains.
"""
from .chaos import (  # noqa: F401
    DEFAULT_RATES, FAULT_SITES, FaultInjector, FaultPlan, FaultSpec,
    InjectedFault, resolve_chaos,
)
from .supervisor import RESTART_ON, EngineSupervisor  # noqa: F401
