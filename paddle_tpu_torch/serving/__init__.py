"""Continuous-batching serving over the paged or the slot-contiguous KV
pool, with chunked prefill, SLO admission, per-slot sampling,
speculative decoding and the KV wire of prefill/decode roles; hardened
(deadlines, bounded retry, quarantine, drain, fault injection, the
supervisor) and behind a router over replicas (``serving.router``)."""
from .engine import (ServingConfig, ServingEngine, default_buckets,
                     default_group_sizes)
from .kv_pool import SlotKVPool
from .resilience import (EngineSupervisor, FaultInjector, FaultPlan,
                         FaultSpec, InjectedFault)
from .router import (CircuitBreaker, EngineGateway, HTTPTransport,
                     InProcessTransport, RequestJournal, Router,
                     RouterConfig, TransportError, TransportRefused)
from .scheduler import StepScheduler

__all__ = ["ServingConfig", "ServingEngine", "SlotKVPool", "StepScheduler",
           "default_buckets", "default_group_sizes",
           "EngineSupervisor", "FaultInjector", "FaultPlan", "FaultSpec",
           "InjectedFault",
           "CircuitBreaker", "EngineGateway", "HTTPTransport",
           "InProcessTransport", "RequestJournal", "Router",
           "RouterConfig", "TransportError", "TransportRefused"]
