"""Continuous-batching serving over the paged or the slot-contiguous KV
pool, with chunked prefill, SLO admission, per-slot sampling,
speculative decoding and the KV wire of prefill/decode roles; hardened
(deadlines, bounded retry, quarantine, drain, fault injection, the
supervisor) and behind a router over replicas (``serving.router``)."""
from .engine import (ServingConfig, ServingEngine, default_buckets,
                     default_group_sizes)
from .kv_pool import SlotKVPool
from .metrics import ServingMetrics
from .paged.pool import PagedKVPool
from .paged.radix import RadixPrefixIndex
from .resilience import (EngineSupervisor, FaultInjector, FaultPlan,
                         FaultSpec, InjectedFault)
from .router import (CircuitBreaker, EngineGateway, HTTPTransport,
                     InProcessTransport, RequestJournal, Router,
                     RouterConfig, TransportError, TransportRefused)
from .sched.chunker import ChunkPlan, plan_chunks
from .sched.policy import FIFOPolicy, SchedulingPolicy, SLOFeedbackPolicy
from .sched.sampling import SlotSampler
from .scheduler import Request, StepScheduler
from .spec.decoder import SpecDecoder
from .spec.drafter import NGramDrafter

__all__ = ["ServingConfig", "ServingEngine", "SlotKVPool", "StepScheduler",
           "default_buckets", "default_group_sizes",
           "EngineSupervisor", "FaultInjector", "FaultPlan", "FaultSpec",
           "InjectedFault",
           "CircuitBreaker", "EngineGateway", "HTTPTransport",
           "InProcessTransport", "RequestJournal", "Router",
           "RouterConfig", "TransportError", "TransportRefused",
           "ServingMetrics", "PagedKVPool", "RadixPrefixIndex", "ChunkPlan",
           "plan_chunks", "FIFOPolicy", "SchedulingPolicy",
           "SLOFeedbackPolicy", "SlotSampler", "Request", "SpecDecoder",
           "NGramDrafter"]
