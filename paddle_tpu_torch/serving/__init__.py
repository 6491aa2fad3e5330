"""Continuous-batching serving over the paged or the slot-contiguous KV
pool, with chunked prefill, SLO admission, per-slot sampling,
speculative decoding and the KV wire of prefill/decode roles."""
from .engine import (ServingConfig, ServingEngine, default_buckets,
                     default_group_sizes)
from .kv_pool import SlotKVPool
from .scheduler import StepScheduler

__all__ = ["ServingConfig", "ServingEngine", "SlotKVPool", "StepScheduler",
           "default_buckets", "default_group_sizes"]
