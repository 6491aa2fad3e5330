"""Scheduling: chunked prefill, admission policies and per-slot
sampling (a port of ``paddle_tpu/serving/sched``)."""
from .chunker import ChunkPlan, plan_chunks
from .policy import (FIFOPolicy, SchedulingPolicy, SLOFeedbackPolicy,
                     TriageDecision, resolve_policy)
from .programs import build_chunk_fns
from .sampling import SlotSampler, build_sampling_head, request_sampling_params

__all__ = ["ChunkPlan", "plan_chunks", "FIFOPolicy", "SchedulingPolicy",
           "SLOFeedbackPolicy", "TriageDecision", "resolve_policy",
           "build_chunk_fns", "SlotSampler", "build_sampling_head",
           "request_sampling_params"]
