"""Continuous-batching serving over the paged KV pool."""
from .engine import ServingConfig, ServingEngine
from .scheduler import StepScheduler

__all__ = ["ServingConfig", "ServingEngine", "StepScheduler"]
