"""Self-drafting speculative decoding (a port of
``paddle_tpu/serving/spec``): an n-gram drafter proposes up to k tokens
a slot from the slot's own context, and one verify program checks all
k+1 positions in a single call. Greedy only."""
from .decoder import SpecDecoder
from .drafter import NGramDrafter
from .programs import build_paged_spec_verify_fn, build_spec_verify_fn

__all__ = ["SpecDecoder", "NGramDrafter", "build_spec_verify_fn",
           "build_paged_spec_verify_fn"]
