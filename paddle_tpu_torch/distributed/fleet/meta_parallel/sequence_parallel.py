"""Sequence-parallel attention over the ``sp`` group (a port of
``paddle_tpu/distributed/fleet/meta_parallel/sequence_parallel.py``).

``ring_attention``/``ulysses_attention`` take this rank's sequence block
of q/k/v ``[B, H, S/sp, D]`` and the ``sp`` group (the hybrid
topology's by default); without an ``sp`` group of more than one rank
they are the flash attention of ``ops.attention``. ``sp_degree`` in
``fleet``'s ``hybrid_configs`` sizes the group.
"""
from ....ops import ring_attention as ra
from ... import topology


def _sp_group(group):
    return topology.axis_group("sp", group)


def ring_attention(q, k, v, causal=True, scale=None, group=None):
    """Context-parallel attention: K/V blocks go around the ring."""
    return ra.ring_attention(q, k, v, _sp_group(group), causal=causal,
                             scale=scale)


def ulysses_attention(q, k, v, causal=True, scale=None, group=None):
    """All-to-all sequence parallelism (heads must divide by sp)."""
    return ra.ulysses_attention(q, k, v, _sp_group(group), causal=causal,
                                scale=scale)


class SequenceParallelAttention:
    """Config-selectable SP attention for model code."""

    def __init__(self, mode="ring", causal=True):
        if mode not in ("ring", "ulysses"):
            raise ValueError(f"mode must be 'ring' or 'ulysses', got "
                             f"{mode!r}")
        self.mode = mode
        self.causal = causal

    def __call__(self, q, k, v, scale=None):
        fn = ring_attention if self.mode == "ring" else ulysses_attention
        return fn(q, k, v, causal=self.causal, scale=scale)
