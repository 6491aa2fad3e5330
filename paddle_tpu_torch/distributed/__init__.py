"""``paddle.distributed`` (a port of ``paddle_tpu/distributed``): one
rank a process on ``torch.distributed``, as Paddle runs.

Ported: ``env`` (ranks, ``ParallelEnv``), ``topology`` (the hybrid
layout and its groups), ``collective`` (the collectives, groups and the
tensor-parallel autograd pairs), ``parallel`` (``init_parallel_env``,
``DataParallel``), ``utils_recompute`` and ``fleet``'s collective half
with ``meta_parallel``'s tensor- and sequence-parallel layers. Not bound
yet, each with the item that brings it: ``launch_mod`` (``spawn``,
``launch``), ``sharding``, ``pipeline``, ``ps``, ``fleet.dataset``
(``InMemoryDataset``, ``QueueDataset``), ``fleet.utils_fs``,
``fleet.data_generator``, ``meta_parallel.pp_layers`` and
``fleet.meta_optimizers`` — queue 1 item 13's next slice.
"""
from . import env  # noqa: F401
from .env import get_rank, get_world_size, ParallelEnv  # noqa: F401
from .parallel import init_parallel_env, DataParallel  # noqa: F401
from .collective import (  # noqa: F401
    all_reduce, all_gather, broadcast, reduce, scatter, alltoall,
    reduce_scatter, barrier, wait, new_group, get_group, Group, ReduceOp,
    is_initialized, _c_identity, _mp_allreduce, send, recv, split,
)
from . import topology  # noqa: F401
from . import fleet  # noqa: F401


class ProbabilityEntry:
    """Reference: distributed/entry_attr.py — sparse-table entry admission
    by show probability."""

    def __init__(self, probability):
        self.probability = float(probability)

    def _to_attr(self):
        return f"probability_entry:{self.probability}"


class CountFilterEntry:
    """Reference: distributed/entry_attr.py — admission after N shows."""

    def __init__(self, count_filter):
        self.count_filter = int(count_filter)

    def _to_attr(self):
        return f"count_filter_entry:{self.count_filter}"
