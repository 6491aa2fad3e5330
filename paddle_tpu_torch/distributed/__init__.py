"""``paddle.distributed`` (a port of ``paddle_tpu/distributed``): one
rank a process on ``torch.distributed``, as Paddle runs.

``env`` (ranks, ``ParallelEnv``), ``topology`` (the hybrid layout and its
groups), ``collective`` (the collectives, groups, the point-to-point
exchange and the tensor-parallel autograd pairs), ``parallel``
(``init_parallel_env``, ``DataParallel``), ``launch_mod`` (``spawn``,
``launch``; ``python -m paddle_tpu_torch.distributed.launch``),
``pipeline`` (the 1F1B schedule and its functional API), ``sharding``
(ZeRO: ``group_sharded_parallel``), ``ps`` (the parameter server),
``utils_recompute`` and ``fleet``: its collective and parameter-server
halves, ``meta_parallel`` (tensor, sequence and pipeline parallelism,
``PipelineLayer``), the meta-optimizers, the datasets, ``elastic`` and
the distributed embeddings.
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
from .launch_mod import spawn, launch  # noqa: F401
from . import sharding  # noqa: F401
from .fleet.dataset import InMemoryDataset, QueueDataset  # noqa: F401


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
