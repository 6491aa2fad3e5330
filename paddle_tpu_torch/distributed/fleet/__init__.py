"""``paddle.distributed.fleet``: the collective half (see
:mod:`.fleet_base`). Not bound yet, each with the item that brings it:
``meta_optimizers`` (GradientMerge, LocalSGD, DGC, ...), ``dataset``
(InMemoryDataset, QueueDataset), ``utils_fs`` (LocalFS, HDFSClient),
``data_generator``, ``elastic``, ``distributed_embedding`` and the
parameter-server mode over ``ps/`` — queue 1 item 13's next slice."""
from .fleet_base import (  # noqa: F401
    init, distributed_model, distributed_optimizer,
    get_hybrid_communicate_group, worker_num, worker_index, is_first_worker,
    barrier_worker, is_worker, is_server, minimize, state_dict,
    init_server, run_server, init_worker, stop_worker,
)
from .distributed_strategy import DistributedStrategy  # noqa: F401
from .role_maker import (  # noqa: F401
    Role, PaddleCloudRoleMaker, UserDefinedRoleMaker,
)
from .hybrid_optimizer import (  # noqa: F401
    HybridParallelClipGrad, HybridParallelOptimizer,
)
from ..topology import HybridCommunicateGroup, CommunicateTopology  # noqa: F401
from . import meta_parallel  # noqa: F401
from ..utils_recompute import recompute  # noqa: F401


class utils:
    from ..utils_recompute import recompute  # noqa: F401
