"""Legacy collective fleet (reference:
fluid/incubate/fleet/collective/__init__.py:51 `Collective`, :196
`fleet = Collective()`, :249 `CollectiveOptimizer`).

Delegates to the modern collective runtime (`paddle.distributed.fleet`
with is_collective=True: the port's process groups and collectives).
"""
from ..base.fleet_base import DistributedOptimizer, Fleet
from ..base.mode import Mode


class DistributedStrategy:
    """Legacy knob bag (reference :199 extends BuildStrategy). All of
    these tune the reference's NCCL allreduce scheduling, which the
    modern runtime does its own way — the knobs are accepted-and-ignored
    for source compat."""

    def __init__(self):
        self.fuse_all_reduce_ops = True
        self.nccl_comm_num = 1
        self.use_hierarchical_allreduce = False
        self.hierarchical_allreduce_inter_nranks = 0
        self.mode = "collective"
        self.collective_mode = "grad_allreduce"


class LambConfig:
    """Reference :41 — marker config selecting the Lamb optimizer."""


class DistFCConfig:
    """Reference :46 — distributed-FC sharding marker."""


class Collective(Fleet):
    def __init__(self):
        super().__init__(Mode.COLLECTIVE)

    def distributed_optimizer(self, optimizer, strategy=None):
        self._optimizer = CollectiveOptimizer(optimizer, strategy)
        return self._optimizer


class CollectiveOptimizer(DistributedOptimizer):
    """Reference :249 — wraps the inner optimizer for collective
    (allreduce) training through the modern runtime's
    distributed_optimizer."""

    def __init__(self, optimizer, strategy=None):
        if strategy is None:
            strategy = DistributedStrategy()
        super().__init__(optimizer, strategy)


fleet = Collective()
