"""Legacy transpiler-mode PS fleet (reference:
fluid/incubate/fleet/parameter_server/distribute_transpiler/
__init__.py:714 `fleet = FleetTranspiler()`).

The reference rewrites the program into trainer/server halves with a
DistTranspiler; the port's modern PS runtime already does the
equivalent split (server-side tables + trainer-side communicator), so
the legacy verbs delegate — legacy strategies are translated via
`to_modern()` at distributed_optimizer time.
"""
from ......distributed import fleet as _modern
from ...base.fleet_base import DistributedOptimizer, Fleet
from ...base.mode import Mode
from .distributed_strategy import (DistributedStrategy, StrategyFactory,
                                   SyncStrategy)


class FleetTranspiler(Fleet):
    def __init__(self):
        super().__init__(Mode.TRANSPILER)

    def distributed_optimizer(self, optimizer, strategy=None):
        if strategy is None:
            strategy = StrategyFactory.create_sync_strategy()
        if isinstance(strategy, DistributedStrategy):
            modern = strategy.to_modern()
        else:
            modern = strategy  # already a modern strategy
        wrapped = _modern.distributed_optimizer(optimizer, strategy=modern)
        self._optimizer = ParameterServerOptimizer(optimizer, strategy)
        # reuse the modern wrap (stateful meta-optimizers) instead of
        # re-wrapping on the first minimize()
        self._optimizer._modern_opt = wrapped
        return self._optimizer


class ParameterServerOptimizer(DistributedOptimizer):
    """Reference: distribute_transpiler/__init__.py
    ParameterServerOptimizer."""


fleet = FleetTranspiler()
