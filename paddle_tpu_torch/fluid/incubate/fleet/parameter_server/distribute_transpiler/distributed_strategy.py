"""Legacy PS strategy factory (reference:
fluid/incubate/fleet/parameter_server/distribute_transpiler/
distributed_strategy.py:17 __all__, :26 TrainerRuntimeConfig, :137
DistributedStrategy, :297+ Sync/Async/HalfAsync/Geo strategies).

Each legacy strategy knows how to express itself as the modern
`paddle.distributed.fleet.DistributedStrategy` (`to_modern()`), which
is what FleetTranspiler hands to the modern runtime: sync -> a_sync
off; async/half-async -> a_sync; geo -> a_sync + k_steps.
"""

__all__ = ["TrainerRuntimeConfig", "DistributedStrategy", "SyncStrategy",
           "AsyncStrategy", "HalfAsyncStrategy", "GeoStrategy",
           "StrategyFactory"]


class TrainerRuntimeConfig:
    """Communicator tuning knobs (reference :26 — env-overridable
    max_merge_var_num / send_queue_size etc.)."""

    def __init__(self):
        import os
        self.runtime_configs = {
            "communicator_max_merge_var_num":
                os.getenv("FLAGS_communicator_max_merge_var_num", "20"),
            "communicator_send_queue_size":
                os.getenv("FLAGS_communicator_send_queue_size", "20"),
            "communicator_independent_recv_thread":
                os.getenv("FLAGS_communicator_independent_recv_thread",
                          "1"),
        }

    def get_communicator_flags(self):
        return dict(self.runtime_configs)


class DistributedStrategy:
    def __init__(self):
        self._program_config = {}
        self._trainer_runtime_config = TrainerRuntimeConfig()
        self._server_runtime_config = {}
        self._execute_strategy = None
        self._build_strategy = None

    def get_trainer_runtime_config(self):
        return self._trainer_runtime_config

    def get_program_config(self):
        return self._program_config

    def get_server_runtime_config(self):
        return self._server_runtime_config

    def to_modern(self):
        """Express this legacy strategy as the modern
        fleet.DistributedStrategy."""
        from ......distributed.fleet import DistributedStrategy as Modern
        s = Modern()
        s.a_sync = self._a_sync()
        k = self._k_steps()
        if k:
            s.a_sync_configs = {"k_steps": k}
        return s

    def _a_sync(self):
        return False

    def _k_steps(self):
        return 0


class SyncStrategy(DistributedStrategy):
    """Fully synchronous PS updates (reference :297)."""


class AsyncStrategy(DistributedStrategy):
    """Fire-and-forget gradient push (reference AsyncStrategy)."""

    def _a_sync(self):
        return True


class HalfAsyncStrategy(DistributedStrategy):
    """Async within a barrier epoch (reference HalfAsyncStrategy); the
    modern runtime's a_sync communicator + worker barriers cover it."""

    def _a_sync(self):
        return True


class GeoStrategy(DistributedStrategy):
    """Geo-SGD delta sync every k steps (reference GeoStrategy)."""

    def __init__(self, update_frequency=100):
        super().__init__()
        self._update_frequency = int(update_frequency)

    def _a_sync(self):
        return True

    def _k_steps(self):
        return self._update_frequency


class StrategyFactory:
    """Reference: StrategyFactory.create_*_strategy() classmethods."""

    @staticmethod
    def create_sync_strategy():
        return SyncStrategy()

    @staticmethod
    def create_async_strategy():
        return AsyncStrategy()

    @staticmethod
    def create_half_async_strategy():
        return HalfAsyncStrategy()

    @staticmethod
    def create_geo_strategy(update_frequency=100):
        return GeoStrategy(update_frequency)
