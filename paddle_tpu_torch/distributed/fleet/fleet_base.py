"""fleet: the distributed entry point, its collective half (a port of
``paddle_tpu/distributed/fleet/fleet_base.py``).

``init`` starts the process group when the launcher's variables ask for
more than one rank and none is running (``init_parallel_env``), and
builds the ``HybridCommunicateGroup`` from ``strategy.hybrid_configs``
(degrees that multiply to 1 make every rank ``dp``, as the reference's
do). ``distributed_model`` picks the wrapper (``TensorParallel`` when
``mp > 1``, else ``DataParallel``); ``distributed_optimizer`` wraps the
optimizer in ``HybridParallelOptimizer``. The parameter-server mode
(``role_maker`` not collective, ``init_server``, ``init_worker``, ...),
the pipeline and sharding wrappers and the meta-optimizers are not
ported yet (queue 1 item 13) and raise ``NotImplementedError``.
"""
import os

import torch.distributed as dist

from .. import collective, topology
from ..env import get_rank, get_world_size
from .distributed_strategy import DistributedStrategy

_fleet_state = {"strategy": None, "hcg": None, "initialized": False}


def _not_ported(what):
    raise NotImplementedError(
        f"{what} is not ported yet: the parameter-server mode, the "
        "pipeline and sharding wrappers and the meta-optimizers come with "
        "queue 1 item 13 (ps/, pipeline.py, sharding/, meta_optimizers)")


def _check_meta_optimizers(strategy):
    on = [k for k in DistributedStrategy.META_OPTIMIZERS
          if getattr(strategy, k)]
    if on:
        _not_ported(f"the meta-optimizer(s) {on}")


def init(role_maker=None, is_collective=True, strategy=None):
    if role_maker is not None and not getattr(role_maker, "_is_collective",
                                              False):
        _not_ported("fleet.init(role_maker) in parameter-server mode")
    if strategy is None:
        strategy = DistributedStrategy()
    _check_meta_optimizers(strategy)
    if not dist.is_initialized() \
            and int(os.environ.get("PADDLE_TRAINERS_NUM", "1")) > 1:
        from ..parallel import init_parallel_env
        init_parallel_env()
    strategy.check_conflicts(device_count=get_world_size())
    hc = strategy.hybrid_configs
    hcg = topology.HybridCommunicateGroup(
        dp=hc.get("dp_degree", 1), mp=hc.get("mp_degree", 1),
        pp=hc.get("pp_degree", 1), sharding=hc.get("sharding_degree", 1),
        sp=hc.get("sp_degree", 1))
    _fleet_state.update(strategy=strategy, hcg=hcg, initialized=True,
                        role_maker=role_maker)
    return None


def get_hybrid_communicate_group():
    return _fleet_state["hcg"]


def _strategy():
    return _fleet_state["strategy"] or DistributedStrategy()


def distributed_model(model):
    """Reference fleet_base.py:59 — the parallel wrapper of the
    topology."""
    if not _fleet_state["initialized"]:
        init()
    hcg = _fleet_state["hcg"]
    from .meta_parallel.parallel_wrappers import (
        PipelineParallel, ShardingParallel, TensorParallel)
    from ..parallel import DataParallel
    if hcg.get_pipe_parallel_world_size() > 1:
        wrapped = PipelineParallel(model, hcg, strategy=_strategy())
    elif hcg.get_model_parallel_world_size() > 1:
        wrapped = TensorParallel(model, hcg, strategy=_strategy())
    elif hcg.get_sharding_parallel_world_size() > 1:
        wrapped = ShardingParallel(model, hcg, strategy=_strategy())
    else:
        wrapped = DataParallel(model)
    _fleet_state["dist_model"] = wrapped
    return wrapped


def distributed_optimizer(optimizer, strategy=None):
    """Reference fleet_base.py:82 + HybridParallelOptimizer."""
    if strategy is not None:
        _check_meta_optimizers(strategy)
        _fleet_state["strategy"] = strategy
    from .hybrid_optimizer import HybridParallelOptimizer
    wrapped = HybridParallelOptimizer(optimizer, _fleet_state["hcg"],
                                      _strategy())
    _fleet_state["dist_optimizer"] = wrapped
    return wrapped


def worker_num():
    return get_world_size()


def worker_index():
    return get_rank()


def is_first_worker():
    return worker_index() == 0


def barrier_worker():
    collective.barrier()


def is_worker():
    return True


def is_server():
    return False


def minimize(loss, startup_program=None, parameter_list=None,
             no_grad_set=None):
    """Reference fleet_base.py:1288 — needs distributed_optimizer
    first."""
    opt = _fleet_state.get("dist_optimizer")
    if opt is None:
        raise RuntimeError("call fleet.distributed_optimizer(opt) before "
                           "fleet.minimize")
    return opt.minimize(loss)


def state_dict():
    m = _fleet_state.get("dist_model")
    return {} if m is None else m.state_dict()


def init_server(*args, **kwargs):
    _not_ported("fleet.init_server")


def run_server():
    _not_ported("fleet.run_server")


def init_worker():
    _not_ported("fleet.init_worker")


def stop_worker():
    _not_ported("fleet.stop_worker")
