"""fleet: the distributed entry point (a port of
``paddle_tpu/distributed/fleet/fleet_base.py``).

Collective mode: ``init`` starts the process group when the launcher's
variables ask for more than one rank and none is running
(``init_parallel_env``), and builds the ``HybridCommunicateGroup`` from
``strategy.hybrid_configs`` (degrees that multiply to 1 make every rank
``dp``, as the reference's do). ``distributed_model`` picks the wrapper
as the reference does (:59-80): ``PipelineParallel`` when ``pp > 1``,
else ``TensorParallel`` when ``mp > 1``, else ``ShardingParallel`` when
``sharding > 1``, else ``DataParallel``. ``distributed_optimizer``
applies the meta-optimizers the strategy turns on
(``meta_optimizers.apply_meta_optimizers``) and wraps the result in
``HybridParallelOptimizer``.

Parameter-server mode (``init`` with a role maker that is not
collective): no process group; servers run ``init_server`` /
``run_server`` (a ``ps.PSServer`` on this rank's endpoint), trainers
``init_worker`` (a ``ps.PSClient`` over the servers and the communicator
the strategy asks for: sync, ``a_sync`` or geo with ``k_steps``) and
``stop_worker``; ``barrier_worker`` meets at the servers' barrier. The
model and the (meta-wrapped) optimizer are used as they are.
"""
import os

import torch.distributed as dist

from .. import collective, topology
from ..env import get_rank, get_world_size
from .distributed_strategy import DistributedStrategy

_fleet_state = {"strategy": None, "hcg": None, "initialized": False}


def _ps_mode(role_maker):
    return role_maker is not None and not getattr(role_maker,
                                                  "_is_collective", False)


def init(role_maker=None, is_collective=True, strategy=None):
    if strategy is None:
        strategy = DistributedStrategy()
    _fleet_state["role_maker"] = role_maker
    if _ps_mode(role_maker):
        # servers and trainers talk over ps/, with no process group
        _fleet_state.update(strategy=strategy, hcg=None, initialized=True)
        return None
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
    _fleet_state.update(strategy=strategy, hcg=hcg, initialized=True)
    return None


def get_hybrid_communicate_group():
    return _fleet_state["hcg"]


def _strategy():
    return _fleet_state["strategy"] or DistributedStrategy()


def distributed_model(model):
    """Reference fleet_base.py:59 — the parallel wrapper of the
    topology (the model itself in parameter-server mode)."""
    if not _fleet_state["initialized"]:
        init()
    hcg = _fleet_state["hcg"]
    if hcg is None:
        _fleet_state["dist_model"] = model
        return model
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
    """Reference fleet_base.py:82 — the meta-optimizers, then
    HybridParallelOptimizer (the meta-wrapped optimizer alone in
    parameter-server mode)."""
    if strategy is not None:
        _fleet_state["strategy"] = strategy
    from .hybrid_optimizer import HybridParallelOptimizer
    from .meta_optimizers import apply_meta_optimizers
    optimizer = apply_meta_optimizers(optimizer, _strategy())
    if _fleet_state.get("hcg") is None:
        _fleet_state["dist_optimizer"] = optimizer
        return optimizer
    wrapped = HybridParallelOptimizer(optimizer, _fleet_state["hcg"],
                                      _strategy())
    _fleet_state["dist_optimizer"] = wrapped
    return wrapped


def _role_maker():
    return _fleet_state.get("role_maker")


def worker_num():
    rm = _role_maker()
    if rm is not None and rm._worker_num():
        return rm._worker_num()
    return get_world_size()


def worker_index():
    rm = _role_maker()
    if rm is not None and rm._is_worker():
        return rm._worker_index()
    return get_rank()


def is_first_worker():
    return worker_index() == 0


def barrier_worker():
    """Every worker meets here: at the servers' barrier in
    parameter-server mode, else over the process group."""
    client = _fleet_state.get("ps_client")
    if client is not None and worker_num() > 1:
        client.barrier(worker_num())
        return
    collective.barrier()


def is_worker():
    rm = _role_maker()
    return True if rm is None else rm._is_worker()


def is_server():
    rm = _role_maker()
    return False if rm is None else rm._is_server()


def server_num():
    rm = _role_maker()
    return 0 if rm is None else rm._server_num()


def server_index():
    rm = _role_maker()
    return -1 if rm is None else rm._server_index()


def server_endpoints(to_string=False):
    rm = _role_maker()
    eps = [] if rm is None else rm._get_pserver_endpoints()
    return ",".join(eps) if to_string else eps


def worker_endpoints(to_string=False):
    rm = _role_maker()
    eps = [] if rm is None else rm._get_trainer_endpoints()
    return ",".join(eps) if to_string else eps


def init_server(*args, **kwargs):
    """This rank's PS server on its endpoint (reference init_server:1110);
    a ``model_dir`` as the first argument loads its saved tables."""
    rm = _role_maker()
    if rm is None or not rm._is_server():
        raise RuntimeError("init_server called on a non-server role")
    from ..ps import PSServer
    ep = rm._get_pserver_endpoints()[rm._server_index()]
    host, port = ep.rsplit(":", 1)
    srv = PSServer(host, int(port))
    _fleet_state["ps_server"] = srv
    if args and isinstance(args[0], str):
        path = os.path.join(args[0], f"ps_state.server{rm._server_index()}")
        if os.path.exists(path):
            srv._dispatch({"cmd": "load", "path": path})
    return srv


def run_server():
    """Serve until stopped (blocking; reference run_server:1129)."""
    srv = _fleet_state.get("ps_server")
    if srv is None:
        srv = init_server()
    srv.run()


def init_worker():
    """Connect this trainer to the servers and start the communicator the
    strategy asks for (reference init_worker:1051; communicator.h:197,
    348, 497)."""
    rm = _role_maker()
    if rm is None:
        raise RuntimeError("init_worker needs fleet.init(role_maker)")
    from ..ps import AsyncCommunicator, Communicator, GeoCommunicator, \
        PSClient
    client = PSClient(rm._get_pserver_endpoints())
    strategy = _strategy()
    a_sync = bool(getattr(strategy, "a_sync", False))
    k_steps = int((getattr(strategy, "a_sync_configs", {}) or {})
                  .get("k_steps", 0) or 0)
    if a_sync and k_steps > 0:
        comm = GeoCommunicator(client, k_steps=k_steps)
    elif a_sync:
        comm = AsyncCommunicator(client).start()
    else:
        comm = Communicator(client)
    _fleet_state.update(ps_client=client, communicator=comm)
    return client


def stop_worker():
    comm = _fleet_state.pop("communicator", None)
    if comm is not None:
        comm.stop()
    client = _fleet_state.pop("ps_client", None)
    if client is not None:
        client.close()


def ps_client():
    return _fleet_state.get("ps_client")


def communicator():
    return _fleet_state.get("communicator")


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


def save_persistables(executor=None, dirname=None, main_program=None,
                      **kwargs):
    """Parameter-server mode: the servers' tables; collective mode: the
    wrapped model's state dict as ``model.pdparams``."""
    client = _fleet_state.get("ps_client")
    if client is not None and dirname:
        os.makedirs(dirname, exist_ok=True)
        client.save(os.path.join(dirname, "ps_state"))
        return
    m = _fleet_state.get("dist_model")
    if m is not None and dirname:
        from ...framework.io_utils import save
        os.makedirs(dirname, exist_ok=True)
        save(m.state_dict(), os.path.join(dirname, "model.pdparams"))


def save_inference_model(executor=None, dirname=None, feeded_var_names=None,
                         target_vars=None, main_program=None, **kwargs):
    from ...static import save_inference_model as _sim
    if main_program is not None and dirname:
        os.makedirs(dirname, exist_ok=True)
        return _sim(os.path.join(dirname, "model"),
                    feeded_var_names or [], target_vars or [],
                    program=main_program)
