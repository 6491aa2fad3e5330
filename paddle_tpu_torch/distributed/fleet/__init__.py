"""``paddle.distributed.fleet`` (a port of
``paddle_tpu/distributed/fleet/__init__.py``): the collective half and
the parameter-server half of :mod:`.fleet_base`, the meta-optimizers,
the datasets and their data generators, the filesystem clients, and
``util`` (``UtilBase``: a worker's all_reduce, barrier and file shard,
over the PS servers in parameter-server mode and over the process group
otherwise)."""
from .fleet_base import (  # noqa: F401
    init, distributed_model, distributed_optimizer,
    get_hybrid_communicate_group, worker_num, worker_index, is_first_worker,
    barrier_worker, is_worker, is_server, server_num, server_index,
    server_endpoints, worker_endpoints, init_server, run_server, init_worker,
    stop_worker, minimize, state_dict, save_persistables,
    save_inference_model, ps_client, communicator,
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
from . import meta_optimizers  # noqa: F401
from .meta_optimizers import (  # noqa: F401
    GradientMergeOptimizer, LocalSGDOptimizer, AdaptiveLocalSGDOptimizer,
    DGCMomentumOptimizer, FP16AllReduceOptimizer,
)
from ..utils_recompute import recompute  # noqa: F401
from . import utils_fs  # noqa: F401
from .data_generator import (  # noqa: F401
    DataGenerator, MultiSlotDataGenerator, MultiSlotStringDataGenerator,
)
from .dataset import InMemoryDataset, QueueDataset  # noqa: F401


class utils:
    from ..utils_recompute import recompute  # noqa: F401
    from . import utils_fs as fs  # noqa: F401
    from .utils_fs import LocalFS, HDFSClient  # noqa: F401


class UtilBase:
    """Reference: fleet/utils/__init__.py UtilBase (fleet.util) —
    worker-side helpers over the collective/PS backends."""

    _allreduce_round = [0]

    def all_reduce(self, input, mode="sum", comm_world="worker"):  # noqa: A002
        """Reduce across WORKER processes (reference: gloo all_reduce):
        over the process group in collective mode.
        With a PS cluster attached, trainers combine through a fresh
        round-scoped server-side 'sum' scratch table (create is
        first-wins on the server, so the racing trainers share one
        table); a lone worker is the identity. Calls must be collective:
        every worker invokes the same sequence of all_reduce calls."""
        if mode not in ("sum", "min", "max"):
            raise ValueError(f"util.all_reduce mode {mode!r}; expected "
                             "sum/min/max")
        import numpy as np
        from .fleet_base import ps_client, worker_num, worker_index
        v = getattr(input, "_value", input)
        arr = np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                         else getattr(v, "numpy", lambda: v)())
        client = ps_client()
        n = worker_num()
        if n <= 1:
            return arr  # single worker: reduction of one contribution
        if client is None:
            # collective mode: over the process group
            import torch
            from .. import collective
            t = torch.from_numpy(np.array(arr))
            collective.all_reduce(t, op=mode)
            return t.numpy()
        rnd = self._allreduce_round[0]
        self._allreduce_round[0] += 1
        if mode == "sum":
            tid = f"__fleet_util_allreduce__{rnd}"
            client.create_dense_table(tid, shape=arr.shape,
                                      optimizer="sum",
                                      init=np.zeros_like(arr))
            client.push_dense(tid, arr)
            client.barrier(n)
            out = np.asarray(client.pull_dense(tid))
            client.barrier(n)
            return out
        # min/max: the server tables only sum, so exchange contributions
        # all-to-all through the shuffle service and reduce locally
        # (reference gloo supports sum/min/max; same collective
        # contract). Buckets are namespaced per round and rank — the
        # integer buckets belong to InMemoryDataset.global_shuffle and
        # must not be drained or polluted here.
        import pickle
        me = worker_index()
        blob = pickle.dumps(arr)
        for r in range(n):
            client._call(r % client.n_servers,
                         {"cmd": "shuffle_put",
                          "dest": f"__util_allreduce__{rnd}_{r}",
                          "blobs": [blob]})
        client.barrier(n)
        resp = client._call(me % client.n_servers,
                            {"cmd": "shuffle_take",
                             "rank": f"__util_allreduce__{rnd}_{me}"})
        vals = [pickle.loads(b) for b in resp["blobs"]]
        client.barrier(n)
        if len(vals) != n:
            raise RuntimeError(
                f"util.all_reduce({mode}): received {len(vals)} of {n} "
                "contributions — a worker missed the collective")
        red = np.minimum if mode == "min" else np.maximum
        out = vals[0]
        for v in vals[1:]:
            out = red(out, v)
        return out

    def barrier(self, comm_world="worker"):
        from .fleet_base import barrier_worker
        barrier_worker()

    def get_file_shard(self, files):
        """Split a file list evenly over workers (reference:
        UtilBase.get_file_shard)."""
        from .fleet_base import worker_index, worker_num
        n, i = worker_num(), worker_index()
        per = len(files) // n
        rem = len(files) % n
        start = per * i + min(i, rem)
        end = start + per + (1 if i < rem else 0)
        return files[start:end]

    def print_on_rank(self, message, rank_id=0):
        from .fleet_base import worker_index
        if worker_index() == rank_id:
            print(message)


util = UtilBase()


class Fleet:
    """Reference: fleet_base.py:72 Fleet — the module-level functions ARE
    the singleton's methods; this class exposes the same surface for
    code that instantiates/attributes `fleet.Fleet`."""

    def __getattr__(self, item):
        import sys
        mod = sys.modules[__name__]
        return getattr(mod, item)
