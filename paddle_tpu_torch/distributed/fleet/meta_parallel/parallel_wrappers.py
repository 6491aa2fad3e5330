"""Parallel model wrappers (a port of the tensor-parallel part of
``paddle_tpu/distributed/fleet/meta_parallel/parallel_wrappers.py``).

``TensorParallel`` (reference meta_parallel/tensor_parallel.py): at
construction the parameters that every ``mp`` rank holds whole are
broadcast from the ``mp`` group's first rank, and every parameter from
the first rank of the ``dp`` and ``sp`` groups; after each backward the
grads are summed over ``sp`` and averaged over ``dp``
(``parallel.GradSync``). The split parameters need no sync over ``mp``:
each rank's grad of its shard is whole, the ``_c_identity`` /
``_mp_allreduce`` pairs of the layers having summed what crosses ranks.
``PipelineParallel`` and ``ShardingParallel`` are not ported yet and
raise.
"""
from ...parallel import GradSync, Wrapper, sync_params, torch_leaves
from .mp_layers import split_of


def _not_ported(name):
    raise NotImplementedError(
        f"{name} is not ported yet: the pipeline and sharding parallel "
        "wrappers come with queue 1 item 13 (pipeline.py, sharding/)")


class _MetaParallelBase(Wrapper):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__(layers)
        self._hcg = hcg
        self._strategy = strategy


class TensorParallel(_MetaParallelBase):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__(layers, hcg, strategy)
        params = torch_leaves(layers)
        mp = hcg.get_model_parallel_group()
        dp = hcg.get_data_parallel_group()
        sp = hcg.get_sequence_parallel_group()
        whole = [p for p in params if split_of(p) is None]
        sync_params(whole, [(mp, mp.ranks[0])])
        sync_params(params, [(dp, dp.ranks[0]), (sp, sp.ranks[0])])
        self._grad_sync = GradSync(params, avg_group=dp, sum_group=sp)


class PipelineParallel(_MetaParallelBase):
    def __init__(self, layers, hcg, strategy=None):
        _not_ported("PipelineParallel")


class ShardingParallel(_MetaParallelBase):
    def __init__(self, layers, hcg, strategy=None):
        _not_ported("ShardingParallel")
