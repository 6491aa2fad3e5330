"""HybridParallelOptimizer (a port of
``paddle_tpu/distributed/fleet/hybrid_optimizer.py``).

Reference hybrid_parallel_optimizer.py:89. The reference's parameters
are whole logical tensors, so its plain global-norm clip is already the
hybrid one. The port's ranks each hold a part of the model: a shard of
each split parameter (``tp_split``, over ``mp``), the blocks of one
pipeline stage (over ``pp``), or, under ZeRO, the update of one
partition (over ``sharding``). So a ``ClipGradByGlobalNorm`` of the inner
optimizer is replaced by ``HybridParallelClipGrad``: the squares of the
split grads summed over ``mp`` plus those of the grads every ``mp`` rank
holds whole, that sum summed over ``pp`` (a parameter both pipeline ends
hold, the tied embedding, counted on the first stage only) and over
``sharding`` — the norm of the whole model
on every rank. With ``sharding > 1`` the optimizer's state is partitioned
over the ``sharding`` group (``distributed.sharding.ZeroEngine``, the
level from ``sharding_configs["stage"]``), as the reference's is
(:29-33).
"""
import torch

from ...nn.clip import ClipGradByGlobalNorm
from .. import collective
from ..sharding import ZeroEngine, _unwrap, level_of
from .meta_parallel import mp_layers


class HybridParallelClipGrad:
    """``clip_norm / max(global_norm, clip_norm)`` on every grad, the
    norm taken over the whole model across the groups the model is cut
    over (``hcg``'s ``mp`` and ``pp``, and ``sharding_group`` under
    ZeRO)."""

    def __init__(self, clip, hcg=None, sharding_group=None):
        self._clip = getattr(clip, "_clip", clip)
        self.clip_norm = clip.clip_norm
        self._mp = hcg.get_model_parallel_group() if hcg else None
        self._pp = hcg.get_pipe_parallel_group() if hcg else None
        self._sharding = sharding_group

    def __call__(self, params_grads):
        pg = [(p, g) for p, g in params_grads if g is not None]
        if not pg:
            return params_grads
        dev = pg[0][1].device
        split = torch.zeros((), dtype=torch.float32, device=dev)
        whole = torch.zeros((), dtype=torch.float32, device=dev)
        for p, g in pg:
            leaf = getattr(p, "_value", p)
            if getattr(leaf, "pp_norm_counted_elsewhere", False):
                continue
            sq = g.float().square().sum()
            if mp_layers.split_of(leaf) is not None:
                split = split + sq
            else:
                whole = whole + sq
        if self._mp is not None:
            collective.all_reduce(split, group=self._mp)
        total = split + whole
        for g in (self._pp, self._sharding):
            if g is not None:
                collective.all_reduce(total, group=g)
        norm = total.sqrt()
        factor = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
        return [(p, None if g is None else g * factor.to(g.dtype))
                for p, g in params_grads]


class HybridParallelOptimizer:
    def __init__(self, inner_opt, hcg=None, strategy=None):
        self._inner_opt = inner_opt
        self._hcg = hcg
        self._strategy = strategy
        self._zero = None
        if hcg is not None and hcg.get_sharding_parallel_world_size() > 1:
            self._zero = ZeroEngine(inner_opt,
                                    hcg.get_sharding_parallel_group(),
                                    level_of(strategy))
        # what a GradScaler asks of a partitioned update (None: none)
        self._sharding = self._zero
        # the optimizer under every meta-optimizer: the one that clips
        base = _unwrap(inner_opt)
        clip = getattr(base, "_grad_clip", None)
        cut = hcg is not None and (
            hcg.get_model_parallel_world_size() > 1
            or hcg.get_pipe_parallel_world_size() > 1
            or self._zero is not None)
        if cut and isinstance(clip, (ClipGradByGlobalNorm,
                                     HybridParallelClipGrad)):
            base._grad_clip = HybridParallelClipGrad(
                clip, hcg, None if self._zero is None else self._zero.group)

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def step(self):
        if self._zero is not None:
            self._zero.step()
        else:
            self._inner_opt.step()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, *args, **kwargs):
        if self._zero is not None:
            self._zero.clear_grad(*args, **kwargs)
        else:
            self._inner_opt.clear_grad(*args, **kwargs)

    clear_gradients = clear_grad
