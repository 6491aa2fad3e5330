"""HybridParallelOptimizer (a port of
``paddle_tpu/distributed/fleet/hybrid_optimizer.py``).

Reference hybrid_parallel_optimizer.py:89. The reference's parameters
are whole logical tensors, so its plain global-norm clip is already the
hybrid one. The port's split parameters (``tp_split``) hold a
shard each, so a ``ClipGradByGlobalNorm`` of the inner optimizer is
replaced by ``HybridParallelClipGrad``: the squares of the split grads
summed over the ``mp`` group, plus those of the grads every rank holds
whole, counted once — the norm of the whole model on every rank.
Optimizer-state sharding (ZeRO) comes with ``sharding/`` (queue 1 item
13).
"""
import torch

from ...nn.clip import ClipGradByGlobalNorm
from .. import collective
from .meta_parallel import mp_layers


class HybridParallelClipGrad:
    """``clip_norm / max(global_norm, clip_norm)`` on every grad, the
    norm taken over the whole model across the ``mp`` group."""

    def __init__(self, clip, hcg):
        self._clip = clip
        self.clip_norm = clip.clip_norm
        self._group = hcg.get_model_parallel_group()

    def __call__(self, params_grads):
        pg = [(p, g) for p, g in params_grads if g is not None]
        if not pg:
            return params_grads
        dev = pg[0][1].device
        split = torch.zeros((), dtype=torch.float32, device=dev)
        whole = torch.zeros((), dtype=torch.float32, device=dev)
        for p, g in pg:
            sq = g.float().square().sum()
            if mp_layers.split_of(p) is not None:
                split = split + sq
            else:
                whole = whole + sq
        collective.all_reduce(split, group=self._group)
        norm = (split + whole).sqrt()
        factor = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
        return [(p, None if g is None else g * factor.to(g.dtype))
                for p, g in params_grads]


class HybridParallelOptimizer:
    def __init__(self, inner_opt, hcg=None, strategy=None):
        self._inner_opt = inner_opt
        self._hcg = hcg
        self._strategy = strategy
        clip = getattr(inner_opt, "_grad_clip", None)
        if hcg is not None and isinstance(clip, ClipGradByGlobalNorm) \
                and hcg.get_model_parallel_world_size() > 1:
            inner_opt._grad_clip = HybridParallelClipGrad(clip, hcg)

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def step(self):
        self._inner_opt.step()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, *args, **kwargs):
        self._inner_opt.clear_grad(*args, **kwargs)

    clear_gradients = clear_grad
