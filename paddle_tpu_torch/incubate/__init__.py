"""``paddle.incubate`` (a port of ``paddle_tpu/incubate/``): ``moe``
(the mixture of experts with expert parallelism), ``checkpoint``
(sharded checkpoints over ``torch.distributed.checkpoint`` and
``auto_checkpoint``'s resumable epoch range), ``asp`` (2:4 structured
sparsity), the ``LookAhead`` and ``ModelAverage`` optimizer transforms,
and ``softmax_mask_fuse`` / ``softmax_mask_fuse_upper_triangle``.

``LookAhead`` and ``ModelAverage`` write the parameters' torch leaves in
place under ``torch.no_grad()``, after the pending lazy graph has run
(``optimizer.WrappedOptimizer``): a lazy step's graph is then the same
at every step, and a k-th step's interpolation is never part of a graph
that other steps replay. Both softmaxes are plain torch ops, as the
reference's are XLA compositions (no Pallas kernel, so no CUDA kernel).
"""
import torch

from . import asp  # noqa: F401
from . import checkpoint  # noqa: F401
from . import moe  # noqa: F401
from ..core import lazy
from ..core.dispatch import register_op
from ..optimizer.optimizer import WrappedOptimizer, _leaf, _named


class LookAhead(WrappedOptimizer):
    """Reference ``incubate/__init__.py:7``: k fast steps of the inner
    optimizer, then the weights become ``slow + alpha (fast - slow)`` and
    the slow copy is taken again. The first slow copy is taken after the
    first inner step, not at construction. ``clear_grad`` and
    ``minimize`` are forwarded, everything else goes to the inner
    optimizer."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        super().__init__(inner_optimizer)
        self.alpha = float(alpha)
        self.k = int(k)
        self._step = 0
        self._slow = None

    @property
    def inner_optimizer(self):
        return self._inner_opt

    @torch.no_grad()
    def step(self):
        self._inner_opt.step()
        lazy.flush()
        params = self._inner_opt._parameter_list()
        if self._slow is None:
            self._slow = [p.detach().clone() for p in params]
        self._step += 1
        if self._step % self.k == 0:
            for p, s in zip(params, self._slow):
                # s + alpha (p - s), rounded as the reference rounds it
                d = p - s
                d.mul_(self.alpha)
                s.add_(d)
                p.copy_(s)


class ModelAverage:
    """Reference ``incubate/__init__.py:45``: the plain running sum of
    the parameters at every ``step()`` over the count (the window
    arguments are taken and, as in the reference, not read);
    ``apply(need_restore)`` swaps the average in over a backup and
    ``restore()`` puts the backup back."""

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        if parameters is None:
            raise ValueError("ModelAverage needs parameters")
        self._params = [p for _, p in _named(list(parameters))]
        self._sum = None
        self._count = 0
        self._backup = None

    def _leaves(self):
        lazy.flush()
        return [_leaf(p) for p in self._params]

    @torch.no_grad()
    def step(self):
        leaves = self._leaves()
        if self._sum is None:
            self._sum = [torch.zeros_like(p) for p in leaves]
        torch._foreach_add_(self._sum, leaves)
        self._count += 1

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        if not self._count:
            return
        leaves = self._leaves()
        self._backup = [p.detach().clone() for p in leaves]
        for p, s in zip(leaves, self._sum):
            p.copy_(s / self._count)
        if not need_restore:
            self._backup = None

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is None:
            return
        for p, b in zip(self._leaves(), self._backup):
            p.copy_(b)
        self._backup = None


def softmax_mask_fuse(x, mask, name=None):
    """Reference ``incubate/__init__.py:85``: ``softmax(x + mask)`` over
    the last axis, the mask cast to ``x``'s dtype."""
    from ..ops import math as math_ops
    from ..ops import nn_ops
    return nn_ops.softmax(math_ops.add(x, math_ops.cast(mask, x.dtype)),
                          axis=-1)


def softmax_mask_fuse_upper_triangle(x):
    """Reference ``incubate/__init__.py:92``: the softmax over causal
    scores, the upper triangle set to -1e9 (not -inf) first."""
    return _softmax_causal(x)


@register_op("softmax_mask_fuse_upper_triangle")
def _softmax_causal(x):
    s = x.shape[-1]
    keep = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    scores = torch.where(keep, x, torch.full_like(x, -1e9))
    return torch.softmax(scores, dim=-1)
