"""Gradient clipping (reference ``paddle_tpu/nn/clip.py:46-129``).

A clip takes ``[(param, grad), ...]`` and returns a new list with new
grads; ``param.grad`` is left as it is. A parameter is a torch tensor or
the eager core's ``Parameter``, a grad a torch tensor or a core Tensor
(a new grad comes back in the same kind). A parameter with
``need_clip = False`` keeps its grad, as the reference's clips skip it
(reference clip.py:54,68,93,114).
"""
import torch

from ..core.tensor import Tensor


def _clippable(p, g):
    return g is not None and getattr(p, "need_clip", True)


def _val(g):
    return g._value if isinstance(g, Tensor) else g


def _like(g, new):
    """``new`` as the same kind of grad as ``g``."""
    return Tensor._wrap(new) if isinstance(g, Tensor) else new


class ClipGradByValue:
    """Each grad element clamped to ``[min, max]``; ``min`` defaults to
    ``-max``."""

    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        return [(p, _like(g, _val(g).clamp(self.min, self.max)))
                if _clippable(p, g) else (p, g) for p, g in params_grads]


class ClipGradByNorm:
    """Each grad on its own: scaled by ``clip_norm / norm`` where its L2
    norm exceeds ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if _clippable(p, g):
                v = _val(g)
                n = v.square().sum().sqrt()
                factor = torch.where(
                    n > self.clip_norm,
                    self.clip_norm / torch.clamp(n, min=1e-12),
                    torch.ones_like(n))
                g = _like(g, v * factor.to(v.dtype))
            out.append((p, g))
        return out


class ClipGradByGlobalNorm:
    """All clippable grads together: scaled by
    ``clip_norm / max(global_norm, clip_norm)``, the global norm summed
    in f32."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        grads = [_val(g) for p, g in params_grads if _clippable(p, g)]
        if not grads:
            return params_grads
        norm_sq = torch.zeros((), dtype=torch.float32,
                              device=grads[0].device)
        for g in grads:
            norm_sq = norm_sq + g.float().square().sum()
        factor = self.clip_norm / torch.clamp(norm_sq.sqrt(),
                                              min=self.clip_norm)
        return [(p, _like(g, _val(g) * factor.to(_val(g).dtype)))
                if _clippable(p, g) else (p, g) for p, g in params_grads]
