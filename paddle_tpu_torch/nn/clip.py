"""Gradient clipping (reference ``paddle_tpu/nn/clip.py:46-129``).

A clip takes ``[(param, grad), ...]`` and returns a new list with new
grads; ``param.grad`` is left as it is. A parameter with
``need_clip = False`` keeps its grad.
"""
import torch


def _clippable(p, g):
    return g is not None and getattr(p, "need_clip", True)


class ClipGradByValue:
    """Each grad element clamped to ``[min, max]``; ``min`` defaults to
    ``-max``."""

    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        return [(p, g.clamp(self.min, self.max)) if _clippable(p, g)
                else (p, g) for p, g in params_grads]


class ClipGradByNorm:
    """Each grad on its own: scaled by ``clip_norm / norm`` where its L2
    norm exceeds ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if _clippable(p, g):
                n = g.square().sum().sqrt()
                factor = torch.where(
                    n > self.clip_norm,
                    self.clip_norm / torch.clamp(n, min=1e-12),
                    torch.ones_like(n))
                g = g * factor.to(g.dtype)
            out.append((p, g))
        return out


class ClipGradByGlobalNorm:
    """All clippable grads together: scaled by
    ``clip_norm / max(global_norm, clip_norm)``, the global norm summed
    in f32."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        grads = [g for p, g in params_grads if _clippable(p, g)]
        if not grads:
            return params_grads
        norm_sq = torch.zeros((), dtype=torch.float32,
                              device=grads[0].device)
        for g in grads:
            norm_sq = norm_sq + g.float().square().sum()
        factor = self.clip_norm / torch.clamp(norm_sq.sqrt(),
                                              min=self.clip_norm)
        return [(p, g * factor.to(g.dtype)) if _clippable(p, g) else (p, g)
                for p, g in params_grads]
