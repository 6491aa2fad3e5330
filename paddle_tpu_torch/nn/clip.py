"""Gradient clipping (reference ``paddle_tpu/nn/clip.py:46-129``).

A clip takes ``[(param, grad), ...]`` and returns a new list with new
grads; ``param.grad`` is left as it is. A parameter is a torch tensor or
the eager core's ``Parameter``, a grad a torch tensor or a core Tensor
(a new grad comes back in the same kind; ``ClipGradByValue`` and
``ClipGradByNorm`` make a sparse grad dense, as the reference's read its
dense value). A parameter with
``need_clip = False`` keeps its grad, as the reference's clips skip it
(reference clip.py:54,68,93,114).
"""
import torch

from ..core.sparse_grad import SparseGradTensor, sparse_slices
from ..core.tensor import Tensor


def _clippable(p, g):
    return g is not None and getattr(p, "need_clip", True)


def _val(g):
    """A grad's dense torch tensor (a sparse one summed into its
    rows)."""
    v = g._value if isinstance(g, Tensor) else g
    return v.to_dense() if v.is_sparse else v


def _like_sparse(g, rows):
    """Scaled rows as the same kind of sparse grad as ``g``."""
    if isinstance(g, Tensor):
        return SparseGradTensor(rows, name=g.name)
    return rows.to_torch()


def _like(g, new):
    """``new`` as the same kind of grad as ``g``."""
    return Tensor._wrap(new) if isinstance(g, Tensor) else new


class ClipGradBase:
    """The clips' base (reference clip.py:41)."""

    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each grad element clamped to ``[min, max]``; ``min`` defaults to
    ``-max``."""

    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        return [(p, _like(g, _val(g).clamp(self.min, self.max)))
                if _clippable(p, g) else (p, g) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
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


class ClipGradByGlobalNorm(ClipGradBase):
    """All clippable grads together: scaled by
    ``clip_norm / max(global_norm, clip_norm)``, the global norm summed
    in f32. A sparse grad (a sparse torch tensor or a
    ``SparseGradTensor``) joins the norm through its coalesced rows and
    comes back as the same kind of sparse grad over them, scaled; it is
    never made dense, and ``param.grad`` keeps its rows (reference
    clip.py:86-125)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        clippable = [g for p, g in params_grads if _clippable(p, g)]
        if not clippable:
            return params_grads
        rows = {}
        for g in clippable:
            sl = sparse_slices(g)
            if sl is not None:
                rows[id(g)] = sl.coalesce()
        dense = [_val(g) for g in clippable if id(g) not in rows]
        dev = dense[0].device if dense \
            else next(iter(rows.values())).values.device
        norm_sq = torch.zeros((), dtype=torch.float32, device=dev)
        for g in dense:
            norm_sq = norm_sq + g.float().square().sum()
        for co in rows.values():
            norm_sq = norm_sq + co.values.float().square().sum()
        factor = self.clip_norm / torch.clamp(norm_sq.sqrt(),
                                              min=self.clip_norm)
        out = []
        for p, g in params_grads:
            if not _clippable(p, g):
                out.append((p, g))
            elif id(g) in rows:
                co = rows[id(g)]
                out.append((p, _like_sparse(
                    g, co.scale(factor.to(co.values.dtype)))))
            else:
                out.append((p, _like(g, _val(g) * factor.to(
                    _val(g).dtype))))
        return out


GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm
