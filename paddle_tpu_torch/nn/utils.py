"""``paddle.nn.utils`` of the port (reference ``paddle_tpu/nn/utils.py``):
the ``weight_norm`` / ``remove_weight_norm`` / ``spectral_norm``
reparameterizations.

Each is a forward-pre-hook on the port's ``nn.Layer`` that recomputes
the layer's weight from its factors before every call, so the factors
(``weight_g`` and ``weight_v``, or ``weight_orig``), not the fused
weight, are the Parameters the optimizer trains (the reference's hook
contract, nn/utils/weight_norm_hook.py, spectral_norm_hook.py). The
fused weight is a plain attribute of the layer, out of its
``parameters()``.
"""
import numpy as np
import torch

from ..core.dispatch import register_op
from ..core.tensor import Parameter


@register_op("weight_norm_recompose")
def _wn_recompose(g, v, *, dim, eps):
    if dim < 0:  # dim=None: a scalar g over the whole tensor's norm
        return v / torch.sqrt((v * v).sum() + eps) * g
    axes = tuple(i for i in range(v.dim()) if i != dim)
    norm = torch.sqrt((v * v).sum(dim=axes, keepdim=True) + eps)
    shape = [1] * v.dim()
    shape[dim] = -1
    return v / norm * g.reshape(shape)


def weight_norm(layer, name="weight", dim=0):
    """``w = g * v / ||v||`` (reference weight_norm_hook.py): trains
    ``{name}_g`` (the norms of ``w`` around ``dim``; a scalar for
    ``dim=None``) and ``{name}_v`` (``w`` itself at the start), and
    recomputes ``name`` before each forward."""
    w = getattr(layer, name)
    if dim is None:
        dim = -1
    wv = np.asarray(w.numpy())
    if dim < 0:
        g0 = np.sqrt((wv * wv).sum())
    else:
        axes = tuple(i for i in range(wv.ndim) if i != dim)
        g0 = np.sqrt((wv * wv).sum(axis=axes))
    v = Parameter(w.value, name=f"{w.name}_v")
    g = Parameter(torch.as_tensor(np.asarray(g0, np.float32),
                                  device=w._v.device),
                  name=f"{w.name}_g")
    setattr(layer, f"{name}_v", v)
    setattr(layer, f"{name}_g", g)
    # the fused weight becomes derived state, not a trained Parameter
    layer._parameters.pop(name, None)
    object.__setattr__(layer, name, None)

    def _pre_hook(lyr, inputs):
        object.__setattr__(lyr, name,
                           _wn_recompose(g, v, dim=int(dim), eps=1e-12))

    helper = layer.register_forward_pre_hook(_pre_hook)
    layer.__dict__.setdefault("_weight_norm_hooks", {})[name] = (helper,
                                                                 dim)
    _pre_hook(layer, None)   # the weight is there to read at once
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold ``g * v / ||v||`` back into a plain trained Parameter."""
    hooks = layer.__dict__.get("_weight_norm_hooks", {})
    if name not in hooks:
        raise ValueError(f"no weight_norm hook on {name!r}")
    helper, dim = hooks.pop(name)
    helper.remove()
    g = getattr(layer, f"{name}_g")
    v = getattr(layer, f"{name}_v")
    fused = _wn_recompose(g, v, dim=int(dim), eps=1e-12)
    base = v.name[:-2] if v.name.endswith("_v") else v.name
    layer.__dict__.pop(name, None)
    setattr(layer, name, Parameter(fused.value, name=base))
    for part in ("_g", "_v"):
        layer._parameters.pop(name + part, None)
        object.__setattr__(layer, name + part, None)
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """Divide ``name`` by its largest singular value before each forward
    (reference spectral_norm_hook.py), through a ``SpectralNorm``
    sublayer whose ``weight_u``/``weight_v`` buffers checkpoint with the
    layer. ``Linear`` (weight ``[in, out]``) and the transposed layers
    iterate around dim 1, the others around dim 0. ``{name}_orig`` is
    the trained Parameter."""
    from .layer.common import Linear
    from .layer.norm import SpectralNorm
    w = getattr(layer, name)
    if dim is None:
        dim = 1 if isinstance(layer, Linear) \
            or "Transpose" in type(layer).__name__ else 0
    sn = SpectralNorm(list(w.shape), dim=int(dim),
                      power_iters=int(n_power_iterations), eps=float(eps))
    orig = Parameter(w.value, name=f"{w.name}_orig")
    setattr(layer, f"{name}_orig", orig)
    setattr(layer, f"_{name}_spectral_norm", sn)
    layer._parameters.pop(name, None)
    object.__setattr__(layer, name, None)

    def _pre_hook(lyr, inputs):
        object.__setattr__(lyr, name, sn(orig))

    helper = layer.register_forward_pre_hook(_pre_hook)
    layer.__dict__.setdefault("_spectral_norm_hooks", {})[name] = helper
    _pre_hook(layer, None)
    return layer
