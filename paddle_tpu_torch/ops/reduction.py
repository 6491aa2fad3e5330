"""Reduction ops of the Paddle-style surface (a port of
``paddle_tpu/ops/reduction.py``), registered with the core's dispatcher
under the reference's op names."""
import torch

from ..core.dispatch import register_op


def _norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(x, axis):
    """torch's ``dim`` for a reference ``axis`` (None: every axis)."""
    if axis is None:
        return tuple(range(x.dim()))
    return axis if isinstance(axis, tuple) else (axis,)


def _amax(x, axis=None, keepdims=False):
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdims)


def _amin(x, axis=None, keepdims=False):
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdims)


def _sum(x, axis=None, keepdims=False):
    return torch.sum(x, dim=_dims(x, axis), keepdim=keepdims)


def _mean(x, axis=None, keepdims=False):
    return torch.mean(x, dim=_dims(x, axis), keepdim=keepdims)


def _prod(x, axis=None, keepdims=False):
    out = x
    for d in sorted(_dims(x, axis), reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdims)
    return out


def _all(x, axis=None, keepdims=False):
    return torch.all(x.bool(), dim=_dims(x, axis), keepdim=keepdims) \
        if x.dim() else x.bool()


def _any(x, axis=None, keepdims=False):
    return torch.any(x.bool(), dim=_dims(x, axis), keepdim=keepdims) \
        if x.dim() else x.bool()


def _nansum(x, axis=None, keepdims=False):
    return torch.nansum(x, dim=_dims(x, axis), keepdim=keepdims)


def _nanmean(x, axis=None, keepdims=False):
    return torch.nanmean(x, dim=_dims(x, axis), keepdim=keepdims)


def _make_reduce(name, fn, differentiable=True):
    @register_op(name, differentiable=differentiable)
    def _op(x, *, axis, keepdim):
        return fn(x, axis=axis, keepdims=keepdim)

    def api(x, axis=None, keepdim=False, name=None, dtype=None):
        out = _op(x, axis=_norm_axis(axis), keepdim=bool(keepdim))
        if dtype is not None:
            from . import math as math_ops
            out = math_ops.cast(out, dtype)
        return out
    api.__name__ = name
    return api


sum = _make_reduce("reduce_sum", _sum)  # noqa: A001
mean = _make_reduce("reduce_mean", _mean)
max = _make_reduce("reduce_max", _amax)  # noqa: A001
min = _make_reduce("reduce_min", _amin)  # noqa: A001
prod = _make_reduce("reduce_prod", _prod)
all = _make_reduce("reduce_all", _all, differentiable=False)  # noqa: A001
any = _make_reduce("reduce_any", _any, differentiable=False)  # noqa: A001
amax = max
amin = min
nansum = _make_reduce("reduce_nansum", _nansum)
nanmean = _make_reduce("reduce_nanmean", _nanmean)


@register_op("reduce_std")
def _std(x, *, axis, keepdim, unbiased):
    return torch.std(x, dim=_dims(x, axis), keepdim=keepdim,
                     correction=1 if unbiased else 0)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _std(x, axis=_norm_axis(axis), keepdim=bool(keepdim),
                unbiased=bool(unbiased))


@register_op("reduce_var")
def _var(x, *, axis, keepdim, unbiased):
    return torch.var(x, dim=_dims(x, axis), keepdim=keepdim,
                     correction=1 if unbiased else 0)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _var(x, axis=_norm_axis(axis), keepdim=bool(keepdim),
                unbiased=bool(unbiased))


def _quantile_dims(x, q, axis, keepdim, nan):
    """numpy's (linear) quantile over ``axis`` (None, an int or a tuple),
    as ``jnp.quantile``: the reduced axes moved last and flattened."""
    fn = torch.nanquantile if nan else torch.quantile
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if axis is None:
        out = fn(x.reshape(-1), qt, dim=0)
        if keepdim:
            out = out.reshape(out.shape[:qt.dim()] + (1,) * x.dim())
        return out
    dims = sorted(d % x.dim() for d in _dims(x, axis))
    rest = [d for d in range(x.dim()) if d not in dims]
    moved = x.permute(rest + dims).reshape(
        [x.shape[d] for d in rest] + [-1])
    out = fn(moved, qt, dim=-1)
    if keepdim:
        for d in dims:
            out = out.unsqueeze(d + qt.dim())
    return out


@register_op("median")
def _median(x, *, axis, keepdim):
    return _quantile_dims(x, 0.5, axis, keepdim, nan=False)


def median(x, axis=None, keepdim=False, name=None):
    """The mean of the two middle values for an even count, as numpy's
    (torch.median takes the lower one)."""
    return _median(x, axis=_norm_axis(axis), keepdim=bool(keepdim))


@register_op("quantile")
def _quantile(x, *, q, axis, keepdim):
    return _quantile_dims(x, q, axis, keepdim, nan=False)


def quantile(x, q, axis=None, keepdim=False):
    return _quantile(x, q=float(q) if not isinstance(q, (list, tuple))
                     else tuple(q), axis=_norm_axis(axis),
                     keepdim=bool(keepdim))


@register_op("logsumexp")
def _logsumexp(x, *, axis, keepdim):
    return torch.logsumexp(x, dim=_dims(x, axis), keepdim=keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    return _logsumexp(x, axis=_norm_axis(axis), keepdim=bool(keepdim))


@register_op("count_nonzero", differentiable=False)
def _count_nonzero(x, *, axis, keepdim):
    out = (x != 0).sum(dim=_dims(x, axis), keepdim=keepdim)
    return out


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return _count_nonzero(x, axis=_norm_axis(axis), keepdim=bool(keepdim))


@register_op("p_norm")
def _p_norm(x, *, p, axis, keepdim):
    dims = _dims(x, axis)
    if p == float("inf"):
        return torch.amax(x.abs(), dim=dims, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(x.abs(), dim=dims, keepdim=keepdim)
    return (x.abs() ** p).sum(dim=dims, keepdim=keepdim) ** (1.0 / p)


@register_op("frobenius_norm")
def _fro_norm(x, *, axis, keepdim):
    return torch.sqrt(torch.square(x).sum(dim=_dims(x, axis),
                                          keepdim=keepdim))


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    """paddle.linalg.norm subset: fro, p-norms along axis."""
    if p == "fro":
        ax = _norm_axis(axis)
        if isinstance(ax, int):
            ax = (ax,)
        return _fro_norm(x, axis=ax, keepdim=bool(keepdim))
    return _p_norm(x, p=float(p), axis=_norm_axis(axis),
                   keepdim=bool(keepdim))


def dist(x, y, p=2.0):
    from . import math as math_ops
    return norm(math_ops.subtract(x, y), p=float(p))


@register_op("nanmedian_op", differentiable=False)
def _nanmedian(x, *, axis, keepdim):
    return _quantile_dims(x, 0.5, axis, keepdim, nan=True)


def nanmedian(x, axis=None, keepdim=False, name=None):
    ax = tuple(axis) if isinstance(axis, (list, tuple)) \
        else (None if axis is None else int(axis))
    return _nanmedian(x, axis=ax, keepdim=bool(keepdim))


@register_op("nanquantile_op", differentiable=False)
def _nanquantile(x, *, q, axis, keepdim):
    return _quantile_dims(x, q, axis, keepdim, nan=True)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    ax = None if axis is None else int(axis)
    return _nanquantile(x, q=tuple(q) if isinstance(q, (list, tuple))
                        else float(q), axis=ax, keepdim=bool(keepdim))
