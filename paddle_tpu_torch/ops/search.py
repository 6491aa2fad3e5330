"""Search and sort ops (a port of ``paddle_tpu/ops/search.py``).

Index outputs are int64, as the reference's (``topk``, ``argmax``,
``argsort``, ``kthvalue``), except ``searchsorted``/``bucketize``, whose
default is the reference's int32. ``sort`` and ``argsort`` are stable,
as ``jnp.sort``/``jnp.argsort`` are, so ties keep their order.
``nonzero``, ``unique`` and ``bincount`` have data-dependent output
shapes and read the data on the host, as the reference's do.
"""
import torch

from ..core.dispatch import register_op
from ..core.tensor import Tensor


def _arg(fn, x, axis, keepdim):
    if axis is None:
        return fn(x.reshape(-1))
    return fn(x, dim=axis, keepdim=keepdim)


@register_op("arg_max", differentiable=False)
def _argmax(x, *, axis, keepdim):
    return _arg(torch.argmax, x, axis, keepdim)


@register_op("arg_min", differentiable=False)
def _argmin(x, *, axis, keepdim):
    return _arg(torch.argmin, x, axis, keepdim)


def _index_dtype(out, dtype):
    from .math import cast
    return out if dtype in ("int64", None) else cast(out, dtype)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    out = _argmax(x, axis=axis if axis is None else int(axis),
                  keepdim=bool(keepdim))
    return _index_dtype(out, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    out = _argmin(x, axis=axis if axis is None else int(axis),
                  keepdim=bool(keepdim))
    return _index_dtype(out, dtype)


@register_op("top_k_v2")
def _topk(x, *, k, axis, largest):
    # lax.top_k's order: tied values in index order, which torch.topk
    # does not keep; a stable sort does
    vals, idx = torch.sort(x, dim=axis, descending=largest, stable=True)
    return vals.narrow(axis, 0, k), idx.narrow(axis, 0, k)


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):  # noqa: A002
    """``(values, int64 indices)`` of the ``k`` largest (or smallest)
    along ``axis``, always sorted, as the reference's ``lax.top_k``."""
    if isinstance(k, Tensor):
        k = int(k.item())
    return _topk(x, k=int(k), axis=int(axis), largest=bool(largest))


@register_op("argsort", differentiable=False)
def _argsort(x, *, axis, descending):
    return torch.sort(x, dim=axis, descending=descending, stable=True)[1]


def argsort(x, axis=-1, descending=False, name=None):
    return _argsort(x, axis=int(axis), descending=bool(descending))


@register_op("sort")
def _sort(x, *, axis, descending):
    return torch.sort(x, dim=axis, descending=descending, stable=True)[0]


def sort(x, axis=-1, descending=False, name=None):
    return _sort(x, axis=int(axis), descending=bool(descending))


def nonzero(x, as_tuple=False):
    """The indices of ``x``'s nonzero elements: ``[n, ndim]`` int64, or
    with ``as_tuple`` one int64 tensor a dim."""
    v = x._value.detach()
    if as_tuple:
        return tuple(Tensor._wrap(i) for i in torch.nonzero(v,
                                                            as_tuple=True))
    return Tensor._wrap(torch.nonzero(v))


@register_op("searchsorted", differentiable=False)
def _searchsorted(sorted_seq, values, *, right):
    return torch.searchsorted(sorted_seq, values, right=right).to(
        torch.int32)


def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    """int32 indices whatever ``out_int32`` says: the reference's
    ``jnp.searchsorted`` gives int32."""
    return _searchsorted(sorted_sequence, values, right=bool(right))


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """The sorted unique values (along ``axis``), with the int64 index of
    each one's first occurrence, the inverse and the counts when asked
    for."""
    v = x._value.detach()
    if axis is None:
        v = v.reshape(-1)
        dim = 0
    else:
        dim = int(axis)
    vals, inv, counts = torch.unique(v, sorted=True, return_inverse=True,
                                     return_counts=True, dim=dim)
    if not (return_index or return_inverse or return_counts):
        return Tensor._wrap(vals)
    out = [vals]
    if return_index:
        n = v.shape[dim]
        first = torch.full((vals.shape[dim],), n, dtype=torch.int64,
                           device=v.device)
        first.scatter_reduce_(0, inv, torch.arange(n, device=v.device),
                              "amin")
        out.append(first)
    if return_inverse:
        out.append(inv.reshape(x._v.shape) if axis is None else inv)
    if return_counts:
        out.append(counts)
    return tuple(Tensor._wrap(r) for r in out)


@register_op("kthvalue")
def _kthvalue(x, *, k, axis, keepdim):
    vals, idxs = torch.sort(x, dim=axis, stable=True)
    take = vals.narrow(axis, k - 1, 1)
    take_i = idxs.narrow(axis, k - 1, 1)
    if not keepdim:
        take, take_i = take.squeeze(axis), take_i.squeeze(axis)
    return take, take_i


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """``(value, int64 index)`` of the k-th smallest along ``axis``; of
    tied values, the first in order."""
    return _kthvalue(x, k=int(k), axis=int(axis), keepdim=bool(keepdim))


@register_op("mode")
def _mode(x, *, axis, keepdim):
    moved = torch.sort(x, dim=axis, stable=True)[0].movedim(axis, -1)
    flat = moved.reshape(-1, moved.shape[-1])
    # each element's count in its row; the first largest count is the
    # smallest of the most frequent values, as jnp.unique_counts+argmax
    counts = (flat[:, :, None] == flat[:, None, :]).sum(-1)
    pick = counts.argmax(-1, keepdim=True)
    out = flat.gather(1, pick).reshape(moved.shape[:-1])
    if keepdim:
        out = out.unsqueeze(axis)
    return out


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest of a tie);
    values only, as the reference's."""
    return _mode(x, axis=int(axis), keepdim=bool(keepdim))


def masked_select(x, mask, name=None):
    from . import manipulation
    return manipulation.masked_select(x, mask)


def index_sample(x, index):
    from . import manipulation
    return manipulation.index_sample(x, index)


def where(condition, x=None, y=None, name=None):
    from . import manipulation
    return manipulation.where(condition, x, y, name)


@register_op("bincount_op", differentiable=False)
def _bincount(x, weights, *, length):
    out = torch.bincount(x, weights=weights, minlength=length)
    return out if weights is None else out.to(weights.dtype)


def bincount(x, weights=None, minlength=0, name=None):
    """Reference operators/bincount_op: ``max(max(x) + 1, minlength)``
    bins, read from the data."""
    v = x._value
    n = int(v.max()) + 1 if v.numel() else 0
    return _bincount(x, weights, length=max(n, int(minlength)))


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    """The bucket of each element (``searchsorted`` the other way
    round)."""
    return searchsorted(sorted_sequence, x, out_int32=out_int32,
                        right=right)
