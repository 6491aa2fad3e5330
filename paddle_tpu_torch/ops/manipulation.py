"""Shape and layout manipulation ops (a port of
``paddle_tpu/ops/manipulation.py``).

Each op is a torch function registered with the core's dispatcher under
the reference's name. Paddle's conventions are kept: ``reshape`` reads 0
as "copy this input dim" (``_resolve_reshape``), ``split`` takes
sections with one -1, ``squeeze`` on an axis whose size is not 1 leaves
it, ``where(cond)`` is ``nonzero(cond, as_tuple=True)``.

``reshape``, ``transpose``, ``unbind``, ``expand`` and the like return
torch views where torch can, as Paddle's do; the reference's arrays are
immutable, so a write into one result (``set_value``, ``x[i] = v``) is
seen by its source here and not there. The in-place variants
(``reshape_``, ``squeeze_``, ...) swap the tensor's value without
recording, as the reference's ``x.value = ...`` does.
"""
import builtins

import numpy as np
import torch

from ..core.dispatch import register_op
from ..core.errors import InvalidArgumentError
from ..core.tensor import Tensor


def _shape_tuple(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    return tuple(int(s) for s in shape)


def _swap_value(x, new):
    """Put ``new`` (any shape) into ``x`` untracked; a leaf keeps
    requiring grad."""
    rg = x._value.requires_grad and x._value.is_leaf
    new = new.detach()
    if rg:
        new.requires_grad_(True)
    x._rebind(new)
    return x


@register_op("reshape")
def _reshape(x, *, shape):
    return x.reshape(shape)


def _resolve_reshape(x, shape):
    """Reference reshape_op semantics: a 0 entry copies the input dim
    at the same position; -1 is inferred as usual."""
    tgt = list(_shape_tuple(shape))
    in_shape = tuple(x.shape)
    for i, d in enumerate(tgt):
        if d == 0:
            if i >= len(in_shape):
                raise InvalidArgumentError(
                    f"reshape: 0 at position {i} has no corresponding "
                    f"input dim (input rank {len(in_shape)})")
            tgt[i] = in_shape[i]
    return tuple(tgt)


def reshape(x, shape, name=None):
    return _reshape(x, shape=_resolve_reshape(x, shape))


def reshape_(x, shape, name=None):
    return _swap_value(x, x._value.reshape(_resolve_reshape(x, shape)))


@register_op("transpose2")
def _transpose(x, *, perm):
    return x.permute(perm)


def transpose(x, perm, name=None):
    return _transpose(x, perm=tuple(int(p) for p in perm))


@register_op("t_op")
def _t(x):
    # jnp's .T: every axis reversed
    return x.permute(tuple(range(x.dim() - 1, -1, -1)))


def t(x, name=None):
    return _t(x)


@register_op("flatten2")
def _flatten(x, *, start_axis, stop_axis):
    shape = tuple(x.shape)
    nd = x.dim()
    sa = start_axis % nd if nd else 0
    so = stop_axis % nd if nd else 0
    return x.reshape(shape[:sa] + (-1,) + shape[so + 1:])


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return _flatten(x, start_axis=int(start_axis), stop_axis=int(stop_axis))


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return _swap_value(x, _flatten.fn(x._value, start_axis=int(start_axis),
                                      stop_axis=int(stop_axis)))


@register_op("squeeze2")
def _squeeze(x, *, axes):
    if not axes:
        return x.squeeze()
    axes = tuple(a % x.dim() for a in axes if x.shape[a] == 1)
    return x.squeeze(axes) if axes else x


def _axes(axis):
    if axis is None:
        return ()
    if isinstance(axis, (int, np.integer)):
        return (int(axis),)
    return tuple(int(a) for a in axis)


def squeeze(x, axis=None, name=None):
    return _squeeze(x, axes=_axes(axis))


def squeeze_(x, axis=None, name=None):
    return _swap_value(x, _squeeze.fn(x._value, axes=_axes(axis)))


@register_op("unsqueeze2")
def _unsqueeze(x, *, axes):
    for a in sorted(axes):
        x = x.unsqueeze(a)
    return x


def unsqueeze(x, axis, name=None):
    return _unsqueeze(x, axes=_axes(axis))


def unsqueeze_(x, axis, name=None):
    return _swap_value(x, _unsqueeze.fn(x._value, axes=_axes(axis)))


@register_op("concat")
def _concat(*xs, axis):
    return torch.cat(xs, dim=axis)


def concat(x, axis=0, name=None):
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    return _concat(*x, axis=int(axis))


@register_op("stack")
def _stack(*xs, axis):
    return torch.stack(xs, dim=axis)


def stack(x, axis=0, name=None):
    return _stack(*x, axis=int(axis))


@register_op("split")
def _split(x, *, sections, axis):
    if isinstance(sections, int):
        n = x.shape[axis]
        if n % sections:
            raise ValueError(f"split: dim {axis} of size {n} does not "
                             f"divide into {sections} equal sections")
        return tuple(torch.split(x, n // sections, dim=axis))
    return tuple(torch.split(x, list(sections), dim=axis))


def split(x, num_or_sections, axis=0, name=None):
    """``num_or_sections``: a count of equal sections, or their sizes,
    one of which may be -1 (the rest of the dim)."""
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    if isinstance(num_or_sections, int):
        sections = int(num_or_sections)
    else:
        secs = [int(s) for s in num_or_sections]
        total = x.shape[int(axis)]
        neg = [i for i, s in enumerate(secs) if s < 0]
        if neg:
            known = sum(s for s in secs if s >= 0)
            secs[neg[0]] = total - known
        sections = tuple(secs)
    return list(_split(x, sections=sections, axis=int(axis)))


def chunk(x, chunks, axis=0, name=None):
    return split(x, int(chunks), axis)


@register_op("unbind")
def _unbind(x, *, axis):
    return tuple(torch.unbind(x, dim=axis))


def unbind(x, axis=0):
    return list(_unbind(x, axis=int(axis)))


def unstack(x, axis=0, num=None):
    return unbind(x, axis)


def _take_slice(x, ax, st, en, sd):
    # builtins.slice: this module's own ``slice`` is the Paddle op (the
    # reference's _slice calls that one and raises, manipulation.py:176)
    if sd > 0:
        idx = [builtins.slice(None)] * x.dim()
        idx[ax] = builtins.slice(st, en, sd)
        return x[tuple(idx)]
    # torch slices take no negative step: the python indices, gathered
    rows = list(range(*builtins.slice(st, en, sd).indices(x.shape[ax])))
    return x.index_select(ax, torch.tensor(rows, dtype=torch.long,
                                           device=x.device))


@register_op("slice")
def _slice(x, *, axes, starts, ends, strides):
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        x = _take_slice(x, ax, st, en, sd)
    return x


def slice(x, axes, starts, ends, name=None):  # noqa: A001
    starts = [int(s.item()) if isinstance(s, Tensor) else int(s)
              for s in starts]
    ends = [int(e.item()) if isinstance(e, Tensor) else int(e) for e in ends]
    return _slice(x, axes=tuple(int(a) for a in axes), starts=tuple(starts),
                  ends=tuple(ends), strides=(1,) * len(axes))


def strided_slice(x, axes, starts, ends, strides, name=None):
    return _slice(x, axes=tuple(int(a) for a in axes),
                  starts=tuple(int(s) for s in starts),
                  ends=tuple(int(e) for e in ends),
                  strides=tuple(int(s) for s in strides))


def _take(x, index, axis):
    """``jnp.take(x, index, axis)`` for in-range indices: the result's
    ``axis`` replaced by ``index``'s shape."""
    axis = axis % x.dim()
    flat = x.index_select(axis, index.reshape(-1).long())
    return flat.reshape(tuple(x.shape[:axis]) + tuple(index.shape)
                        + tuple(x.shape[axis + 1:]))


@register_op("gather")
def _gather(x, index, *, axis):
    if index.dim() == 0:
        index = index[None]
    return _take(x, index, axis)


def gather(x, index, axis=0, name=None):
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    return _gather(x, index, axis=int(axis))


def _nd_index(index):
    return tuple(index.long().movedim(-1, 0))


@register_op("gather_nd")
def _gather_nd(x, index):
    return x[_nd_index(index)]


def gather_nd(x, index, name=None):
    return _gather_nd(x, index)


@register_op("take_along_axis")
def _take_along_axis(x, index, *, axis):
    return torch.take_along_dim(x, index.long(), dim=axis)


def take_along_axis(x, indices, axis, name=None):
    return _take_along_axis(x, indices, axis=int(axis))


@register_op("put_along_axis")
def _put_along_axis(x, index, value, *, axis, reduce):
    index = index.long()
    value_b = torch.broadcast_to(value, index.shape).to(x.dtype)
    if reduce == "assign":
        return x.scatter(axis, index, value_b)
    if reduce == "add":
        return x.scatter_add(axis, index, value_b)
    if reduce in ("mul", "multiply"):
        return x.scatter_reduce(axis, index, value_b, "prod")
    raise ValueError(reduce)


def put_along_axis(x, indices, values, axis, reduce="assign"):
    if not isinstance(values, Tensor):
        values = Tensor._wrap(torch.as_tensor(
            np.asarray(values), device=x._value.device).to(x._value.dtype))
    return _put_along_axis(x, indices, values, axis=int(axis), reduce=reduce)


@register_op("index_select")
def _index_select(x, index, *, axis):
    return _take(x, index, axis)


def index_select(x, index, axis=0, name=None):
    return _index_select(x, index, axis=int(axis))


@register_op("index_sample")
def _index_sample(x, index):
    return torch.take_along_dim(x, index.long(), dim=1)


def index_sample(x, index):
    return _index_sample(x, index)


@register_op("scatter")
def _scatter(x, index, updates, *, overwrite):
    if index.dim() == 2:
        index = index[:, 0]
    index = (index.long(),)
    if overwrite:
        return x.index_put(index, updates)
    # overwrite=False sums duplicates after zeroing the rows
    zeroed = x.index_put(index, torch.zeros_like(updates))
    return zeroed.index_put(index, updates, accumulate=True)


def scatter(x, index, updates, overwrite=True, name=None):
    return _scatter(x, index, updates, overwrite=bool(overwrite))


def scatter_(x, index, updates, overwrite=True, name=None):
    return _swap_value(x, scatter(x, index, updates, overwrite)._value)


@register_op("scatter_nd_add")
def _scatter_nd_add(x, index, updates):
    return x.index_put(_nd_index(index), updates, accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    return _scatter_nd_add(x, index, updates)


@register_op("scatter_nd")
def _scatter_nd(index, updates, *, shape):
    zeros = torch.zeros(shape, dtype=updates.dtype, device=updates.device)
    return zeros.index_put(_nd_index(index), updates, accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    """Reference scatter_nd_add_op over a zero base."""
    return _scatter_nd(index, updates, shape=_shape_tuple(shape))


@register_op("tile")
def _tile(x, *, repeat_times):
    return x.tile(repeat_times)


def tile(x, repeat_times, name=None):
    return _tile(x, repeat_times=_shape_tuple(repeat_times))


@register_op("expand_v2")
def _expand(x, *, shape):
    offset = len(shape) - x.dim()
    full = []
    for i, s in enumerate(shape):
        if s == -1:
            full.append(x.shape[i - offset] if i >= offset else 1)
        else:
            full.append(s)
    return torch.broadcast_to(x, tuple(full))


def expand(x, shape, name=None):
    return _expand(x, shape=_shape_tuple(shape))


def expand_as(x, y, name=None):
    return _expand(x, shape=tuple(y.shape))


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


@register_op("broadcast_tensors")
def _broadcast_tensors(*xs):
    return tuple(torch.broadcast_tensors(*xs))


def broadcast_tensors(inputs, name=None):
    return list(_broadcast_tensors(*inputs))


@register_op("flip")
def _flip(x, *, axis):
    return torch.flip(x, axis)


def flip(x, axis, name=None):
    return _flip(x, axis=_axes(axis))


@register_op("reverse")
def _reverse(x, *, axis):
    return torch.flip(x, axis)


def reverse(x, axis, name=None):
    return _reverse(x, axis=_axes(axis))


@register_op("roll")
def _roll(x, *, shifts, axis):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


def roll(x, shifts, axis=None, name=None):
    if isinstance(shifts, (list, tuple)):
        shifts = tuple(int(s) for s in shifts)
    else:
        shifts = int(shifts)
    if axis is not None:
        axis = tuple(int(a) for a in axis) \
            if isinstance(axis, (list, tuple)) else int(axis)
    return _roll(x, shifts=shifts, axis=axis)


@register_op("rot90")
def _rot90(x, *, k, axes):
    return torch.rot90(x, k, axes)


def rot90(x, k=1, axes=(0, 1)):
    return _rot90(x, k=int(k), axes=tuple(axes))


@register_op("repeat_interleave")
def _repeat_interleave(x, *, repeats, axis):
    return torch.repeat_interleave(x, repeats, dim=axis)


def repeat_interleave(x, repeats, axis=None, name=None):
    return _repeat_interleave(x, repeats=int(repeats),
                              axis=None if axis is None else int(axis))


_NP_PAD_MODES = {"reflect": "reflect", "replicate": "edge",
                 "circular": "wrap"}


@register_op("pad3d")
def _pad(x, *, paddings, mode, value):
    if mode == "constant":
        flat = []
        for lo, hi in reversed(paddings):
            flat += [lo, hi]
        return torch.nn.functional.pad(x, flat, value=value)
    # the other modes gather along each padded dim the rows np.pad picks
    np_mode = _NP_PAD_MODES[mode]
    for d, (lo, hi) in enumerate(paddings):
        if lo or hi:
            rows = np.pad(np.arange(x.shape[d]), (lo, hi), mode=np_mode)
            x = x.index_select(d, torch.as_tensor(rows, device=x.device))
    return x


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",  # noqa: A002
        name=None):
    """``paddle.nn.functional.pad``: ``pad`` is [left, right, top,
    bottom, ...] pairs on the trailing dims (NCHW-style, the last dim
    first) or on the spatial dims of a channels-last layout, or one pair
    for every dim."""
    if isinstance(pad, int):  # a scalar pads every spatial dim
        pad = [pad] * (2 * max(x.ndim - 2, 1))
    pad = [int(p) for p in (pad.tolist() if isinstance(pad, Tensor)
                            else pad)]
    nd = x.ndim
    if len(pad) == 2 * nd:
        paddings = tuple((pad[2 * i], pad[2 * i + 1]) for i in range(nd))
    else:
        npairs = len(pad) // 2
        paddings = [(0, 0)] * nd
        if data_format.endswith("C") and nd >= 3:
            dims = range(1, 1 + npairs)
        else:
            dims = range(nd - 1, nd - 1 - npairs, -1)
        for i, d in enumerate(dims):
            paddings[d] = (pad[2 * i], pad[2 * i + 1])
        paddings = tuple(paddings)
    return _pad(x, paddings=paddings, mode=mode, value=float(value))


@register_op("where_op")
def _where(cond, x, y):
    return torch.where(cond.bool(), x, y)


def where(condition, x=None, y=None, name=None):
    """``where(cond, x, y)``; with ``cond`` alone, its nonzero indices
    as a tuple of int64 tensors, one per dim."""
    if x is None and y is None:
        from . import search
        return search.nonzero(condition, as_tuple=True)
    return _where(condition, x, y)


def masked_select(x, mask, name=None):
    """The elements of ``x`` where ``mask`` is set, as a 1-D tensor: a
    new tensor, not differentiable, as in the reference (its output's
    size depends on the data)."""
    return Tensor._wrap(x._value.detach()[mask._value.bool()])


def masked_fill(x, mask, value, name=None):
    if isinstance(value, Tensor):
        value = value.item()
    fill = Tensor._wrap(torch.tensor(value, dtype=x._value.dtype,
                                     device=x._value.device))
    return _where(mask, fill, x)


@register_op("meshgrid")
def _meshgrid(*xs):
    return tuple(torch.meshgrid(*xs, indexing="ij"))


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(_meshgrid(*args))


@register_op("shard_index", differentiable=False)
def _shard_index(x, *, index_num, nshards, shard_id, ignore_value):
    shard_size = (index_num + nshards - 1) // nshards
    lo = shard_id * shard_size
    hi = lo + shard_size
    in_shard = (x >= lo) & (x < hi)
    return torch.where(in_shard, x - lo, torch.full_like(x, ignore_value))


def shard_index(input, index_num, nshards, shard_id,  # noqa: A002
                ignore_value=-1):
    """Reference operators/shard_index_op (the vocab sharding of tensor
    parallelism)."""
    return _shard_index(input, index_num=int(index_num), nshards=int(nshards),
                        shard_id=int(shard_id),
                        ignore_value=int(ignore_value))


def numel(x):
    """The element count as an int64 0-d tensor on ``x``'s device."""
    return Tensor._wrap(torch.tensor(x._value.numel(), dtype=torch.int64,
                                     device=x._value.device))


def shape(x):
    """The shape as an int32 tensor on ``x``'s device."""
    return Tensor._wrap(torch.tensor(list(x._value.shape),
                                     dtype=torch.int32,
                                     device=x._value.device))


@register_op("unfold")
def _unfold(x, *, kernel_sizes, strides, paddings, dilations):
    n, c, h, w = x.shape
    kh, kw = kernel_sizes
    sh, sw = strides
    ph, pw = paddings
    dh, dw = dilations
    x = torch.nn.functional.pad(x, (pw, pw, ph, ph))
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    cols = [x[:, :, i * dh:i * dh + oh * sh:sh, j * dw:j * dw + ow * sw:sw]
            for i in range(kh) for j in range(kw)]
    return torch.stack(cols, dim=2).reshape(n, c * kh * kw, oh * ow)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C * kh * kw, L]``, the columns in (channel, kernel
    row, kernel column) order (reference manipulation.py:484-513)."""
    def _p(v):
        return (v, v) if isinstance(v, int) else tuple(v)
    return _unfold(x, kernel_sizes=_p(kernel_sizes), strides=_p(strides),
                   paddings=_p(paddings), dilations=_p(dilations))


@register_op("diagonal")
def _diagonal(x, *, offset, axis1, axis2):
    return torch.diagonal(x, offset, axis1, axis2)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return _diagonal(x, offset=int(offset), axis1=int(axis1),
                     axis2=int(axis2))


@register_op("multiplex")
def _multiplex(index, *xs):
    stacked = torch.stack(xs, dim=0)   # [candidates, batch, ...]
    idx = index.reshape(-1).long()
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[idx, rows]


def multiplex(inputs, index, name=None):
    """Row-wise select among candidate tensors (reference
    operators/multiplex_op.cc)."""
    return _multiplex(index, *inputs)


@register_op("crop_tensor")
def _crop(x, *, offsets, shape):
    for d, (off, size) in enumerate(zip(offsets, shape)):
        # lax.dynamic_slice's rule: the start clamped so the slice fits
        off = max(0, min(off, x.shape[d] - size))
        x = x.narrow(d, off, size)
    return x


def crop(x, shape=None, offsets=None, name=None):
    """Reference operators/crop_tensor_op.cc; a shape entry of -1 (or
    None) takes the rest of the dim from its offset."""
    off = list(_shape_tuple(offsets)) if offsets is not None \
        else [0] * x.ndim
    shp = list(shape) if shape is not None else [-1] * x.ndim
    shp = [x.shape[i] - off[i] if s in (-1, None) else int(s)
           for i, s in enumerate(shp)]
    return _crop(x, offsets=tuple(off), shape=tuple(shp))


crop_tensor = crop


def tolist(x):
    return x.tolist() if isinstance(x, Tensor) else list(x)


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


@register_op("moveaxis_op")
def _moveaxis(x, *, source, destination):
    return torch.movedim(x, source, destination)


def moveaxis(x, source, destination, name=None):
    src = tuple(source) if isinstance(source, (list, tuple)) \
        else int(source)
    dst = tuple(destination) if isinstance(destination, (list, tuple)) \
        else int(destination)
    return _moveaxis(x, source=src, destination=dst)


@register_op("index_add_op")
def _index_add(x, index, value, *, axis):
    return x.index_add(axis, index.long(), value)


def index_add(x, index, axis, value, name=None):
    return _index_add(x, index, value, axis=int(axis))


def index_add_(x, index, axis, value, name=None):
    return _swap_value(x, index_add(x, index, axis, value)._value)


@register_op("index_fill_op")
def _index_fill(x, index, *, axis, fill_value):
    return x.index_fill(axis, index.long(), fill_value)


def index_fill(x, index, axis, value, name=None):
    if isinstance(value, Tensor):
        value = float(value.numpy())
    return _index_fill(x, index, axis=int(axis), fill_value=value)


def index_fill_(x, index, axis, value, name=None):
    return _swap_value(x, index_fill(x, index, axis, value)._value)


@register_op("tensordot_op")
def _tensordot(x, y, *, axes):
    return torch.tensordot(x, y, dims=axes)


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, (list, tuple)):
        a, b = axes
        axes = (list(a) if isinstance(a, (list, tuple)) else [a],
                list(b) if isinstance(b, (list, tuple)) else [b])
    else:
        axes = int(axes)
    return _tensordot(x, y, axes=axes)


@register_op("as_real")
def _as_real(x):
    return torch.stack([x.real, x.imag], dim=-1)


def as_real(x, name=None):
    """Complex ``[...]`` -> float ``[..., 2]`` (reference paddle.as_real)."""
    return _as_real(x)


view_as_real = as_real


@register_op("as_complex")
def _as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


def as_complex(x, name=None):
    return _as_complex(x)


view_as_complex = as_complex
