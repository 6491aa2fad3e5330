"""Tensor creation ops (a port of ``paddle_tpu/ops/creation.py``).

Every creator puts its result on the current device (``get_place()``:
the card unless ``set_device`` says otherwise), as ``to_tensor`` does.
The dtype rules are the reference's: ``zeros``/``ones``/``full`` default
to float32, ``arange`` is int64 when every bound is an int and float32
otherwise (:111-123).

The random creators draw from an explicit ``torch.Generator``: the
``generator`` argument, or the port's default generator for the device
(``core/rng.default_generator``, which ``paddle_tpu_torch.seed``
reseeds), never torch's global one. The reference draws from
``jax.random`` keys, so the same seed gives the port's own numbers, not
the reference's; the distributions, shapes and dtypes are the same.
"""
import builtins as _builtins

import numpy as np
import torch

from ..core import device as device_mod
from ..core import dtype as dtype_mod
from ..core import rng as rng_mod
from ..core.dispatch import register_op
from ..core.tensor import Tensor


def _norm_shape(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _tdt(dtype, default="float32"):
    return dtype_mod.to_torch_dtype(dtype if dtype is not None else default)


def _device():
    return device_mod.resolve_device()


def _gen(generator, dev):
    return generator if generator is not None \
        else rng_mod.default_generator(dev)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.to_tensor``: python floats and float lists default to
    float32, python ints to int64, numpy arrays keep their dtype; the
    data lands on ``place`` (default: the current device, the card
    unless ``set_device`` says otherwise)."""
    if isinstance(data, Tensor):
        data = data._value
    if dtype is None:
        if isinstance(data, (int, np.integer)) \
                and not isinstance(data, (_builtins.bool, np.bool_)):
            dtype = "int64"
        elif isinstance(data, float):
            dtype = "float32"
        elif isinstance(data, (list, tuple)) \
                and np.asarray(data).dtype == np.float64:
            dtype = "float32"
    return Tensor(data, dtype=dtype,
                  place=place if place is not None
                  else device_mod.get_place(),
                  stop_gradient=stop_gradient)


def zeros(shape, dtype=None, name=None):
    return Tensor._wrap(torch.zeros(_norm_shape(shape), dtype=_tdt(dtype),
                                    device=_device()))


def ones(shape, dtype=None, name=None):
    return Tensor._wrap(torch.ones(_norm_shape(shape), dtype=_tdt(dtype),
                                   device=_device()))


def full(shape, fill_value, dtype=None, name=None):
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    return Tensor._wrap(torch.full(_norm_shape(shape), fill_value,
                                   dtype=_tdt(dtype), device=_device()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


@register_op("zeros_like", differentiable=False)
def _zeros_like(x, *, dtype):
    return torch.zeros_like(x, dtype=dtype)


@register_op("ones_like", differentiable=False)
def _ones_like(x, *, dtype):
    return torch.ones_like(x, dtype=dtype)


@register_op("full_like", differentiable=False)
def _full_like(x, *, fill_value, dtype):
    return torch.full_like(x, fill_value, dtype=dtype)


def _like_dtype(dtype):
    return dtype_mod.to_torch_dtype(dtype) if dtype else None


def zeros_like(x, dtype=None, name=None):
    return _zeros_like(x, dtype=_like_dtype(dtype))


def ones_like(x, dtype=None, name=None):
    return _ones_like(x, dtype=_like_dtype(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return _full_like(x, fill_value=float(fill_value),
                      dtype=_like_dtype(dtype))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    if end is None:
        start, end = 0, start
    for v in (start, end, step):
        if isinstance(v, Tensor):
            raise TypeError("arange with Tensor bounds not supported")
    if dtype is None:
        dtype = ("float32" if any(isinstance(v, float)
                                  for v in (start, end, step)) else "int64")
    return Tensor._wrap(torch.arange(start, end, step, dtype=_tdt(dtype),
                                     device=_device()))


def linspace(start, stop, num, dtype=None, name=None):
    """Computed in float64 and rounded once to ``dtype``."""
    v = torch.linspace(float(start), float(stop), int(num),
                       dtype=torch.float64)
    return Tensor._wrap(v.to(device=_device(), dtype=_tdt(dtype)))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    v = torch.logspace(float(start), float(stop), int(num), base=float(base),
                       dtype=torch.float64)
    return Tensor._wrap(v.to(device=_device(), dtype=_tdt(dtype)))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    m = int(num_columns) if num_columns is not None else int(num_rows)
    return Tensor._wrap(torch.eye(int(num_rows), m, dtype=_tdt(dtype),
                                  device=_device()))


@register_op("tril")
def _tril(x, *, diagonal):
    return torch.tril(x, diagonal)


@register_op("triu")
def _triu(x, *, diagonal):
    return torch.triu(x, diagonal)


def tril(x, diagonal=0, name=None):
    return _tril(x, diagonal=int(diagonal))


def triu(x, diagonal=0, name=None):
    return _triu(x, diagonal=int(diagonal))


@register_op("diag")
def _diag(x, *, offset, padding_value):
    if x.dim() == 1:
        out = torch.diag(x, offset)
        if padding_value != 0:
            mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
            out = torch.where(mask, out, torch.tensor(
                padding_value, dtype=out.dtype, device=out.device))
        return out
    return torch.diagonal(x, offset)


def diag(x, offset=0, padding_value=0, name=None):
    return _diag(x, offset=int(offset), padding_value=padding_value)


def diagflat(x, offset=0, name=None):
    from . import manipulation
    return diag(manipulation.flatten(x), offset=offset)


def assign(x, output=None):
    """``paddle.assign``: a new tensor holding ``x``'s values (not
    differentiable, as in the reference), or ``output`` set to them."""
    if output is None:
        return Tensor(x, place=device_mod.get_place()
                      if not isinstance(x, (Tensor, torch.Tensor)) else None)
    output.set_value(x)
    return output


def clone(x, name=None):
    from . import math as math_ops
    return math_ops.clone(x)


# ---- random ---------------------------------------------------------------

def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0,  # noqa: A002
            name=None, generator=None):
    """Uniform in ``[min, max)``, drawn in f32 and cast to ``dtype``.
    ``seed`` is taken and, as in the reference, not read."""
    dev = _device()
    v = torch.rand(_norm_shape(shape), generator=_gen(generator, dev),
                   device=dev)
    v = v * (float(max) - float(min)) + float(min)
    return Tensor._wrap(v.to(_tdt(dtype)))


def rand(shape, dtype=None, name=None, generator=None):
    return uniform(shape, dtype, 0.0, 1.0, generator=generator)


def _normal(shape, dtype, mean, std, generator):
    dev = _device()
    v = torch.randn(_norm_shape(shape), generator=_gen(generator, dev),
                    device=dev)
    return Tensor._wrap((v * float(std) + float(mean)).to(_tdt(dtype)))


def normal(mean=0.0, std=1.0, shape=None, name=None, generator=None):
    return _normal(shape, None, mean, std, generator)


def randn(shape, dtype=None, name=None, generator=None):
    return _normal(shape, dtype, 0.0, 1.0, generator)


def standard_normal(shape, dtype=None, name=None, generator=None):
    """``randn`` under Paddle's ``standard_normal`` name."""
    return randn(shape, dtype=dtype, generator=generator)


def randint(low=0, high=None, shape=(1,), dtype=None, name=None,
            generator=None):
    if high is None:
        low, high = 0, low
    dev = _device()
    return Tensor._wrap(torch.randint(
        int(low), int(high), _norm_shape(shape),
        generator=_gen(generator, dev), device=dev,
        dtype=_tdt(dtype, "int64")))


def randperm(n, dtype="int64", name=None, generator=None):
    dev = _device()
    return Tensor._wrap(torch.randperm(
        int(n), generator=_gen(generator, dev), device=dev).to(
        _tdt(dtype, "int64")))


@register_op("bernoulli", differentiable=False)
def _bernoulli(x, *, generator):
    return torch.bernoulli(x, generator=_gen(generator, x.device))


def bernoulli(x, name=None, generator=None):
    """0/1 draws of ``x``'s dtype with probabilities ``x``, on ``x``'s
    device."""
    return _bernoulli(x, generator=generator)


@register_op("multinomial", differentiable=False)
def _multinomial(x, *, num_samples, replacement, generator):
    return torch.multinomial(x.float(), num_samples, replacement,
                             generator=_gen(generator, x.device))


def multinomial(x, num_samples=1, replacement=False, name=None,
                generator=None):
    """``num_samples`` int64 category indices per row of the weights
    ``x`` (not necessarily normalized), on ``x``'s device."""
    return _multinomial(x, num_samples=int(num_samples),
                        replacement=bool(replacement), generator=generator)


def rand_like(x, dtype=None, generator=None):
    """Uniform ``[0, 1)`` of ``x``'s shape and (default) dtype, on
    ``x``'s device."""
    dev = x._v.device
    v = torch.rand(x._v.shape, generator=_gen(generator, dev),
                   device=dev)
    return Tensor._wrap(v.to(_tdt(dtype) if dtype is not None
                             else x._v.dtype))


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """Reference ``ops/creation.py:282`` (fluid ``create_parameter``):
    ``default_initializer``, else ``attr``'s initializer, else zeros
    for a bias and ``XavierUniform`` for a weight; on the current
    device."""
    from ..core.tensor import Parameter
    from ..nn import initializer as init_mod
    init = default_initializer
    if init is None and attr is not None \
            and getattr(attr, "initializer", None):
        init = attr.initializer
    if init is None:
        init = init_mod.Constant(0.0) if is_bias else init_mod.XavierUniform()
    val = init(tuple(int(s) for s in shape), dtype or "float32")
    return Parameter._own(val, name=name)
