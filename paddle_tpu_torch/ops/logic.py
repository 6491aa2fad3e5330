"""Comparison and logical ops of the Paddle-style surface (a port of
``paddle_tpu/ops/logic.py``): what the Tensor's comparison and logical
operators call."""
import torch

from ..core.dispatch import register_op
from ..core.tensor import Tensor
from .math import _wrap_scalar


def _on_device_of(x, other):
    """A Python scalar as a 0-d tensor on ``other``'s device, made by a
    fill (which a CUDA graph can capture): torch's logical ops take no
    CPU scalar beside a CUDA tensor, as its comparisons do."""
    v = other._value if isinstance(other, Tensor) else other
    if isinstance(x, (bool, int, float)) and isinstance(v, torch.Tensor) \
            and v.device.type != "cpu":
        return Tensor._wrap(torch.full((), x, dtype=v.dtype,
                                       device=v.device))
    return x


def _cmp(name, fn, scalar_on_device=False):
    op = register_op(name, differentiable=False)(fn)

    def api(x, y, name=None):
        if scalar_on_device:
            x, y = _on_device_of(x, y), _on_device_of(y, x)
        x = _wrap_scalar(x, y)
        y = _wrap_scalar(y, x)
        return op(x, y)
    api.__name__ = name
    return api


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)
logical_and = _cmp("logical_and", torch.logical_and, scalar_on_device=True)
logical_or = _cmp("logical_or", torch.logical_or, scalar_on_device=True)
logical_xor = _cmp("logical_xor", torch.logical_xor, scalar_on_device=True)
bitwise_and = _cmp("bitwise_and", torch.bitwise_and)
bitwise_or = _cmp("bitwise_or", torch.bitwise_or)
bitwise_xor = _cmp("bitwise_xor", torch.bitwise_xor)


@register_op("logical_not", differentiable=False)
def _logical_not(x):
    return torch.logical_not(x)


def logical_not(x, name=None):
    return _logical_not(x)


@register_op("bitwise_not", differentiable=False)
def _bitwise_not(x):
    return torch.bitwise_not(x)


def bitwise_not(x, name=None):
    return _bitwise_not(x)


@register_op("isclose", differentiable=False)
def _isclose(x, y, *, rtol, atol, equal_nan):
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    return _isclose(x, y, rtol=float(rtol), atol=float(atol),
                    equal_nan=bool(equal_nan))


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    from . import reduction
    return reduction.all(isclose(x, y, rtol, atol, equal_nan))


def equal_all(x, y, name=None):
    if tuple(x.shape) != tuple(y.shape):
        return Tensor._wrap(torch.tensor(False))
    from . import reduction
    return reduction.all(equal(x, y))


def is_empty(x, name=None):
    return Tensor._wrap(torch.tensor(x.size == 0))


def is_tensor(x):
    return isinstance(x, Tensor)
