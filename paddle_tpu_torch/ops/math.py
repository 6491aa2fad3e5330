"""Elementwise and general math ops of the Paddle-style surface (a port of
``paddle_tpu/ops/math.py``).

Each op is a pure torch function registered with the core's dispatcher
(``core/dispatch.py``) under the reference's op name; broadcasting
follows numpy's rules, as the reference's elementwise ops with
``axis=-1``. A python scalar operand takes the other operand's dtype
(Paddle's rule, so ``x + 1`` keeps ``x``'s dtype and an int tensor plus
1.5 adds 1).
"""
import math as _pymath

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.dispatch import register_op
from ..core.tensor import Tensor


def _wrap_scalar(x, other):
    """A python (or numpy) scalar as a 0-d tensor of the other operand's
    dtype; a 0-d CPU tensor joins a CUDA operand as a scalar does."""
    if isinstance(x, (Tensor, torch.Tensor)):
        return x
    dt = other._v.dtype if isinstance(other, Tensor) else None
    if dt is None:
        return Tensor._wrap(torch.tensor(np.asarray(x)))
    return Tensor._wrap(torch.tensor(x).to(dt))


def _binary(name, fn, differentiable=True):
    op = register_op(name, differentiable=differentiable)(fn)

    def api(x, y, name=None):
        x = _wrap_scalar(x, y)
        y = _wrap_scalar(y, x)
        return op(x, y)
    api.__name__ = name
    return api


def _unary(name, fn, differentiable=True):
    op = register_op(name, differentiable=differentiable)(fn)

    def api(x, name=None):
        return op(x)
    api.__name__ = name
    return api


def _is_int(x, y):
    return not torch.result_type(x, y).is_floating_point \
        and not torch.result_type(x, y).is_complex


def _trunc_div(x, y):
    """The reference's FloorDivFunctor: C division, toward zero (for
    floats the truncated quotient)."""
    if _is_int(x, y):
        return torch.div(x, y, rounding_mode="trunc")
    return torch.trunc(x / y)


def _ref_divide(x, y):
    """The reference's DivFunctor: integer division for int tensors,
    true division for floats."""
    if _is_int(x, y):
        return _trunc_div(x, y)
    return x / y


add = _binary("elementwise_add", lambda x, y: x + y)
subtract = _binary("elementwise_sub", lambda x, y: x - y)
multiply = _binary("elementwise_mul", lambda x, y: x * y)
divide = _binary("elementwise_div", _ref_divide)
floor_divide = _binary("elementwise_floordiv", _trunc_div,
                       differentiable=False)
remainder = _binary("elementwise_mod", torch.remainder, differentiable=False)
mod = remainder
floor_mod = remainder
maximum = _binary("elementwise_max", torch.maximum)
minimum = _binary("elementwise_min", torch.minimum)
fmax = _binary("elementwise_fmax", torch.fmax)
fmin = _binary("elementwise_fmin", torch.fmin)
pow_ = _binary("elementwise_pow", torch.pow)
atan2 = _binary("atan2", torch.atan2)
hypot = _binary("hypot", torch.hypot)
logaddexp = _binary("logaddexp", torch.logaddexp)
heaviside = _binary("heaviside", torch.heaviside, differentiable=False)
inner = _binary("inner_product", torch.inner)
outer = _binary("outer", torch.outer)
kron = _binary("kron", torch.kron)


@register_op("pow_int")
def _pow_int(x, *, n):
    """``x ** n`` by repeated squaring, the reference's ``integer_pow``
    step for step (so the same products round the same way)."""
    if n == 0:
        return torch.ones_like(x)
    reciprocal_ = n < 0
    n = -n if reciprocal_ else n
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return 1 / acc if reciprocal_ else acc


def _static_int_exponent(base, y):
    """The exponent of the multiply-chain fast path, or None for the
    general power (the reference's ``core/lazy.py::static_int_exponent``
    guards: no bool exponent or base, a float exponent only on a float
    base, no negative exponent on an integer base)."""
    if isinstance(y, bool) or not isinstance(y, (int, float)):
        return None
    dt = base._v.dtype if isinstance(base, Tensor) else torch.float32
    if dt == torch.bool:
        return None
    inexact = dt.is_floating_point or dt.is_complex
    fy = float(y)
    if not fy.is_integer() or not -64 <= fy <= 64:
        return None
    n = int(fy)
    if not inexact and (n < 0 or isinstance(y, float)):
        return None
    return n


def pow(x, y, name=None):  # noqa: A001
    """``x ** y``; a static integer exponent is a multiply chain, as in
    the reference (its TPU pow would make even ``x ** 2`` inexact)."""
    n = _static_int_exponent(x, y)
    if n is not None:
        return _pow_int(x, n=n)
    return pow_(x, y)


_divide_no_nan = register_op("divide_no_nan")(
    lambda x, y: torch.where(y == 0, torch.zeros_like(x),
                             x / torch.where(y == 0, torch.ones_like(y), y)))


def divide_no_nan(x, y):
    return _divide_no_nan(x, y)


def _round_half_away(x):
    # std::round: half away from zero (torch.round is half to even)
    frac_ = x - torch.trunc(x)
    return torch.where(frac_.abs() == 0.5, torch.trunc(x) + torch.sign(x),
                       torch.round(x))


abs = _unary("abs", torch.abs)  # noqa: A001
neg = _unary("neg", torch.neg)
negative = neg
exp = _unary("exp", torch.exp)
expm1 = _unary("expm1", torch.expm1)
log = _unary("log", torch.log)
log2 = _unary("log2", torch.log2)
log10 = _unary("log10", torch.log10)
log1p = _unary("log1p", torch.log1p)
sqrt = _unary("sqrt", torch.sqrt)
rsqrt = _unary("rsqrt", torch.rsqrt)
square = _unary("square", torch.square)
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)
tan = _unary("tan", torch.tan)
asin = _unary("asin", torch.asin)
acos = _unary("acos", torch.acos)
atan = _unary("atan", torch.atan)
sinh = _unary("sinh", torch.sinh)
cosh = _unary("cosh", torch.cosh)
tanh = _unary("tanh", torch.tanh)
asinh = _unary("asinh", torch.asinh)
acosh = _unary("acosh", torch.acosh)
atanh = _unary("atanh", torch.atanh)
floor = _unary("floor", torch.floor, differentiable=False)
ceil = _unary("ceil", torch.ceil, differentiable=False)
round = _unary("round", _round_half_away, differentiable=False)  # noqa: A001
trunc = _unary("trunc", torch.trunc, differentiable=False)
frac = _unary("frac", lambda x: x - torch.trunc(x))
sign = _unary("sign", torch.sign, differentiable=False)
reciprocal = _unary("reciprocal", torch.reciprocal)
erf = _unary("erf", torch.erf)
erfinv = _unary("erfinv", torch.erfinv)
lgamma = _unary("lgamma", torch.lgamma)
digamma = _unary("digamma", torch.digamma)
sigmoid = _unary("sigmoid", torch.sigmoid)
i0 = _unary("i0", torch.i0)
angle = _unary("angle", torch.angle)
conj = _unary("conj", lambda x: torch.conj(x).resolve_conj())
real = _unary("real", torch.real)
imag = _unary("imag", torch.imag)
deg2rad = _unary("deg2rad", torch.deg2rad)
rad2deg = _unary("rad2deg", torch.rad2deg)
logit = _unary("logit", lambda x: torch.log(x / (1 - x)))
nan_to_num = _unary("nan_to_num", torch.nan_to_num)

isnan = _unary("isnan", torch.isnan, differentiable=False)
isinf = _unary("isinf", torch.isinf, differentiable=False)
isfinite = _unary("isfinite", torch.isfinite, differentiable=False)


@register_op("clone")
def _clone(x):
    return x.clone()


def clone(x, name=None):
    return _clone(x)


@register_op("cast")
def _cast(x, *, dtype):
    return x.to(dtype)


def cast(x, dtype):
    return _cast(x, dtype=dtype_mod.to_torch_dtype(dtype))


@register_op("scale")
def _scale(x, *, scale, bias, bias_after_scale):
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """Reference: paddle.scale (operators/scale_op.cc). ``act`` names an
    activation op of the surface (item 10's ``nn_ops``); here ``tanh``
    and ``sigmoid``."""
    if isinstance(scale, Tensor):
        scale = float(scale.item())
    out = _scale(x, scale=float(scale), bias=float(bias),
                 bias_after_scale=bool(bias_after_scale))
    if act is not None:
        out = {"tanh": tanh, "sigmoid": sigmoid}[act](out)
    return out


@register_op("clip")
def _clip(x, mn, mx):
    return torch.minimum(torch.maximum(x, mn), mx)


def clip(x, min=None, max=None, name=None):  # noqa: A002
    dt = x._v.dtype
    mn = min if isinstance(min, Tensor) else Tensor._wrap(torch.tensor(
        -_pymath.inf if min is None else min).to(dt))
    mx = max if isinstance(max, Tensor) else Tensor._wrap(torch.tensor(
        _pymath.inf if max is None else max).to(dt))
    return _clip(x, mn, mx)


@register_op("lerp")
def _lerp(x, y, w):
    return x + w * (y - x)


def lerp(x, y, weight, name=None):
    if not isinstance(weight, Tensor):
        weight = Tensor._wrap(torch.tensor(weight).to(x._v.dtype))
    return _lerp(x, y, weight)


@register_op("matmul_v2")
def _matmul(x, y, *, transpose_x, transpose_y):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return _matmul(x, y, transpose_x=bool(transpose_x),
                   transpose_y=bool(transpose_y))


mm = matmul


@register_op("bmm")
def _bmm(x, y):
    return torch.matmul(x, y)


def bmm(x, y, name=None):
    return _bmm(x, y)


@register_op("dot")
def _dot(x, y):
    return (x * y).sum(-1)


def dot(x, y, name=None):
    return _dot(x, y)


@register_op("addmm")
def _addmm(inp, x, y, *, beta, alpha):
    return beta * inp + alpha * torch.matmul(x, y)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    return _addmm(input, x, y, beta=float(beta), alpha=float(alpha))


@register_op("mv")
def _mv(x, vec):
    return torch.matmul(x, vec)


def mv(x, vec, name=None):
    return _mv(x, vec)


@register_op("cumsum")
def _cumsum(x, *, axis):
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0)
    return torch.cumsum(x, axis)


def cumsum(x, axis=None, dtype=None, name=None):
    out = _cumsum(x, axis=axis if axis is None else int(axis))
    if dtype is not None:
        out = cast(out, dtype)
    return out


@register_op("cumprod")
def _cumprod(x, *, dim):
    return torch.cumprod(x, dim)


def cumprod(x, dim=None, dtype=None, name=None):
    out = _cumprod(x, dim=int(dim))
    if dtype is not None:
        out = cast(out, dtype)
    return out


@register_op("cummax", differentiable=False)
def _cummax(x, *, axis):
    return torch.cummax(x, axis).values


def cummax(x, axis=-1):
    return _cummax(x, axis=int(axis))


@register_op("stanh")
def _stanh(x, *, scale_a, scale_b):
    return scale_b * torch.tanh(scale_a * x)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _stanh(x, scale_a=float(scale_a), scale_b=float(scale_b))


def increment(x, value=1.0, name=None):
    """In-place increment (reference: operators/increment_op)."""
    x.set_value(x._value + value)
    return x


@register_op("einsum")
def _einsum(*arrays, equation):
    return torch.einsum(equation, *arrays)


def einsum(equation, *operands):
    return _einsum(*operands, equation=equation)


@register_op("trace_op")
def _trace(x, *, offset, axis1, axis2):
    return torch.diagonal(x, offset=offset, dim1=axis1, dim2=axis2).sum(-1)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return _trace(x, offset=int(offset), axis1=int(axis1), axis2=int(axis2))


@register_op("diff")
def _diff(x, *, n, axis):
    return torch.diff(x, n=n, dim=axis)


def diff(x, n=1, axis=-1, name=None):
    return _diff(x, n=int(n), axis=int(axis))


def rsqrt_(x):
    x.set_value(torch.rsqrt(x._value))
    return x


def tanh_(x, name=None):
    x.set_value(torch.tanh(x._value))
    return x


@register_op("sum_op_n")
def _add_n(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def add_n(inputs, name=None):
    """Sum a list of tensors (reference: operators/sum_op.cc)."""
    if isinstance(inputs, Tensor):
        return inputs
    return _add_n(*inputs)


@register_op("cross")
def _cross(x, y, *, axis):
    return torch.linalg.cross(x, y, dim=axis)


def cross(x, y, axis=None, name=None):
    """Reference: operators/cross_op.cc (default: the first axis of size
    3)."""
    if axis is None:
        axis = next((i for i, s in enumerate(x.shape) if s == 3), None)
        if axis is None:
            raise ValueError(
                f"cross: no dimension of size 3 in input shape {x.shape}")
    return _cross(x, y, axis=int(axis))


@register_op("histogram", differentiable=False)
def _histogram(x, *, bins, min, max):  # noqa: A002
    xf = x.float().reshape(-1)
    lo, hi = float(min), float(max)
    if lo == 0.0 and hi == 0.0:
        lo, hi = float(xf.min()), float(xf.max())
        if hi <= lo:
            hi = lo + 1.0
    return torch.histc(xf, bins=bins, min=lo, max=hi).to(torch.int64)


def histogram(input, bins=100, min=0, max=0, name=None):  # noqa: A002
    return _histogram(input, bins=int(bins), min=min, max=max)


@register_op("renorm")
def _renorm(x, *, p, axis, max_norm):
    moved = x.movedim(axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    norms = (flat.abs() ** p).sum(1) ** (1.0 / p)
    factor = torch.where(norms > max_norm,
                         max_norm / torch.clamp(norms, min=1e-12),
                         torch.ones_like(norms))
    shaped = factor.reshape((-1,) + (1,) * (moved.dim() - 1))
    return (moved * shaped).movedim(0, axis)


def renorm(x, p, axis, max_norm, name=None):
    """Clamp each slice along ``axis`` to p-norm <= max_norm (reference:
    operators/renorm_op)."""
    return _renorm(x, p=float(p), axis=int(axis), max_norm=float(max_norm))


@register_op("vander", differentiable=False)
def _vander(x, *, n, increasing):
    return torch.vander(x, N=n, increasing=increasing)


def vander(x, n=None, increasing=False, name=None):
    return _vander(x, n=None if n is None else int(n),
                   increasing=bool(increasing))


@register_op("logcumsumexp")
def _logcumsumexp(x, *, axis):
    if axis is None:
        return torch.logcumsumexp(x.reshape(-1), 0)
    return torch.logcumsumexp(x, axis)


def logcumsumexp(x, axis=None, dtype=None, name=None):
    out = _logcumsumexp(x, axis=None if axis is None else int(axis))
    if dtype is not None:
        return cast(out, dtype)
    return out


@register_op("trapezoid_op")
def _trapezoid(y, x, *, dx, axis):
    if x is not None:
        return torch.trapezoid(y, x=x, dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    return _trapezoid(y, x, dx=dx, axis=int(axis))


@register_op("cumulative_trapezoid_op")
def _cumulative_trapezoid(y, x, *, dx, axis):
    if x is not None:
        return torch.cumulative_trapezoid(y, x=x, dim=axis)
    return torch.cumulative_trapezoid(y, dx=1.0 if dx is None else dx,
                                      dim=axis)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    return _cumulative_trapezoid(y, x, dx=dx, axis=int(axis))


@register_op("polygamma_op", differentiable=False)
def _polygamma(x, *, n):
    return torch.special.polygamma(n, x)


def polygamma(x, n, name=None):
    return _polygamma(x, n=int(n))


@register_op("igamma_op", differentiable=False)
def _igamma(x, a):
    return torch.special.gammainc(a, x)


def igamma(x, a, name=None):
    """Reference: paddle.igamma (regularized lower incomplete gamma)."""
    return _igamma(x, a)
