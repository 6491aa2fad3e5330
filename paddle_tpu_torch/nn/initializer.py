"""Parameter initializers and ``ParamAttr`` (a port of
``paddle_tpu/nn/initializer.py``).

An initializer is called with ``(shape, dtype)`` and returns a torch
tensor on ``device`` (default: the current device, the card unless
``set_device`` says otherwise). The random ones draw in f32 from an
explicit ``torch.Generator`` (``generator``, or the port's default
generator for the device, which ``paddle_tpu_torch.seed`` reseeds) and
cast to ``dtype``; the reference draws from ``jax.random`` keys, so a
seed gives the same distribution and not the same numbers. The fans are
``_fans``'s: a 2-D weight is ``[in, out]`` (Paddle's ``Linear``), a
conv weight ``[out, in, *kernel]``.
"""
import math

import numpy as np
import torch

from ..core import device as device_mod
from ..core import dtype as dtype_mod
from ..core import rng as rng_mod


class Initializer:
    def __call__(self, shape, dtype, device=None, generator=None):
        dev = device_mod.resolve_device(device)
        gen = generator if generator is not None \
            else rng_mod.default_generator(dev)
        v = self._make(tuple(int(s) for s in shape), dev, gen)
        return v.to(dtype_mod.to_torch_dtype(dtype))

    def _make(self, shape, device, generator):
        raise NotImplementedError


def _randn(shape, device, generator):
    return torch.randn(shape, generator=generator, device=device)


def _rand(shape, device, generator, low, high):
    u = torch.rand(shape, generator=generator, device=device)
    return u * (high - low) + low


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _make(self, shape, device, generator):
        return torch.full(shape, float(self.value), device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _make(self, shape, device, generator):
        return _randn(shape, device, generator) * self.std + self.mean


class TruncatedNormal(Initializer):
    """N(mean, std) truncated to two std, as ``jax.random.truncated_normal``
    at (-2, 2): the inverse CDF of a uniform draw between the bounds'
    CDF values."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _make(self, shape, device, generator):
        lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
        hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
        u = _rand(shape, device, generator, lo, hi)
        z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
        z = torch.clamp(z, -2.0, 2.0)
        return z * self.std + self.mean


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _make(self, shape, device, generator):
        return _rand(shape, device, generator, float(self.low),
                     float(self.high))


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        # Paddle's linear weight [in, out]
        return shape[0], shape[1]
    # conv [out, in, *kernel]
    rf = int(np.prod(shape[2:]))
    return shape[1] * rf, shape[0] * rf


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _make(self, shape, device, generator):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return _randn(shape, device, generator) * std


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _make(self, shape, device, generator):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _rand(shape, device, generator, -limit, limit)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def _make(self, shape, device, generator):
        fi, _ = _fans(shape)
        fi = self.fan_in or fi
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return _randn(shape, device, generator) * (gain / math.sqrt(fi))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def _make(self, shape, device, generator):
        fi, _ = _fans(shape)
        fi = self.fan_in or fi
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        limit = gain * math.sqrt(3.0 / fi)
        return _rand(shape, device, generator, -limit, limit)


class Assign(Initializer):
    """The given values (a Tensor, torch tensor, numpy array or list)."""

    def __init__(self, value):
        self.value = value

    def _make(self, shape, device, generator):
        from ..core.tensor import as_torch
        v = as_torch(self.value, device=device).to(device)
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"Assign shape mismatch {tuple(v.shape)} vs "
                             f"{shape}")
        return v.clone()


class Bilinear(Initializer):
    """The bilinear-upsampling kernel of a transposed conv (weight
    ``[out, in, kh, kw]``), written at every (out, in) channel pair as
    the reference's fluid BilinearInitializer does."""

    def _make(self, shape, device, generator):
        out_c, in_c, kh, kw = shape
        f_h, f_w = (kh + 1) // 2, (kw + 1) // 2
        ch = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        cw = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        og = np.ogrid[:kh, :kw]
        filt = ((1 - abs(og[0] / f_h - ch))
                * (1 - abs(og[1] / f_w - cw))).astype(np.float32)
        w = np.broadcast_to(filt, shape).copy()
        return torch.from_numpy(w).to(device)


class ParamAttr:
    """Reference python/paddle/fluid/param_attr.py ParamAttr."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(arg):
        if arg is None or isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if arg is False:
            return False
        return ParamAttr()


_global_initializer = [None, None]  # (weight init, bias init)


def set_global_initializer(weight_init, bias_init=None):
    """The initializers a layer's parameters take when its attr names
    none (reference nn/initializer/set_global_initializer); ``(None,
    None)`` resets."""
    _global_initializer[0] = weight_init
    _global_initializer[1] = bias_init


def get_global_initializer(is_bias=False):
    return _global_initializer[1 if is_bias else 0]
