"""paddle.distribution (a port of ``paddle_tpu/distribution/__init__.py``;
reference: python/paddle/distribution.py — Distribution, Uniform, Normal,
Categorical; fluid/layers/distributions.py MultivariateNormalDiag;
layers.sampling_id).

The log-probabilities, entropies and KL divergences are the reference's
expressions in the port's ops, so they carry grads. Samples are drawn
from the port's generator for the parameters' device
(``core.rng.default_generator``), never from torch's global one; the
reference's bits come from ``jax.random`` and cannot be matched, so a
seed gives determinism, not the reference's numbers. A categorical
draw is ``argmax(logits + Gumbel noise)``, as ``jax.random.categorical``
draws.
"""
import math

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core import rng as rng_mod
from ..core.tensor import Tensor, as_torch


def _arr(x):
    """``x`` (a Tensor, array or number) as an f32 Tensor: a Tensor's
    own value, anything else a new one on the current device."""
    if isinstance(x, Tensor):
        return x if x._v.dtype == torch.float32 \
            else Tensor._wrap(x._value.float())
    return Tensor._wrap(as_torch(np.asarray(x, "float32")))


def _val(v):
    return v if isinstance(v, Tensor) else _arr(v)


def _gen(t):
    return rng_mod.default_generator(t.device)


class Distribution:
    def sample(self, shape=()):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def probs(self, value):
        from ..ops import math as math_ops
        return math_ops.exp(self.log_prob(value))

    def kl_divergence(self, other):
        raise NotImplementedError


class Normal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc = _arr(loc)
        self.scale = _arr(scale)

    def sample(self, shape=(), seed=0):
        loc, scale = self.loc._value, self.scale._value
        shape = tuple(shape) + tuple(torch.broadcast_shapes(loc.shape,
                                                            scale.shape))
        eps = torch.randn(shape, generator=_gen(loc), device=loc.device)
        return Tensor._wrap((loc + scale * eps).detach())

    def log_prob(self, value):
        from ..ops import math as math_ops
        var = math_ops.multiply(self.scale, self.scale)
        diff = math_ops.subtract(_val(value), self.loc)
        t1 = math_ops.divide(math_ops.multiply(diff, diff),
                             math_ops.scale(var, 2.0))
        return math_ops.scale(
            math_ops.add(t1, math_ops.log(
                math_ops.scale(self.scale, math.sqrt(2 * math.pi)))), -1.0)

    def entropy(self):
        from ..ops import math as math_ops
        return math_ops.add(
            math_ops.log(self.scale),
            float(0.5 * math.log(2 * math.pi) + 0.5))

    def kl_divergence(self, other):
        from ..ops import math as math_ops
        var_ratio = math_ops.divide(self.scale, other.scale)
        var_ratio = math_ops.multiply(var_ratio, var_ratio)
        t1 = math_ops.divide(math_ops.subtract(self.loc, other.loc),
                             other.scale)
        t1 = math_ops.multiply(t1, t1)
        return math_ops.scale(
            math_ops.subtract(
                math_ops.add(var_ratio, t1),
                math_ops.add(math_ops.log(var_ratio), 1.0)), 0.5)


class Uniform(Distribution):
    def __init__(self, low, high, name=None):
        self.low = _arr(low)
        self.high = _arr(high)

    def sample(self, shape=(), seed=0):
        low, high = self.low._value, self.high._value
        shape = tuple(shape) + tuple(torch.broadcast_shapes(low.shape,
                                                            high.shape))
        u = torch.rand(shape, generator=_gen(low), device=low.device)
        return Tensor._wrap((low + (high - low) * u).detach())

    def log_prob(self, value):
        from ..ops import logic, manipulation
        from ..ops import math as math_ops
        value = _val(value)
        span = math_ops.subtract(self.high, self.low)
        inside = logic.logical_and(logic.greater_equal(value, self.low),
                                   logic.less_than(value, self.high))
        lp = math_ops.scale(math_ops.log(span), -1.0)
        neg_inf = Tensor._wrap(torch.full(
            torch.broadcast_shapes(value._v.shape, lp._v.shape),
            -math.inf, dtype=torch.float32, device=lp._v.device))
        return manipulation.where(inside, lp, neg_inf)

    def entropy(self):
        from ..ops import math as math_ops
        return math_ops.log(math_ops.subtract(self.high, self.low))


def _gumbel_argmax(logits, shape):
    """``jax.random.categorical``'s draw: argmax over the last axis of
    logits plus Gumbel noise, ``shape + logits.shape[:-1]`` draws."""
    full = tuple(shape) + tuple(logits.shape)
    u = torch.rand(full, generator=_gen(logits), device=logits.device)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log((-torch.log(u.clamp_min(tiny))).clamp_min(tiny))
    return torch.argmax(logits.detach() + g, dim=-1)


class Categorical(Distribution):
    def __init__(self, logits, name=None):
        self.logits = logits if isinstance(logits, Tensor) else _arr(logits)

    def sample(self, shape=(), seed=0):
        return Tensor._wrap(_gumbel_argmax(self.logits._value.float(),
                                           shape))

    def log_prob(self, value):
        from ..ops import manipulation, nn_ops
        from ..ops import math as math_ops
        logp = nn_ops.log_softmax(self.logits, axis=-1)
        idx = math_ops.cast(_val(value), "int32")
        if logp.ndim == 1:
            return manipulation.gather(logp, idx)
        return manipulation.take_along_axis(
            logp, manipulation.unsqueeze(idx, axis=-1), axis=-1)

    def entropy(self):
        from ..ops import math as math_ops
        from ..ops import nn_ops, reduction
        logp = nn_ops.log_softmax(self.logits, axis=-1)
        p = nn_ops.softmax(self.logits, axis=-1)
        return math_ops.scale(
            reduction.sum(math_ops.multiply(p, logp), axis=-1), -1.0)


def kl_divergence(p, q):
    return p.kl_divergence(q)


class MultivariateNormalDiag(Distribution):
    """Reference: fluid/layers/distributions.py MultivariateNormalDiag —
    diagonal-covariance multivariate normal; ``scale`` is the covariance
    matrix, whose diagonal is read."""

    def __init__(self, loc, scale):
        self.loc = _arr(loc)._value
        self.scale = _arr(scale)._value

    def _diag(self):
        return torch.diagonal(self.scale, dim1=-2, dim2=-1)

    def sample(self, shape=()):
        eps = torch.randn(tuple(shape) + tuple(self.loc.shape),
                          generator=_gen(self.loc), device=self.loc.device)
        return Tensor._wrap(self.loc + eps * torch.sqrt(self._diag()))

    def entropy(self):
        d = self._diag()
        k = self.loc.shape[-1]
        return Tensor._wrap(0.5 * (k * (1.0 + math.log(2 * math.pi))
                                   + torch.log(d).sum(-1)))

    def log_prob(self, value):
        v = _arr(value)._value
        d = self._diag()
        k = self.loc.shape[-1]
        return Tensor._wrap(-0.5 * (((v - self.loc) ** 2 / d).sum(-1)
                                    + k * math.log(2 * math.pi)
                                    + torch.log(d).sum(-1)))

    def kl_divergence(self, other):
        d0, d1 = self._diag(), other._diag()
        k = self.loc.shape[-1]
        t = ((d0 / d1).sum(-1) + ((other.loc - self.loc) ** 2 / d1).sum(-1)
             - k + torch.log(d1).sum(-1) - torch.log(d0).sum(-1))
        return Tensor._wrap(0.5 * t)


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64"):  # noqa: A002
    """Reference: layers.sampling_id — sample a category index per row
    of a probability matrix."""
    probs = _arr(x)._value
    idx = _gumbel_argmax(torch.log(probs.clamp_min(1e-12)), ())
    return Tensor._wrap(idx.to(dtype_mod.to_torch_dtype(dtype)))
