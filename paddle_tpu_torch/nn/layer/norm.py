"""Normalization layers (a port of ``paddle_tpu/nn/layer/norm.py``):
``LayerNorm`` and ``SpectralNorm``. The batch, group and instance norms
are not ported yet."""
from ...core.tensor import Tensor
from ...ops import nn_ops
from .. import initializer as init_mod
from ..layer_base import Layer


class LayerNorm(Layer):
    """Normalizes the trailing ``normalized_shape`` dims; weight 1 and
    bias 0 of their flattened size, epsilon 1e-5."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        n = 1
        for s in self._normalized_shape:
            n *= s
        self.weight = None if weight_attr is False \
            else self.create_parameter(
                (n,), attr=init_mod.ParamAttr._to_attr(weight_attr),
                default_initializer=init_mod.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            (n,), attr=init_mod.ParamAttr._to_attr(bias_attr), is_bias=True)

    def forward(self, x):
        return nn_ops.layer_norm(x, self._normalized_shape, self.weight,
                                 self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class SpectralNorm(Layer):
    """Reference ``paddle.nn.SpectralNorm`` (norm.py:157;
    spectral_norm_op.cc): ``forward(weight)`` returns ``weight / sigma``,
    sigma the power-iteration estimate of the weight's largest singular
    value around ``dim``. ``weight_u`` ``[shape[dim]]`` and ``weight_v``
    ``[prod of the rest]`` are persistable buffers drawn N(0, 1) from the
    port's default generator and refreshed in place by each forward,
    constants for the gradient, as in the reference op."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32", name=None):
        super().__init__()
        self._dim = int(dim)
        self._power_iters = int(power_iters)
        self._eps = float(eps)
        self._shape = tuple(int(s) for s in weight_shape)
        h = self._shape[self._dim]
        w = 1
        for i, s in enumerate(self._shape):
            if i != self._dim:
                w *= s
        normal = init_mod.Normal(0.0, 1.0)
        self.register_buffer("weight_u", Tensor._wrap(
            normal((h,), "float32")))
        self.register_buffer("weight_v", Tensor._wrap(
            normal((w,), "float32")))

    def forward(self, weight):
        out, u_n, v_n = nn_ops.spectral_norm(
            weight, self.weight_u, self.weight_v, dim=self._dim,
            power_iters=self._power_iters, eps=self._eps)
        self.weight_u.set_value(u_n.value)
        self.weight_v.set_value(v_n.value)
        return out
