"""Normalization layers (a port of ``paddle_tpu/nn/layer/norm.py``):
``LayerNorm``. The batch, group and instance norms are not ported yet."""
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
