"""Normalization layers (a port of ``paddle_tpu/nn/layer/norm.py``):
the batch norms (``BatchNorm``, ``BatchNorm1D/2D/3D``, ``SyncBatchNorm``),
``LayerNorm``, ``GroupNorm``, ``InstanceNorm1D/2D/3D``,
``LocalResponseNorm`` and ``SpectralNorm``."""
from ...core.tensor import Tensor
from ...ops import nn_ops
from .. import initializer as init_mod
from ..layer_base import Layer


class _BatchNormBase(Layer):
    """Weight 1 and bias 0 of ``num_features``; the running statistics
    are the persistable f32 buffers ``_mean`` (0) and ``_variance`` (1),
    updated in place by each training forward (``nn_ops.batch_norm``:
    ``running * momentum + batch * (1 - momentum)``, the biased batch
    variance). ``eval()`` or ``use_global_stats`` normalizes by them.
    ``name`` is taken and not read."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = None if weight_attr is False \
            else self.create_parameter(
                (num_features,), attr=init_mod.ParamAttr._to_attr(
                    weight_attr),
                default_initializer=init_mod.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            (num_features,), attr=init_mod.ParamAttr._to_attr(bias_attr),
            is_bias=True)
        self.register_buffer("_mean", Tensor._wrap(
            init_mod.Constant(0.0)((num_features,), "float32")))
        self.register_buffer("_variance", Tensor._wrap(
            init_mod.Constant(1.0)((num_features,), "float32")))

    def forward(self, x):
        return nn_ops.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}"


class BatchNorm(_BatchNormBase):
    """The legacy ``fluid.dygraph.BatchNorm`` entry."""


class BatchNorm1D(_BatchNormBase):
    """``data_format`` is taken and, as in the reference, read as
    ``"NCL"`` whatever it says."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCL", use_global_stats, name)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name)


class SyncBatchNorm(_BatchNormBase):
    """On one card the plain batch norm, as the reference's on one
    device (its statistics span the batch this process sees)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        return layer


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
        self.weight_u.set_value(u_n)
        self.weight_v.set_value(v_n)
        return out


class GroupNorm(Layer):
    """``num_groups`` groups of ``num_channels``; weight 1, bias 0.
    ``data_format`` taken and not read."""

    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self.weight = None if weight_attr is False \
            else self.create_parameter(
                (num_channels,), attr=init_mod.ParamAttr._to_attr(
                    weight_attr),
                default_initializer=init_mod.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            (num_channels,), attr=init_mod.ParamAttr._to_attr(bias_attr),
            is_bias=True)

    def forward(self, x):
        return nn_ops.group_norm(x, self._num_groups, self.weight, self.bias,
                                 self._epsilon)


class InstanceNorm2D(Layer):
    """Each sample's own statistics over the spatial dims; the scale is
    the parameter ``scale`` (the reference's name). ``momentum`` and
    ``data_format`` taken and not read."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.scale = None if weight_attr is False \
            else self.create_parameter(
                (num_features,), attr=init_mod.ParamAttr._to_attr(
                    weight_attr),
                default_initializer=init_mod.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            (num_features,), attr=init_mod.ParamAttr._to_attr(bias_attr),
            is_bias=True)

    def forward(self, x):
        return nn_ops.instance_norm(x, weight=self.scale, bias=self.bias,
                                    epsilon=self._epsilon)


InstanceNorm1D = InstanceNorm2D
InstanceNorm3D = InstanceNorm2D


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        return nn_ops.local_response_norm(x, self.size, self.alpha,
                                          self.beta, self.k)
