"""Common layers (a port of ``paddle_tpu/nn/layer/common.py``):
``Linear`` (weight ``[in, out]``, Paddle's layout), the dropouts,
``Embedding``, ``Flatten``, ``Identity``, the pads, ``CosineSimilarity``,
``PairwiseDistance``, ``Bilinear``, ``Upsample``,
``UpsamplingBilinear2D``, ``UpsamplingNearest2D``, ``PixelShuffle`` and
``Unfold``.
"""
import torch

from ...ops import manipulation, nn_ops
from .. import initializer as init_mod
from ..layer_base import Layer


class Linear(Layer):
    """``y = x @ weight + bias`` with ``weight`` ``[in_features,
    out_features]``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        self.weight = self.create_parameter(
            (in_features, out_features),
            attr=init_mod.ParamAttr._to_attr(weight_attr))
        self.bias = None if bias_attr is False else self.create_parameter(
            (out_features,), attr=init_mod.ParamAttr._to_attr(bias_attr),
            is_bias=True)

    def forward(self, x):
        return nn_ops.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Dropout(Layer):
    """``nn_ops.dropout`` in training (its masks from the port's default
    generator for the input's device), the identity (or the
    ``downscale_in_infer`` scale) in eval."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x):
        return nn_ops.dropout(x, p=self.p, training=self.training,
                              mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return nn_ops.dropout2d(x, p=self.p, training=self.training)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return nn_ops.dropout3d(x, self.p, training=self.training)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return nn_ops.alpha_dropout(x, self.p, training=self.training)


class Embedding(Layer):
    """Rows of ``weight`` ``[num_embeddings, embedding_dim]`` (N(0, 1)
    unless ``weight_attr`` says otherwise); the ``padding_idx`` row is
    zeroed at construction, on the parameter's own device, and looks up
    zeros."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self._sparse = bool(sparse)
        attr = init_mod.ParamAttr._to_attr(weight_attr)
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=attr,
            default_initializer=init_mod.Normal(0.0, 1.0) if (
                attr is None or attr.initializer is None) else None)
        if padding_idx is not None:
            pi = padding_idx if padding_idx >= 0 \
                else num_embeddings + padding_idx
            with torch.no_grad():
                self.weight._value[pi] = 0

    def forward(self, x):
        return nn_ops.embedding(x, self.weight,
                                padding_idx=self._padding_idx,
                                sparse=self._sparse)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return manipulation.flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class _Pad(Layer):
    _layout = "NCHW"

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format=None, name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format or self._layout

    def forward(self, x):
        return manipulation.pad(x, self.padding, self.mode, self.value,
                                self.data_format)


class Pad1D(_Pad):
    """Over NCL input."""
    _layout = "NCL"

    def forward(self, x):
        return manipulation.pad(x, self.padding, self.mode, self.value,
                                "NCL")


class Pad2D(_Pad):
    _layout = "NCHW"


class Pad3D(_Pad):
    _layout = "NCDHW"

    def forward(self, x):
        return manipulation.pad(x, self.padding, self.mode, self.value,
                                "NCDHW")


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return nn_ops.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    """The p-norm of ``x - y`` over the last axis (reference
    nn/layer/distance.py)."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        from ...ops import math as math_ops, reduction as red_ops
        return red_ops.norm(math_ops.subtract(x, y), p=self.p, axis=-1,
                            keepdim=self.keepdim)


class Bilinear(Layer):
    """``out[b, o] = x1[b] @ W[o] @ x2[b] + bias[o]`` with W ``[out, in1,
    in2]`` and bias ``[1, out]``."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            (out_features, in1_features, in2_features),
            attr=init_mod.ParamAttr._to_attr(weight_attr))
        self.bias = None if bias_attr is False else self.create_parameter(
            (1, out_features), attr=init_mod.ParamAttr._to_attr(bias_attr),
            is_bias=True)

    def forward(self, x1, x2):
        from ...ops import math as math_ops
        out = math_ops.einsum("bi,oij,bj->bo", x1, self.weight, x2)
        if self.bias is not None:
            out = math_ops.add(out, self.bias)
        return out


class Upsample(Layer):
    """``nn_ops.interpolate`` of ``size`` or ``scale_factor``;
    ``align_mode`` and ``data_format`` taken and not read."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners

    def forward(self, x):
        return nn_ops.interpolate(x, self.size, self.scale_factor, self.mode,
                                  self.align_corners)


class UpsamplingBilinear2D(Upsample):
    """Bilinear with ``align_corners=True``."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor

    def forward(self, x):
        return nn_ops.pixel_shuffle(x, self.upscale_factor)


class Unfold(Layer):
    """im2col (``manipulation.unfold``)."""

    def __init__(self, kernel_sizes, dilations=1, paddings=0, strides=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        k, s, p, d = self.args
        return manipulation.unfold(x, k, strides=s, paddings=p, dilations=d)
