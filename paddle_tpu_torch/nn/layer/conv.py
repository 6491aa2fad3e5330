"""Convolution layers (a port of ``paddle_tpu/nn/layer/conv.py``):
``Conv1D/2D/3D`` and ``Conv1D/2D/3DTranspose`` over ``nn_ops``' convs.
A conv weight is ``[out, in/groups, *k]`` and a transposed one ``[in,
out/groups, *k]``; ``Conv*D`` and ``Conv2DTranspose`` draw it
``KaimingNormal`` over ``in/groups * prod(k)`` fans, ``Conv1D/3D
Transpose`` take the default (``XavierNormal``), as the reference's do.
``padding_mode`` and, on the transposes, ``output_size``, the 1d/3d
``output_padding`` and ``data_format`` are taken and, as in the
reference, not read.
"""
import numpy as np

from ...ops import nn_ops
from .. import initializer as init_mod
from ..layer_base import Layer


def _pair(v, n=2):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, weight_attr, bias_attr,
                 data_format, ndim, transpose=False, output_padding=0):
        super().__init__()
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _pair(kernel_size, ndim)
        self._stride = _pair(stride, ndim)
        self._padding = padding
        self._dilation = _pair(dilation, ndim)
        self._groups = groups
        self._data_format = data_format
        self._output_padding = output_padding
        if transpose:
            w_shape = (in_channels, out_channels // groups) \
                + self._kernel_size
        else:
            w_shape = (out_channels, in_channels // groups) \
                + self._kernel_size
        fan_in = (in_channels // groups) * int(np.prod(self._kernel_size))
        self.weight = self.create_parameter(
            w_shape, attr=init_mod.ParamAttr._to_attr(weight_attr),
            default_initializer=init_mod.KaimingNormal(fan_in=fan_in))
        self.bias = None if bias_attr is False else self.create_parameter(
            (out_channels,), attr=init_mod.ParamAttr._to_attr(bias_attr),
            is_bias=True)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 2)

    def forward(self, x):
        return nn_ops.conv2d(x, self.weight, self.bias, self._stride,
                             self._padding, self._dilation, self._groups,
                             self._data_format)


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 1)

    def forward(self, x):
        return nn_ops.conv1d(x, self.weight, self.bias, self._stride[0],
                             self._padding, self._dilation[0], self._groups)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 3)

    def forward(self, x):
        return nn_ops.conv3d(x, self.weight, self.bias, self._stride,
                             self._padding, self._dilation, self._groups)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 2, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return nn_ops.conv2d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._dilation, self._groups)


class Conv1DTranspose(Layer):
    """Weight ``[in, out/groups, k]``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__()
        k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
        self.weight = self.create_parameter(
            (in_channels, out_channels // groups, k), weight_attr)
        self.bias = self.create_parameter(
            (out_channels,), bias_attr, is_bias=True) \
            if bias_attr is not False else None
        self._stride, self._padding, self._dilation = stride, padding, \
            dilation
        self._groups = int(groups)

    def forward(self, x):
        return nn_ops.conv1d_transpose(x, self.weight, self.bias,
                                       self._stride, self._padding,
                                       dilation=self._dilation,
                                       groups=self._groups)


class Conv3DTranspose(Layer):
    """Weight ``[in, out/groups, kd, kh, kw]``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__()
        ks = (kernel_size,) * 3 if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self.weight = self.create_parameter(
            (in_channels, out_channels // groups) + ks, weight_attr)
        self.bias = self.create_parameter(
            (out_channels,), bias_attr, is_bias=True) \
            if bias_attr is not False else None
        self._stride, self._padding, self._dilation = stride, padding, \
            dilation
        self._groups = int(groups)

    def forward(self, x):
        return nn_ops.conv3d_transpose(x, self.weight, self.bias,
                                       self._stride, self._padding,
                                       dilation=self._dilation,
                                       groups=self._groups)
