"""Pooling layers (a port of ``paddle_tpu/nn/layer/pooling.py``): the
twelve layers over ``nn_ops``' pools. As in the reference, a layer
passes on only what its forward names: ``MaxPool2D`` its kernel, stride,
padding and ``ceil_mode``; the others kernel, stride and padding (and
``exclusive`` for the average pools in 1d and 2d); ``return_mask``,
``data_format``, ``divisor_override`` and the rest are taken and not
read.
"""
from ...ops import manipulation, nn_ops
from ..layer_base import Layer


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.ceil_mode = ceil_mode

    def forward(self, x):
        return nn_ops.max_pool2d(x, self.k, self.s, self.p, self.ceil_mode)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.exclusive = exclusive

    def forward(self, x):
        return nn_ops.avg_pool2d(x, self.k, self.s, self.p,
                                 exclusive=self.exclusive)


class MaxPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding

    def forward(self, x):
        return nn_ops.max_pool1d(x, self.k, self.s, self.p)


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.exclusive = exclusive

    def forward(self, x):
        return nn_ops.avg_pool1d(x, self.k, self.s, self.p, self.exclusive)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return nn_ops.adaptive_avg_pool2d(x, self.output_size)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return nn_ops.adaptive_max_pool2d(x, self.output_size)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        x4 = manipulation.unsqueeze(x, axis=2)
        out = nn_ops.adaptive_avg_pool2d(x4, (1, self.output_size))
        return manipulation.squeeze(out, axis=2)


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCDHW", name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding

    def forward(self, x):
        return nn_ops.max_pool3d(x, self.k, self.s, self.p)


class AvgPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None,
                 data_format="NCDHW", name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding

    def forward(self, x):
        return nn_ops.avg_pool3d(x, self.k, self.s, self.p)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return nn_ops.adaptive_avg_pool3d(x, self.output_size)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return nn_ops.adaptive_max_pool3d(x, self.output_size)


class AdaptiveMaxPool1D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return nn_ops.adaptive_max_pool1d(x, self.output_size)
