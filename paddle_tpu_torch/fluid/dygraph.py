"""fluid.dygraph compat (a port of ``paddle_tpu/fluid/dygraph.py``;
reference python/paddle/fluid/dygraph/): guard, to_variable, old-style
layer aliases, jit_to_static. Dygraph is the default (and only) eager
mode here, so guard is a no-op context and enable/disable do nothing.
"""
import contextlib

from ..core.tensor import Tensor
from ..nn.layer_base import Layer  # noqa: F401
from ..nn.layer.common import Linear, Embedding  # noqa: F401
from ..nn.layer.conv import Conv2D  # noqa: F401
from ..nn.layer.norm import BatchNorm2D as BatchNorm  # noqa: F401
from ..nn.layer.pooling import MaxPool2D as Pool2D  # noqa: F401
from ..jit.to_static import to_static as jit_to_static  # noqa: F401


@contextlib.contextmanager
def guard(place=None):
    """Reference: fluid/dygraph/base.py guard — eager mode is always on;
    kept for source compatibility."""
    yield


def to_variable(value, name=None, zero_copy=None, dtype=None):
    return Tensor(value, dtype=dtype, name=name)


def enabled():
    return True


def enable_dygraph(place=None):
    pass


def disable_dygraph():
    pass
