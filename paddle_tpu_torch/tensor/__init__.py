"""``paddle.tensor`` of the port (reference ``paddle_tpu/tensor/``): the
op modules under the reference's submodule names
(``paddle.tensor.math.add``, ``paddle.tensor.creation.zeros``, ...), and
every tensor function of the package forwarded at this level
(``paddle.tensor.add is paddle.add``)."""
from ..ops import creation, linalg, logic, manipulation, math, search  # noqa: F401,E501
from ..ops import reduction as stat  # noqa: F401
from . import array, attribute, random, to_string  # noqa: F401

__all__ = []


def __getattr__(name):
    import types

    import paddle_tpu_torch as paddle
    from ..core.tensor import Tensor

    # the in-place variants are Tensor methods; the reference also offers
    # them as free functions, paddle.tensor.add_(x, ...)
    if name.endswith("_") and hasattr(Tensor, name):
        meth = getattr(Tensor, name)

        def free(x, *a, **k):
            return meth(x, *a, **k)

        free.__name__ = name
        return free
    if name in array.TENSOR_ARRAY_OPS:
        return getattr(array, name)
    attr = getattr(paddle, name, None)
    if attr is None or isinstance(attr, types.ModuleType):
        # sibling namespaces (paddle.tensor.nn, ...) are not mirrored
        raise AttributeError(
            f"module 'paddle.tensor' has no attribute {name!r}")
    return attr
