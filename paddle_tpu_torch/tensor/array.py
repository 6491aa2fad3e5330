"""Reference ``tensor/array.py``: the LoD tensor-array ops, which live on
the ``fluid`` surface. The port has no ``fluid`` yet, so each name
raises."""

TENSOR_ARRAY_OPS = ("create_array", "array_read", "array_write",
                    "array_length")


def __getattr__(name):
    if name in TENSOR_ARRAY_OPS:
        raise NotImplementedError(
            f"paddle.tensor.array.{name}: the fluid surface is not ported")
    raise AttributeError(f"module 'paddle.tensor.array' has no attribute "
                         f"{name!r}")
