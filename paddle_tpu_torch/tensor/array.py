"""Reference ``tensor/array.py``: the LoD tensor-array ops, which live on
the ``fluid`` surface; each name forwards to ``fluid.layers``."""

TENSOR_ARRAY_OPS = ("create_array", "array_read", "array_write",
                    "array_length")


def __getattr__(name):
    from .. import fluid
    return getattr(fluid.layers, name)
