"""Dtype handles (a port of ``paddle_tpu/core/dtype.py``).

A thin mapping between paddle-style dtype names and torch dtypes:
``DType`` handles (``paddle.float32``, ``paddle.bfloat16``, ...),
:func:`to_paddle_dtype` from any spelling (a name, an alias, a torch or
numpy dtype, a DType), :func:`to_torch_dtype` in place of the reference's
``to_jax_dtype``, and the default floating dtype.
"""
import numpy as np
import torch


class DType:
    """A paddle-style dtype handle wrapping a torch dtype (and the numpy
    dtype of the same name; numpy has no bfloat16, so that one's is
    None)."""

    __slots__ = ("name", "torch_dtype", "np_dtype")

    def __init__(self, name, torch_dtype):
        self.name = name
        self.torch_dtype = torch_dtype
        self.np_dtype = None if name == "bfloat16" else np.dtype(
            "bool" if name == "bool" else name)

    def __repr__(self):
        return f"paddle_tpu_torch.{self.name}"

    def __eq__(self, other):
        if isinstance(other, DType):
            return self.name == other.name
        try:
            return to_paddle_dtype(other).name == self.name
        except (TypeError, ValueError):
            return NotImplemented

    def __hash__(self):
        return hash(self.name)

    @property
    def is_floating(self):
        return self.name in ("float16", "bfloat16", "float32", "float64")

    @property
    def is_complex(self):
        return self.name in ("complex64", "complex128")

    @property
    def is_integer(self):
        return self.name in ("int8", "uint8", "int16", "int32", "int64")


bool_ = DType("bool", torch.bool)
int8 = DType("int8", torch.int8)
uint8 = DType("uint8", torch.uint8)
int16 = DType("int16", torch.int16)
int32 = DType("int32", torch.int32)
int64 = DType("int64", torch.int64)
float16 = DType("float16", torch.float16)
bfloat16 = DType("bfloat16", torch.bfloat16)
float32 = DType("float32", torch.float32)
float64 = DType("float64", torch.float64)
complex64 = DType("complex64", torch.complex64)
complex128 = DType("complex128", torch.complex128)

_ALL = [bool_, int8, uint8, int16, int32, int64, float16, bfloat16,
        float32, float64, complex64, complex128]
_BY_NAME = {d.name: d for d in _ALL}
_BY_TORCH = {d.torch_dtype: d for d in _ALL}
_ALIASES = {"float": "float32", "double": "float64", "half": "float16",
            "int": "int32", "long": "int64", "bf16": "bfloat16",
            "fp16": "float16", "fp32": "float32", "fp64": "float64"}


def to_paddle_dtype(dtype):
    """Normalize any dtype spec (str, torch dtype, numpy dtype, DType)
    to DType; raises ValueError on an unknown one."""
    if isinstance(dtype, DType):
        return dtype
    if isinstance(dtype, str):
        name = _ALIASES.get(dtype, dtype)
        if name in _BY_NAME:
            return _BY_NAME[name]
        raise ValueError(f"unknown dtype {dtype!r}")
    if isinstance(dtype, torch.dtype):
        if dtype in _BY_TORCH:
            return _BY_TORCH[dtype]
        raise ValueError(f"unknown dtype {dtype!r}")
    try:
        name = np.dtype(dtype).name
    except TypeError as e:
        raise ValueError(f"unknown dtype {dtype!r}") from e
    if name in _BY_NAME:
        return _BY_NAME[name]
    raise ValueError(f"unknown dtype {dtype!r}")


def to_torch_dtype(dtype):
    """Normalize any dtype spec to the torch dtype."""
    return to_paddle_dtype(dtype).torch_dtype


# the default floating dtype (reference: paddle.set_default_dtype)
_default_dtype = float32


def set_default_dtype(dtype):
    global _default_dtype
    d = to_paddle_dtype(dtype)
    if not d.is_floating:
        raise TypeError("default dtype must be floating point")
    _default_dtype = d


def get_default_dtype():
    return _default_dtype.name
