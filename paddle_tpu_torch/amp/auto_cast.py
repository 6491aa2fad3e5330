"""AMP autocast (reference ``paddle_tpu/amp/auto_cast.py``).

The reference casts at its op dispatcher (``core/dispatch.py:165-170``):
when an op runs under ``auto_cast``, the float inputs of a white-list op
(O1), or of every op not on the black list (O2), are cast to the low
dtype; every other op runs on its inputs as they come. Black means "not
cast", not "cast to f32". ``torch.autocast`` follows other lists (it
up-casts ``layer_norm``, ``softmax`` and ``cross_entropy`` to f32, its
CPU and CUDA lists differ) and has no O2, so the port does not use it.

Instead ``auto_cast`` pushes a ``TorchFunctionMode`` that gives each
torch function the reference's op name (``_OP_NAMES``, the port's copy
of the reference's op table for the functions the port calls) and casts
its float inputs by the reference's rule, the same on the CPU and on
CUDA. A torch function with no name here runs as it is, as the
reference's plain Python does. An uncast op whose float inputs differ
in dtype runs at the widest of them, as the reference's ``jnp`` body
promotes them (``layer_norm`` of a bf16 input with f32 weights is f32 in
both). The port's own ops (flash attention, the fused cross-entropy,
dropout) are not torch functions: they call ``cast_inputs`` with their
reference name and run their bodies under ``op_body``, inside which the
mode casts nothing, as the reference's op body runs uncast.
"""
import threading
from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

# the reference's white list (imperative/amp_auto_cast.cc defaults, plus
# the fused ops it adds), by op name
WHITE_LIST = {
    "matmul", "matmul_v2", "mul", "conv2d", "conv3d", "conv2d_transpose",
    "einsum", "bmm", "addmm", "attention", "flash_attention",
    "linear",
    "fused_linear_cross_entropy",
}
# ops numerically unsafe in low precision: never cast
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "pow", "square", "sqrt", "rsqrt",
    "softmax_with_cross_entropy", "cross_entropy", "log_softmax",
    "mean", "sum", "reduce_mean", "reduce_sum", "norm", "cos_sim",
    "layer_norm", "batch_norm", "softmax", "erf", "cumsum",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _op_names():
    T = torch.Tensor
    names = {
        "linear": [F.linear],
        "matmul_v2": [torch.matmul, T.matmul, T.__matmul__, torch.mm, T.mm],
        "bmm": [torch.bmm, T.bmm],
        "addmm": [torch.addmm, T.addmm],
        "einsum": [torch.einsum],
        "conv2d": [F.conv2d],
        "conv3d": [F.conv3d],
        "conv2d_transpose": [F.conv_transpose2d],
        "lookup_table_v2": [F.embedding],
        "layer_norm": [F.layer_norm],
        "batch_norm": [F.batch_norm],
        "softmax": [F.softmax, torch.softmax, T.softmax],
        "log_softmax": [F.log_softmax, torch.log_softmax, T.log_softmax],
        "cross_entropy": [F.cross_entropy],
        "gelu": [F.gelu],
        "relu": [F.relu, torch.relu, T.relu],
        "tanh": [torch.tanh, T.tanh],
        "exp": [torch.exp, T.exp],
        "log": [torch.log, T.log],
        "sqrt": [torch.sqrt, T.sqrt],
        "rsqrt": [torch.rsqrt, T.rsqrt],
        "square": [torch.square, T.square],
        "erf": [torch.erf, T.erf],
        "cumsum": [torch.cumsum, T.cumsum],
        "reduce_sum": [torch.sum, T.sum],
        "reduce_mean": [torch.mean, T.mean],
        "elementwise_add": [torch.add, T.add, T.__add__, T.__radd__],
        "elementwise_sub": [torch.sub, T.sub, T.__sub__, T.__rsub__],
        "elementwise_mul": [torch.mul, T.mul, T.__mul__, T.__rmul__],
        "elementwise_div": [torch.div, T.div, T.__truediv__,
                            T.__rtruediv__],
        "clip": [torch.clamp, T.clamp, T.clip],
        "reshape": [torch.reshape, T.reshape],
        "transpose2": [torch.transpose, T.transpose, T.permute, T.t],
        "split": [torch.unbind, T.unbind, torch.split, T.split],
        "where_op": [torch.where],
        "not_equal": [torch.ne, T.ne, T.__ne__],
    }
    return {fn: name for name, fns in names.items() for fn in fns}


_OP_NAMES = _op_names()


class _State(threading.local):
    amp = None   # (level, dtype, custom white, custom black) while on
    depth = 0    # > 0 inside a port op's body: nothing is cast there


_state = _State()


def amp_enabled():
    return _state.amp is not None


def amp_state():
    """The current ``auto_cast`` state (None outside one), for
    ``resume`` to re-enter later, on another thread too."""
    return _state.amp


@contextmanager
def resume(state):
    """Re-enter an ``auto_cast`` state taken by ``amp_state`` (a block
    recomputed in the backward casts as its forward did); None casts
    nothing."""
    prev = _state.amp
    _state.amp = state
    try:
        with _AmpMode():
            yield
    finally:
        _state.amp = prev


def _cast_dtype_for(op_name):
    """The dtype to cast op ``op_name``'s float inputs to, or None (the
    reference rule, ``auto_cast.py:50-62``)."""
    st = _state.amp
    if st is None:
        return None
    level, dtype, custom_white, custom_black = st
    if op_name in custom_black or op_name in BLACK_LIST:
        return None
    if level == "O2":
        return dtype
    if op_name in custom_white or op_name in WHITE_LIST:
        return dtype
    return None


def _map_tensors(fn, obj):
    """``fn`` over the tensors of ``obj``: a tensor, or a tuple, list or
    dict holding them one level deep (einsum's operand list)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_tensors(fn, a) for a in obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(fn, v) for k, v in obj.items()}
    return obj


def _float_dtypes(obj, out):
    _map_tensors(lambda t: out.add(t.dtype) if t.is_floating_point()
                 else None, obj)
    return out


def _cast(obj, dtype):
    return _map_tensors(
        lambda t: t.to(dtype) if t.is_floating_point() and t.dtype != dtype
        else t, obj)


def cast_inputs(op_name, *tensors):
    """``tensors`` with their float members cast as the reference's
    dispatcher casts the inputs of op ``op_name`` under the current
    ``auto_cast`` state (unchanged outside it, or inside an op's body)."""
    dt = None if _state.depth else _cast_dtype_for(op_name)
    if dt is None:
        return tensors
    return _cast(tensors, dt)


@contextmanager
def op_body():
    """The body of a port op: the mode casts nothing inside it."""
    _state.depth += 1
    try:
        yield
    finally:
        _state.depth -= 1


class _AmpMode(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _state.amp is None or _state.depth:
            return func(*args, **kwargs)
        name = _OP_NAMES.get(func)
        if name is None:
            return func(*args, **kwargs)
        dt = _cast_dtype_for(name)
        if dt is None:
            floats = _float_dtypes((args, kwargs), set())
            if len(floats) < 2:
                return func(*args, **kwargs)
            dt = floats.pop()
            for other in floats:
                dt = torch.promote_types(dt, other)
        args, kwargs = _cast((args, kwargs), dt)
        return func(*args, **kwargs)


@contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """``paddle.amp.auto_cast``: O1 casts the white list's float inputs to
    ``dtype``, O2 those of every op not on the black list; O0 or
    ``enable=False`` casts nothing (also inside an enclosing
    ``auto_cast``)."""
    if level not in ("O0", "O1", "O2"):
        raise ValueError(f"level must be O0/O1/O2, got {level}")
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be 'bfloat16' or 'float16', got "
                         f"{dtype!r}")
    prev = _state.amp
    if enable and level != "O0":
        _state.amp = (level, _DTYPES[dtype],
                      frozenset(custom_white_list or ()),
                      frozenset(custom_black_list or ()))
    else:
        _state.amp = None
    try:
        with _AmpMode():
            yield
    finally:
        _state.amp = prev


amp_guard = auto_cast
