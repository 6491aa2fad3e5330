"""Op registry and eager dispatcher (a port of
``paddle_tpu/core/dispatch.py``).

An op is a pure torch function over tensors, registered by name with
:func:`register_op`; calling it with Tensors runs the function on their
torch values and wraps what it returns. Torch's autograd records the
graph as the function runs (the reference derives each op's backward
with ``jax.vjp``; here every torch function carries its own), so an
output's ``stop_gradient`` is False exactly when some input's is False
and grad is enabled, the reference's rule. ``differentiable=False`` ops
run without recording.

Under ``amp.auto_cast`` the op's float inputs are cast by the
reference's rule for its name (``amp/auto_cast.py``) and its body runs
uncast, as the reference casts at dispatch.

``no_grad`` / ``enable_grad`` / ``is_grad_enabled`` are torch's grad
mode, which is per thread as the reference's flag is; inside
``no_grad`` the port's GPT and engine record nothing either.
``FLAGS_check_nan_inf`` scans every float output.

While a static program is being built (``static.program``), an op called
with a symbolic ``Variable`` among its arguments appends a record to the
program, with the ``auto_cast`` dtype of its name, instead of running
(reference ``paddle_tpu/core/dispatch.py:125-140``); the eager path pays
one boolean test for it.
"""
import functools

import numpy as np
import torch

from ..amp.auto_cast import cast_inputs, op_body
from . import flags as flags_mod
from . import trace as _trace
from .tensor import Tensor, as_torch


def is_grad_enabled():
    return torch.is_grad_enabled()


class no_grad:
    """paddle.no_grad: context manager + decorator disabling recording."""

    def __enter__(self):
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(False)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with no_grad():
                return fn(*args, **kwargs)
        return wrapper


class enable_grad:
    def __enter__(self):
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(True)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev)
        return False


_REGISTRY = {}

# set by static.program: the Variable class, and whether a program is
# being built (so the eager path tests one boolean, not every argument)
_static_variable_cls = None
_static_active = False


def get_op(name):
    return _REGISTRY[name]


def _device_of(args):
    for a in args:
        if isinstance(a, Tensor):
            return a._value.device
        if isinstance(a, torch.Tensor):
            return a.device
    return None


class Op:
    """A differentiable primitive: a pure torch function.

    ``fn(*tensors, **attrs)``: every positional argument is a tensor (or
    None for an optional one; a python scalar passes through as it is),
    every keyword a static attribute. The public call takes Tensors,
    torch tensors, numpy arrays or python values positionally.
    """

    def __init__(self, name, fn, differentiable=True):
        self.name = name
        self.fn = fn
        self.differentiable = differentiable
        _REGISTRY[name] = self

    def __repr__(self):
        return f"<op {self.name}>"

    def __call__(self, *args, **attrs):
        if _static_active \
                and any(isinstance(a, _static_variable_cls) for a in args):
            return self._record(args, attrs)
        dev = None
        values = []
        hook = _trace._capture_hook   # analysis.birth's, None when off
        for a in args:
            if isinstance(a, Tensor):
                if hook is not None:
                    hook(a)
                values.append(a._value)
            elif a is None or isinstance(a, (torch.Tensor, bool, int, float)):
                values.append(a)
            else:
                if dev is None:
                    dev = _device_of(args)
                values.append(as_torch(np.asarray(a), device=dev))
        values = cast_inputs(self.name, *values)
        with op_body():
            if self.differentiable:
                outs = self.fn(*values, **attrs)
            else:
                with torch.no_grad():
                    outs = self.fn(*values, **attrs)
        multi = isinstance(outs, (tuple, list))
        out_list = list(outs) if multi else [outs]
        if flags_mod.get_flag("FLAGS_check_nan_inf"):
            _check_finite(self.name, out_list)
        wrapped = [Tensor._wrap(o) for o in out_list]
        return tuple(wrapped) if multi else wrapped[0]

    def _record(self, args, attrs):
        """Append this op to the building program (reference: the
        append_op path of every op helper), with the auto_cast dtype of
        its name as the record's cast."""
        from ..amp.auto_cast import _cast_dtype_for
        from ..static.program import building_program
        prog = building_program()
        if prog is None:
            raise RuntimeError(
                f"op {self.name!r} called on a static Variable outside "
                "a program_guard / enable_static context")
        return prog.append_op(self, args, attrs,
                              cast_dtype=_cast_dtype_for(self.name))


def _check_finite(op_name, out_list):
    for o in out_list:
        if (o.is_floating_point() or o.is_complex()) \
                and not bool(torch.isfinite(o).all()):
            raise FloatingPointError(
                f"Operator {op_name} output contains NaN or Inf "
                f"(FLAGS_check_nan_inf is set)")


def register_op(name, differentiable=True):
    """Decorator: register a pure torch function as a framework op."""
    def deco(fn):
        return Op(name, fn, differentiable=differentiable)
    return deco
