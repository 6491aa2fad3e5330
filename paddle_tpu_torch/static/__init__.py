"""``paddle.static`` (a port of ``paddle_tpu/static/__init__.py``;
reference python/paddle/static/): the static-mode switch, programs
(``Program``, ``program_guard``, ``data``, ``append_backward``,
``Executor``; ``program.py``), control flow and ``fc`` (``nn.py``), and
the rest of the reference's surface.

``enable_static()`` does two jobs, as the reference's: the default main
program becomes the building program (an op on a ``static.data``
Variable records into it), and ``Model`` runs its steps through
``jit.to_static``. Ops on eager Tensors still run eagerly.
"""
import contextlib
import pickle

import numpy as np
import torch

from .input_spec import InputSpec  # noqa: F401
from .program import (  # noqa: F401
    Executor, Program, Variable, _set_building, append_backward,
    building_program, load_inference_model, program_guard,
    save_inference_model)

_static_mode = [False]
_default_main = Program()
_default_startup = Program()


def _enable():
    _static_mode[0] = True
    _set_building(_default_main)


def _disable():
    _static_mode[0] = False
    _set_building(None)


def enable_static():
    _enable()


def disable_static(place=None):
    _disable()


def in_dynamic_mode():
    return not _static_mode[0]


def default_main_program():
    return _default_main


def default_startup_program():
    return _default_startup


def data(name, shape, dtype="float32", lod_level=0):
    """Reference static.data: a feed Variable of the building program
    (outside static mode, an InputSpec, the to_static-era behaviour)."""
    prog = building_program()
    if prog is None:
        return InputSpec(shape, dtype, name)
    return prog.data(name, shape, dtype)


CompiledProgram = Program  # one device; data parallelism is fleet's

from ..amp import auto_cast as amp  # noqa: F401,E402
from . import nn  # noqa: F401,E402


class BuildStrategy:
    """Reference BuildStrategy: graph-pass switches, kept for
    introspection (the capture has no passes to switch)."""

    def __init__(self):
        self.enable_inplace = True
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = True
        self.memory_optimize = True
        self.reduce_strategy = 0
        self.gradient_scale_strategy = 0


class ExecutionStrategy:
    """Reference ExecutionStrategy: executor threading switches
    (advisory)."""

    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 100
        self.allow_op_delay = False


class ParallelExecutor:
    """Reference ParallelExecutor's construction API, running through
    ``Executor``."""

    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 build_strategy=None, exec_strategy=None, **kwargs):
        self._program = main_program or default_main_program()
        self._exe = Executor()

    def run(self, fetch_list=None, feed=None, return_numpy=True):
        return self._exe.run(self._program, feed=feed,
                             fetch_list=fetch_list,
                             return_numpy=return_numpy)


def cpu_places(device_count=None):
    """``device_count`` CPU places (1 by default: the port reads no
    ``CPU_NUM``)."""
    from ..core.device import CPUPlace
    return [CPUPlace() for _ in range(device_count or 1)]


def cuda_places(device_ids=None):
    from ..core.device import CUDAPlace
    ids = device_ids if device_ids is not None \
        else range(torch.cuda.device_count())
    return [CUDAPlace(int(i)) for i in ids]


def xpu_places(device_ids=None):
    """Reference static.xpu_places: no XPU here; the card's places, as
    the reference mirrors its own devices."""
    return cuda_places(device_ids)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """Reference layers.create_global_var: a persistable Tensor,
    registered with the building program."""
    from ..core.tensor import Tensor
    t = Tensor(np.full(shape, value, dtype), name=name, persistable=True)
    prog = building_program()
    if prog is not None:
        prog.register_persist(t)
    return t


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """Reference static.create_parameter: a Parameter (zeros for a bias,
    Xavier-normal otherwise, unless an initializer is given),
    registered with the building program."""
    from ..core.tensor import Parameter
    from ..nn import initializer as init_mod
    init = default_initializer or (init_mod.Constant(0.0) if is_bias
                                   else init_mod.XavierNormal())
    p = Parameter._own(init(tuple(shape), dtype), name=name)
    prog = building_program()
    if prog is not None:
        prog.register_persist(p)
    return p


class _Scope:
    def __init__(self):
        self.vars = {}

    def var(self, name):
        return self.vars.setdefault(name, None)

    def find_var(self, name):
        prog = building_program()
        if prog is not None and name in prog.persist:
            return prog.persist[name]
        return self.vars.get(name)


_GLOBAL_SCOPE = _Scope()


def global_scope():
    return _GLOBAL_SCOPE


@contextlib.contextmanager
def scope_guard(scope):
    yield scope


@contextlib.contextmanager
def device_guard(device=None):
    yield


@contextlib.contextmanager
def name_scope(prefix=None):
    yield


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Reference fluid/backward.py:1972: grad variables of ``targets``
    against persistable ``inputs`` in the building program."""
    t = targets[0] if isinstance(targets, (list, tuple)) else targets
    pg = append_backward(t, parameter_list=list(inputs)
                         if isinstance(inputs, (list, tuple)) else [inputs])
    return [g for _, g in pg]


def _state_of(program):
    from .program import _np
    return {n: _np(t) for n, t in program.persist.items()}


def _set_state(program, state):
    from .program import _tensor
    with torch.no_grad():
        for n, arr in state.items():
            if n in program.persist:
                t = program.persist[n]._value
                t.copy_(_tensor(arr).to(t.dtype))


def save(program, model_path, protocol=4, **kwargs):
    """Reference static.save: a program's persistables."""
    with open(model_path + ".pdparams", "wb") as f:
        pickle.dump(_state_of(program), f, protocol=protocol)


def load(program, model_path, executor=None, var_list=None):
    """Reference static.load: persistables back into a program, in
    place."""
    with open(model_path + ".pdparams", "rb") as f:
        _set_state(program, pickle.load(f))


def save_program_state(program):
    return _state_of(program)


def load_program_state(model_path, var_list=None):
    with open(model_path + ".pdparams", "rb") as f:
        return pickle.load(f)


def set_program_state(program, state):
    _set_state(program, state)


def serialize_program(feed_vars, fetch_vars, program=None, **kwargs):
    from .program import _serialize_program
    prog = program or building_program()
    return pickle.dumps(_serialize_program(prog.clone(for_test=True)),
                        protocol=4)


def deserialize_program(data):
    from .program import _deserialize_program
    return _deserialize_program(pickle.loads(data))


def serialize_persistables(feed_vars, fetch_vars, program=None, **kwargs):
    return pickle.dumps(_state_of(program or building_program()),
                        protocol=4)


def deserialize_persistables(program, data, executor=None):
    _set_state(program, pickle.loads(data))


def save_to_file(path, content):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path):
    with open(path, "rb") as f:
        return f.read()


def normalize_program(program, feed_vars, fetch_vars, **kwargs):
    return program.clone(for_test=True)


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """Reference py_func_op: Python inside the program (a host call: on
    the card the inputs come to the host and the result goes back, which
    a capture refuses). ``out`` gives the result's dtype."""
    from ..core.dispatch import register_op
    xs = x if isinstance(x, (list, tuple)) else [x]
    out_dt = out._value.dtype if hasattr(out, "_value") \
        and out._value is not None else torch.float32

    def _op(*arrs):
        host = [a.detach().cpu().numpy() for a in arrs]
        res = np.asarray(func(*host))
        return torch.as_tensor(res).to(device=arrs[0].device, dtype=out_dt)
    op = register_op(f"py_func_{id(func)}", differentiable=False)(_op)
    return op(*xs)


def accuracy(input, label, k=1, correct=None, total=None):  # noqa: A002
    """Reference static accuracy layer."""
    from ..metric import accuracy as _acc
    return _acc(input, label, k=k)


def auc(input, label, curve="ROC", num_thresholds=200, **kwargs):  # noqa: A002
    """Reference static auc layer: the batch's ROC AUC (trapezoids over
    the sorted scores)."""
    from ..core.tensor import Tensor
    v = input._value
    probs = v[:, 1] if v.shape[-1] == 2 else v.reshape(-1)
    lab = label._value.reshape(-1)
    order = torch.argsort(-probs, stable=True)
    lab_sorted = lab[order].to(torch.float32)
    tps = torch.cumsum(lab_sorted, 0)
    fps = torch.cumsum(1.0 - lab_sorted, 0)
    pos = torch.clamp(tps[-1], min=1e-6)
    neg = torch.clamp(fps[-1], min=1e-6)
    zero = torch.zeros(1, device=v.device)
    tpr = torch.cat([zero, tps / pos])
    fpr = torch.cat([zero, fps / neg])
    return Tensor._wrap(torch.trapezoid(tpr, fpr))


class Print:
    """Reference Print op: a debugging passthrough."""

    def __new__(cls, input, message=None, **kwargs):  # noqa: A002
        print(message or "", input)
        return input


class WeightNormParamAttr:
    """Reference WeightNormParamAttr, for the API (weight norm itself is
    nn.utils.weight_norm)."""

    def __init__(self, dim=None, name=None, initializer=None, **kwargs):
        self.dim = dim
        self.name = name
        self.initializer = initializer
