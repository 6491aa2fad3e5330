"""Program-capture (trace) context (a port of ``paddle_tpu/core/trace.py``).

The reference captures a step as one XLA program: its ``record`` phase
runs the step eagerly and notes which pre-existing Tensors it reads and
writes, and its ``jit`` phase re-runs it under ``jax.jit`` with those
Tensors bound to tracers. The port captures a step as a CUDA graph
(``jit/to_static.py``), which reads and writes memory by address, so
there is nothing to bind:

- ``record``: the step runs eagerly while the Tensor hooks note every
  write to a Tensor that existed before the call (``value``'s setter,
  ``_assign``, ``grad``'s setter) and every rebinding of one (its
  ``_value`` replaced, as ``stop_gradient``'s setter and the in-place
  reshapes do). A graph replays writes into the storage the capture saw;
  a Tensor that was rebound holds other storage by then, so
  ``to_static`` refuses to capture a step that rebinds one. A
  ``RecordMode`` beside the context collects the torch leaves that
  require grad (whose ``.grad`` a replay hands back) and the CUDA
  generators the step draws from (each registered with the graph, so a
  replay draws anew).
- ``capture``: the step runs under ``torch.cuda.graph``. A host read of
  a CUDA Tensor (``numpy``, ``item``, ``tolist``, ``float``, ``int``, a
  Tensor ``if`` that no conversion turned into ``static.nn.cond``) or a
  rebinding raises ``ToStaticError`` before it reaches the device. The
  context holds the graph being captured and its pools, so that
  ``static.nn.cond``/``while_loop`` capture their branches and bodies
  into conditional nodes (``core/graph_cond.py``).

With ``ctx.ops`` a list (``analysis.lint`` sets it, and the record of a
``to_static(..., lint=True)`` function), ``RecordMode`` also keeps the
op list the lint passes walk: one ``OpRecord`` per torch call (its
name, its inputs' and outputs' shapes, dtypes and devices, the user's
call site, the inputs it writes in place) and one per host read
(``item``, ``tolist``, ``numpy``, a Tensor's ``bool``/``float``/
``int``). With ``ctx.placeholders`` (a
recording on ``meta`` tensors, which hold no values) a host read of a
meta tensor gives zeros, so the walk goes on past it.

The reference's jit-mode ``bind``/``final_value`` have no counterpart.
Without a trace the hooks cost one attribute test (``_active``), as the
reference's do. ``_birth_hook`` and ``_capture_hook`` are set while
``analysis.birth`` tracking is on: the first stamps every Tensor made
under a trace with its birth site, the second sees every Tensor an op
reads; off, each costs one ``is not None`` test.
"""
import os
import sys
import threading
import weakref

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from .errors import PreconditionNotMetError

_state = threading.local()

# The context every hook reports to while a trace runs, None otherwise.
# Module-global, not thread-local: a step's backward runs on autograd's
# device threads, and what it does belongs to the same capture.
_active = None

# analysis.birth's hooks (None while tracking is off)
_birth_hook = None
_capture_hook = None

# True while static.nn warms a branch or loop body that the record call
# did not take, in a capture that never runs (static/nn.py)
_warming = False


def capture_stream():
    """This thread's capture stream on the current device, made once.
    Every ``to_static`` function and the lazy executor warm up and
    capture on it: cuBLAS keeps a workspace for each stream it runs on
    for the life of the process, and each workspace, carved from a
    segment of the caching allocator, keeps that whole segment
    reserved."""
    streams = getattr(_state, "capture_streams", None)
    if streams is None:
        streams = _state.capture_streams = {}
    dev = torch.cuda.current_device()
    s = streams.get(dev)
    if s is None:
        s = streams[dev] = torch.cuda.Stream()
    return s


class ToStaticError(PreconditionNotMetError):
    """A step that ``jit.to_static`` cannot capture as a CUDA graph."""


def current_trace():
    """The trace this thread runs under, or None."""
    return getattr(_state, "trace", None)


def adopt(tensor):
    """Register ``tensor`` as made by the active trace (every Tensor
    built through ``Tensor()`` or ``Tensor._wrap`` is registered at its
    birth; this is for one built otherwise)."""
    if _active is not None:
        _active.register_created(tensor)
    return tensor


class TraceContext:
    def __init__(self, mode):
        assert mode in ("record", "capture")
        self.mode = mode
        # id(tensor) -> tensor: pre-existing Tensors written / rebound
        self.writes = {}
        self.rebinds = {}
        # id(tensor) -> weakref of the Tensors made during this run.
        # Membership MUST go through is_created(): a dead tensor's id can
        # be recycled by a later allocation.
        self.created = {}
        # filled by RecordMode: id -> torch leaf requiring grad, CUDA
        # generators drawn from, whether any CUDA tensor was touched
        self.leaves = {}
        self.generators = {}
        self.cuda = False
        # under capture: the CUDAGraph being captured, the pool its
        # conditional bodies allocate from, and the card's counter of the
        # kernel launches captured inside those bodies (jit/to_static.py
        # sets them; core/graph_cond.py adds to the counter)
        self.graph = None
        self.body_pool = None
        self.cond_launches = None
        self.cond_counted = False
        # the op list analysis.lint walks (None: not kept), the id of each
        # input's root tensor -> its index, and whether a host read of a
        # meta tensor gives zeros
        self.ops = None
        self.invar_ids = {}
        self.placeholders = False

    def write(self, tensor):
        if not self.is_created(tensor):
            self.writes[id(tensor)] = tensor

    def rebind(self, tensor):
        if self.is_created(tensor):
            return
        if self.mode == "capture":
            raise ToStaticError(
                f"Tensor {tensor.name!r} is rebound (its storage replaced) "
                "inside a captured step: a CUDA graph replays into the "
                "storage it captured. Write it in place (set_value) "
                "instead.")
        self.rebinds[id(tensor)] = tensor

    def host_read(self, tensor, what):
        """``what`` (numpy, item, bool, ...) reads ``tensor`` on the
        host: under capture, a CUDA tensor's read is a sync the graph
        cannot hold."""
        if self.ops is not None:
            v = tensor._value
            self.ops.append(OpRecord(what, (_aval(v),), (), call_site(),
                                     kind="host_read"))
        if self.mode != "capture" or not tensor._value.is_cuda:
            return
        if what == "bool":
            raise ToStaticError(
                f"a Tensor `if` (bool of {tensor.name!r}) inside a captured "
                "step that no dy2static conversion reached: to_static "
                "converts the decorated function's own if/while/for "
                "(not its callees, nor with enable_ast=False); write the "
                "branch with static.nn.cond, or compute both branches and "
                "select with where()")
        raise ToStaticError(
            f"{what}() of Tensor {tensor.name!r} inside a captured step: "
            "a host read syncs the card, which a CUDA graph cannot "
            "capture; return the tensor from the step and read it after")

    def register_created(self, tensor):
        self.created[id(tensor)] = weakref.ref(tensor)

    def is_created(self, tensor):
        """Was THIS tensor (identity, not a recycled id) made during the
        trace?"""
        ref = self.created.get(id(tensor))
        return ref is not None and ref() is tensor


def refuse_in_capture(what):
    """Raise ``ToStaticError`` when a capture runs: ``what`` keeps its
    state on the host, so a graph would change it once, at capture, and
    never on a replay. The record call's warm-up of an untaken branch is
    refused too: its capture never runs, so state made there would keep
    no values."""
    if _active is None:
        return
    if _active.mode == "capture":
        raise ToStaticError(f"{what} inside a captured step")
    if _warming:
        raise ToStaticError(
            f"{what} inside a branch or loop body that to_static's record "
            "call did not take: that body is warmed in a capture that "
            "never runs, so the state would be left without its values. "
            "Let an eager call take that body first")


def _note(ctx, obj):
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            ctx.cuda = True
        if obj.requires_grad and obj.is_leaf:
            ctx.leaves[id(obj)] = obj
    elif isinstance(obj, torch.Generator):
        if obj.device.type == "cuda":
            ctx.generators[id(obj)] = obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            if isinstance(o, (torch.Tensor, torch.Generator)):
                _note(ctx, o)


class OpRecord:
    """One recorded call: ``name`` (``torch.matmul``, ``Tensor.add_``, a
    host read's ``item``), ``inputs``/``outputs`` as ``(shape, dtype,
    device)``, ``site`` (``file:line (function)`` of the user frame),
    ``kind`` (``op`` or ``host_read``) and ``writes``, the indices of
    the program's inputs it writes in place."""
    __slots__ = ("name", "inputs", "outputs", "site", "kind", "writes")

    def __init__(self, name, inputs, outputs, site, kind="op", writes=()):
        self.name = name
        self.inputs = inputs
        self.outputs = outputs
        self.site = site
        self.kind = kind
        self.writes = tuple(writes)

    def __repr__(self):
        return (f"OpRecord({self.name!r}, {self.kind}, in={self.inputs}, "
                f"out={self.outputs}, site={self.site!r})")


def _aval(t):
    return (tuple(t.shape), t.dtype, t.device.type)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [o for o in obj if isinstance(o, torch.Tensor)]
    return []


def root_tensor(t):
    """The tensor ``t`` is a view of (itself when it is none)."""
    while t._base is not None:
        t = t._base
    return t


_TORCH_DIR = os.path.dirname(torch.__file__)
_CORE_DIR = os.path.dirname(os.path.abspath(__file__))
_SKIP_DIRS = (_TORCH_DIR, _CORE_DIR,
              os.path.join(os.path.dirname(_CORE_DIR), "amp"),
              os.path.dirname(os.path.abspath(__import__("contextlib").__file__)))


def call_site():
    """``file:line (function)`` of the nearest frame outside torch, the
    port's core and ``amp`` (the dispatch layers), "<unknown>" if none."""
    f = sys._getframe(1)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if not fn.startswith(_SKIP_DIRS):
            return f"{fn}:{f.f_lineno} ({f.f_code.co_name})"
        f = f.f_back
    return "<unknown>"


# torch calls that read a tensor's values on the host
HOST_READS = frozenset({"item", "tolist", "numpy", "__bool__", "__float__",
                        "__int__", "__index__"})


def _op_name(func):
    name = getattr(func, "__name__", repr(func))
    qual = getattr(func, "__qualname__", "")
    if qual.startswith("TensorBase.") or qual.startswith("Tensor."):
        return "Tensor." + name
    mod = getattr(func, "__module__", None) or "torch"
    return f"{mod}.{name}" if not mod.startswith("torch._C") \
        else f"torch.{name}"


def _placeholder(what, t):
    """What a host read of the meta tensor ``t`` gives while recording."""
    zeros = np.zeros(tuple(t.shape), dtype=torch.empty(
        (), dtype=t.dtype).numpy().dtype)
    if what == "numpy":
        return zeros
    if what == "tolist":
        return zeros.tolist()
    if what == "__bool__":
        return False
    if what == "__float__":
        return 0.0
    return zeros.reshape(-1)[0].item() if zeros.size else 0


class RecordMode(TorchFunctionMode):
    """Under ``record``: every torch call's tensors and generators, for
    the leaves a replay hands grads back to and the generators a graph
    must register; with ``ctx.ops`` a list, the op list too."""

    def __init__(self, ctx):
        super().__init__()
        self.ctx = ctx

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ctx = self.ctx
        for a in args:
            _note(ctx, a)
        for a in kwargs.values():
            _note(ctx, a)
        if ctx.ops is None:
            return func(*args, **kwargs)
        name = getattr(func, "__name__", "")
        if name in HOST_READS and args \
                and isinstance(args[0], torch.Tensor):
            t = args[0]
            ctx.ops.append(OpRecord(name.strip("_"), (_aval(t),), (),
                                    call_site(), kind="host_read"))
            if ctx.placeholders and t.device.type == "meta":
                return _placeholder(name, t)
            return func(*args, **kwargs)
        ins = [t for a in args for t in _tensors(a)] \
            + [t for a in kwargs.values() for t in _tensors(a)]
        out = func(*args, **kwargs)
        written = []
        if (name.endswith("_") and not name.startswith("__")) \
                or name == "__setitem__":
            written = ins[:1]
        if "out" in kwargs:
            written = written + _tensors(kwargs["out"])
        writes = sorted({ctx.invar_ids[id(root_tensor(t))] for t in written
                         if id(root_tensor(t)) in ctx.invar_ids})
        ctx.ops.append(OpRecord(_op_name(func), tuple(map(_aval, ins)),
                                tuple(map(_aval, _tensors(out))),
                                call_site(), writes=writes))
        return out


class _Guard:
    def __init__(self, ctx):
        self.ctx = ctx

    def __enter__(self):
        global _active
        if current_trace() is not None:
            raise RuntimeError("nested traces are not supported")
        from . import lazy
        lazy.flush()    # a pending lazy graph runs before the trace
        _state.trace = self.ctx
        _active = self.ctx
        return self.ctx

    def __exit__(self, *exc):
        global _active
        _state.trace = None
        _active = None
        return False


def trace_guard(ctx):
    return _Guard(ctx)
