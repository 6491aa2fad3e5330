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

The reference's jit-mode ``bind``/``final_value`` have no counterpart.
Without a trace the hooks cost one attribute test (``_active``), as the
reference's do. ``_birth_hook`` and ``_capture_hook`` are set while
``analysis.birth`` tracking is on: the first stamps every Tensor made
under a trace with its birth site, the second sees every Tensor an op
reads; off, each costs one ``is not None`` test.
"""
import threading
import weakref

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


class RecordMode(TorchFunctionMode):
    """Under ``record``: every torch call's tensors and generators, for
    the leaves a replay hands grads back to and the generators a graph
    must register."""

    def __init__(self, ctx):
        super().__init__()
        self.ctx = ctx

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for a in args:
            _note(self.ctx, a)
        for a in kwargs.values():
            _note(self.ctx, a)
        return func(*args, **kwargs)


class _Guard:
    def __init__(self, ctx):
        self.ctx = ctx

    def __enter__(self):
        global _active
        if current_trace() is not None:
            raise RuntimeError("nested traces are not supported")
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
