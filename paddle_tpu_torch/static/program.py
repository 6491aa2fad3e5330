"""Static-graph programs (a port of ``paddle_tpu/static/program.py``):
symbolic capture, ``append_backward``, ``Executor``.

Under ``enable_static()`` (or a ``program_guard``) a registered op
called with a symbolic ``Variable`` appends a record to the building
``Program`` instead of running (``core/dispatch.py``); the program is an
editable op-list IR (``global_block().ops``, ``op.type``,
``input_names()``, ``output_names()``, ``attrs``). Parameters stay eager
Tensors, registered as the program's persistables; the startup program
has nothing to do. A ``Variable`` is a ``Tensor`` whose value is a
``meta`` tensor of its shape (an unknown dim as 1, as the reference's
``eval_shape`` takes it), so the surface's Tensor paths take it and an
op's output shapes come from running its torch function on meta
tensors.

``Executor.run`` interprets the op list on torch tensors: a
``GradRecord`` is ``torch.autograd.grad`` of the loss the forward
records computed, against the listed persistables; an ``UpdateRecord``
(``Optimizer.minimize`` of a Variable) runs the optimizer's own clip and
per-parameter update on those grads, in place. On the CPU the list runs
eagerly. On the card it runs inside one ``jit.to_static`` function for
each (program version, feed signature, fetch names): its first call
eager, its second recorded, then one CUDA graph replayed, the port's
form of the reference's "one jitted function per feed signature".
Feeds (numpy arrays) go to the device before the call; fetches come back
as numpy (a bfloat16 fetch as float32, numpy having no bfloat16;
``return_numpy=False`` keeps the Tensor).

The reference records each optimizer update through its op hooks; the
port's updates are torch-level, so one ``UpdateRecord`` stands for them
(the op list differs, the values do not). Programs serialize by op name
(``save_inference_model``), in the reference's format, so a program file
crosses between the packages both ways.
"""
import pickle
import threading

import numpy as np
import torch

from ..amp.auto_cast import op_body
from ..core import dtype as dtype_mod
from ..core.tensor import Tensor, as_torch

_state = threading.local()


def _register_with_dispatch():
    from ..core import dispatch
    dispatch._static_variable_cls = Variable


def building_program():
    """The Program currently capturing ops, or None (eager)."""
    return getattr(_state, "program", None)


def _set_building(prog):
    _state.program = prog
    # the dispatcher's gate: one boolean test on the eager path. It is
    # process-wide while the building state is per thread, as the
    # reference's (building from two threads at once is not supported)
    from ..core import dispatch
    dispatch._static_active = prog is not None


class _Absent:
    """A Tensor method a Variable does not have (the reference's
    ``patch_symbolic`` attaches no in-place mutator): reading it raises
    AttributeError, so ``hasattr`` is False."""

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, obj, owner=None):
        raise AttributeError(
            f"a static Variable has no {self.name!r}: in-place mutators "
            "bypass the recording op layer")


def _meta(shape, dtype):
    return torch.empty(tuple(1 if s == -1 else s for s in shape),
                       dtype=dtype, device="meta")


class Variable(Tensor):
    """A symbolic program variable (reference framework.py Variable): its
    name, shape (-1 for an unknown dim) and dtype; values exist only at
    ``Executor.run``. The Tensor method surface records (the reference's
    ``patch_symbolic``), except the in-place mutators and the comparison
    operators: an elementwise ``__eq__`` would make a Variable
    unhashable, so comparison is identity, as the reference's."""

    __slots__ = ("_shape", "program", "_stop")
    _symbolic = True

    def __init__(self, name, shape, dtype, program, stop_gradient=True):
        self._shape = tuple(-1 if s is None else int(s) for s in shape)
        self._value = _meta(self._shape, dtype_mod.to_torch_dtype(dtype))
        self.name = name
        self.program = program
        self._stop = stop_gradient
        self.persistable = False
        self.trainable = True

    @property
    def shape(self):
        return list(self._shape)

    def aval_shape(self):
        return self._shape

    @property
    def stop_gradient(self):
        return self._stop

    @stop_gradient.setter
    def stop_gradient(self, stop):
        self._stop = bool(stop)

    @property
    def value(self):
        # a recorded write-back (``t.value = var.value``, the optimizer
        # and batch-norm pattern) reads the Variable itself
        if building_program() is not None:
            return self
        raise RuntimeError(
            f"Variable {self.name!r} has no value outside Executor.run; "
            "fetch it via fetch_list")

    @value.setter
    def value(self, v):
        raise RuntimeError(f"Variable {self.name!r} is symbolic")

    @property
    def grad(self):
        return None

    def numpy(self):
        raise RuntimeError(
            f"Variable {self.name!r} is symbolic; run the program and "
            "fetch it to get values")

    def item(self, *args):
        return self.numpy()

    tolist = item

    def backward(self, *args, **kwargs):
        raise RuntimeError(
            f"Variable {self.name!r} is symbolic: use append_backward or "
            "Optimizer.minimize")

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={list(self._shape)}, "
                f"dtype={self.dtype.name})")

    def __bool__(self):
        return True

    __eq__ = object.__eq__
    __ne__ = object.__ne__
    __lt__ = object.__lt__
    __le__ = object.__le__
    __gt__ = object.__gt__
    __ge__ = object.__ge__
    __hash__ = object.__hash__


def _block_inplace():
    """Every in-place method of the Tensor surface (a name ending in one
    underscore) is absent on a Variable, and so is item assignment."""
    for name in dir(Tensor):
        if name.endswith("_") and not name.startswith("__") \
                and not name.startswith("_"):
            absent = _Absent()
            absent.__set_name__(Variable, name)
            setattr(Variable, name, absent)
    absent = _Absent()
    absent.__set_name__(Variable, "__setitem__")
    Variable.__setitem__ = absent


class OpRecord:
    """One recorded op (reference: OpDesc). ``in_refs`` entries are
    variable names (str), ``("#const", value)`` or None; ``writebacks``
    map an output index to the persistable Tensor it updates at the end
    of the run."""

    __slots__ = ("op", "in_refs", "out_names", "attrs", "writebacks",
                 "cast")

    def __init__(self, op, in_refs, out_names, attrs, cast=None):
        self.op = op
        self.in_refs = in_refs
        self.out_names = out_names
        self.attrs = attrs
        self.writebacks = {}
        # AMP: float inputs are cast to this torch dtype before the op
        # (the auto_cast state the op was recorded under)
        self.cast = cast

    @property
    def type(self):
        return self.op.name

    def input_names(self):
        return [r for r in self.in_refs if isinstance(r, str)]

    def output_names(self):
        return list(self.out_names)

    def __repr__(self):
        ins = [r if isinstance(r, str)
               else ("<const>" if r is not None else "None")
               for r in self.in_refs]
        return f"{{{self.type}: ({', '.join(ins)}) -> {self.out_names}}}"


class ConstRecord:
    """A constant bound to a program variable (the symbolic
    fill_constant)."""

    __slots__ = ("name", "array")
    type = "fill_constant"

    def __init__(self, name, array):
        self.name = name
        self.array = array

    def __repr__(self):
        return f"{{fill_constant -> {self.name}}}"


class AliasRecord:
    """``env[dst] = env[src]``: fluid's in-place contract expressed
    functionally."""

    __slots__ = ("src", "dst")
    type = "@alias"

    def __init__(self, src, dst):
        self.src = src
        self.dst = dst

    def __repr__(self):
        return f"{{@alias: {self.src} -> {self.dst}}}"


class WhileRecord:
    """fluid.layers.While's sub-block (reference control_flow.py:973):
    the body records run while the carried condition holds; the carry is
    the variables the body aliases into. Not differentiable, as the
    reference's."""

    __slots__ = ("cond_name", "body", "carry_names")
    type = "while"

    def __init__(self, cond_name, body, carry_names):
        self.cond_name = cond_name
        self.body = body
        self.carry_names = carry_names

    def __repr__(self):
        return (f"{{while[{self.cond_name}]: {len(self.body)} body ops, "
                f"carry {self.carry_names}}}")


class ScanRecord:
    """fluid.layers.StaticRNN's sub-block (reference
    control_flow.py:451): the body runs over the sequence axis, memories
    carried, step outputs stacked; differentiable."""

    __slots__ = ("body", "seq_inputs", "mems", "out_pairs")
    type = "recurrent"

    def __init__(self, body, seq_inputs, mems, out_pairs):
        self.body = body
        self.seq_inputs = seq_inputs   # [(placeholder name, sequence name)]
        # [(mem name, init spec, updated name)]; the spec is a variable
        # name or ("zeros", shape, value, dtype), -1 dims the batch
        self.mems = mems
        self.out_pairs = out_pairs     # [(body output, program output)]

    def __repr__(self):
        return (f"{{recurrent: {len(self.body)} body ops, "
                f"xs {self.seq_inputs}, mems {self.mems}}}")


class GradRecord:
    """Gradient boundary (reference: the grad-op chain append_backward
    inserts): at run time ``torch.autograd.grad`` of the loss against
    the listed persistables."""

    __slots__ = ("loss_name", "params", "grad_names", "upto")
    type = "@grad"

    def __init__(self, loss_name, params, grad_names, upto):
        self.loss_name = loss_name
        self.params = params
        self.grad_names = grad_names
        self.upto = upto  # the forward records the grad is of

    def __repr__(self):
        return (f"{{@grad: d{self.loss_name}/d["
                f"{', '.join(p.name for p in self.params)}]}}")


class UpdateRecord:
    """``Optimizer.minimize`` of a Variable: at run time the optimizer's
    clip, L1 decay and per-parameter update over (parameter, grad
    variable) pairs, each parameter written in place."""

    __slots__ = ("optimizer", "pairs")
    type = "@update"

    def __init__(self, optimizer, pairs):
        self.optimizer = optimizer
        self.pairs = pairs   # [(parameter as given, grad variable name)]

    def __repr__(self):
        return (f"{{@update {type(self.optimizer).__name__}: "
                f"{len(self.pairs)} params}}")


def _to_leaf(t):
    """A persistable's torch value as a leaf: an eager op's output keeps
    no build-time graph (the reference's persistables are values)."""
    v = t._value
    if v.grad_fn is None:
        return t
    leaf = Tensor._wrap(v.detach(), name=t.name)
    if v.requires_grad:
        leaf._value.requires_grad_(True)
    return leaf


def _meta_of(v, cast):
    if isinstance(v, torch.Tensor):
        m = torch.empty(v.shape, dtype=v.dtype, device="meta")
    else:
        return v
    if cast is not None and m.is_floating_point():
        m = m.to(cast)
    return m


def _infer(op, values, attrs, cast):
    """The op's outputs for ``values`` (meta tensors), or, where a torch
    function has no meta kernel, for zeros of the same shapes on the
    CPU."""
    ins = [_meta_of(v, cast) for v in values]
    with torch.no_grad(), op_body():
        try:
            return op.fn(*ins, **attrs)
        except (NotImplementedError, RuntimeError):
            cpu = [torch.zeros(v.shape, dtype=v.dtype)
                   if isinstance(v, torch.Tensor) else v for v in ins]
            return op.fn(*cpu, **attrs)


class Program:
    """An editable op-list program (reference framework.py Program; one
    block)."""

    def __init__(self):
        self.ops = []
        self.vars = {}
        self.persist = {}    # name -> Tensor (parameters, optimizer state)
        self.feed_names = []
        self._counter = [0]
        self._layer_cache = {}  # static.nn name -> layer (per program)
        self.random_seed = None

    # -- building ---------------------------------------------------------
    def _new_name(self, hint):
        self._counter[0] += 1
        return f"{hint}.tmp_{self._counter[0]}"

    def data(self, name, shape, dtype="float32"):
        shape = [(-1 if s is None else int(s)) for s in shape]
        v = Variable(name, shape, dtype, self)
        self.vars[name] = v
        if name not in self.feed_names:
            self.feed_names.append(name)
        return v

    def register_persist(self, tensor):
        if tensor.name not in self.persist:
            self.persist[tensor.name] = _to_leaf(tensor)
        return tensor.name

    def const_var(self, array, hint="fill_constant"):
        """Record a constant and return its Variable (the symbolic
        fill_constant)."""
        t = torch.as_tensor(np.asarray(array)) \
            if not isinstance(array, torch.Tensor) else array
        name = self._new_name(hint)
        v = Variable(name, t.shape, t.dtype, self)
        self.vars[name] = v
        self.ops.append(ConstRecord(name, t))
        return v

    def placeholder_var(self, shape, dtype, hint):
        """A variable bound at run time by an enclosing control-flow
        record (StaticRNN step inputs and memories)."""
        name = self._new_name(hint)
        v = Variable(name, shape, dtype, self)
        self.vars[name] = v
        return v

    def alias(self, src_var, dst_var):
        self.ops.append(AliasRecord(src_var.name, dst_var.name))
        return dst_var

    def append_op(self, op, args, attrs, cast_dtype=None):
        """Called from ``Op.__call__`` while building: records instead
        of running; output shapes from the op on meta tensors."""
        in_refs = []
        values = []
        for a in args:
            if isinstance(a, Variable):
                in_refs.append(a.name)
                values.append(a._value)
            elif isinstance(a, Tensor):
                name = self.register_persist(a)
                in_refs.append(name)
                values.append(a._value)
            elif a is None:
                in_refs.append(None)
                values.append(None)
            elif isinstance(a, (bool, int, float)):
                in_refs.append(("#const", a))
                values.append(a)
            else:
                t = a if isinstance(a, torch.Tensor) \
                    else torch.as_tensor(np.asarray(a))
                in_refs.append(("#const", t))
                values.append(t)
        outs = _infer(op, values, attrs, cast_dtype)
        multi = isinstance(outs, (tuple, list))
        out_vars = []
        for o in (list(outs) if multi else [outs]):
            name = self._new_name(op.name)
            v = Variable(name, o.shape, o.dtype, self, stop_gradient=False)
            self.vars[name] = v
            out_vars.append(v)
        self.ops.append(OpRecord(op, in_refs, [v.name for v in out_vars],
                                 dict(attrs), cast=cast_dtype))
        return tuple(out_vars) if multi else out_vars[0]

    def mark_writeback(self, out_var, target_tensor):
        """The newest producer of ``out_var`` updates ``target_tensor`` at
        the end of each run (the batch-norm statistics' pattern)."""
        for rec in reversed(self.ops):
            if isinstance(rec, OpRecord) and out_var.name in rec.out_names:
                rec.writebacks[rec.out_names.index(out_var.name)] = \
                    target_tensor
                self.persist.setdefault(target_tensor.name, target_tensor)
                return
        raise ValueError(f"no producer for {out_var.name}")

    def append_backward(self, loss, parameter_list=None):
        """Reference fluid/backward.py:1377: ``[(param, grad_var)]``, the
        grad of the forward recorded so far."""
        if not isinstance(loss, Variable):
            raise TypeError("append_backward needs a program Variable loss")
        params = parameter_list
        if params is None:
            params = [t for t in self.persist.values()
                      if getattr(t, "trainable", True)
                      and not t.stop_gradient]
        # a parameter no record reads still gets its (zero) grad
        params = [self.persist[self.register_persist(p)] for p in params]
        grad_names = []
        for p in params:
            gname = p.name + "@GRAD"
            self.vars[gname] = Variable(gname, tuple(p.shape),
                                        p._value.dtype, self)
            grad_names.append(gname)
        self.ops.append(GradRecord(loss.name, list(params), grad_names,
                                   len(self.ops)))
        return [(p, self.vars[g]) for p, g in zip(params, grad_names)]

    # -- introspection ----------------------------------------------------
    def global_block(self):
        return self

    def all_parameters(self):
        return list(self.persist.values())

    def clone(self, for_test=False):
        c = Program()
        c.ops = list(self.ops)
        c.vars = dict(self.vars)
        c.persist = dict(self.persist)
        c.feed_names = list(self.feed_names)
        c._counter = self._counter
        c._layer_cache = self._layer_cache
        if for_test:
            # reference Program.clone: everything from the first gradient
            # boundary on goes, and state write-backs are stripped while
            # the ops' outputs stay for their readers
            def strip(recs):
                out = []
                for r in recs:
                    if getattr(r, "writebacks", None):
                        out.append(OpRecord(r.op, r.in_refs, r.out_names,
                                            r.attrs, cast=r.cast))
                    elif isinstance(r, WhileRecord):
                        out.append(WhileRecord(r.cond_name, strip(r.body),
                                               r.carry_names))
                    elif isinstance(r, ScanRecord):
                        out.append(ScanRecord(strip(r.body), r.seq_inputs,
                                              r.mems, r.out_pairs))
                    else:
                        out.append(r)
                return out

            fwd = []
            for r in c.ops:
                if isinstance(r, GradRecord):
                    break
                fwd.append(r)
            c.ops = strip(fwd)
        return c

    def to_string(self, throw_on_error=False, with_details=False):
        lines = [f"Program(ops={len(self.ops)}, feeds={self.feed_names}, "
                 f"persist={list(self.persist)})"]
        lines += [f"  {rec!r}" for rec in self.ops]
        return "\n".join(lines)

    __str__ = to_string

    def _version(self):
        """A fingerprint the Executor's cache holds while the op list is
        unchanged: record identities catch appends, deletions and
        replacements, the attributes' reprs catch edits in place."""
        return hash((tuple(id(r) for r in self.ops),
                     tuple(repr(getattr(r, "attrs", None))
                           for r in self.ops)))


class program_guard:
    """Reference static.program_guard: building goes to ``main``."""

    def __init__(self, main_program=None, startup_program=None):
        self.main = main_program if main_program is not None else Program()
        self.startup = startup_program

    def __enter__(self):
        self._saved = building_program()
        _set_building(self.main)
        return self

    def __exit__(self, *exc):
        _set_building(self._saved)
        return False


# -- execution ---------------------------------------------------------------

def _cast(v, cast):
    if cast is not None and isinstance(v, torch.Tensor) \
            and v.is_floating_point():
        return v.to(cast)
    return v


class _Run:
    """One interpretation of a record list over ``env`` (name -> torch
    tensor). ``consts`` holds every constant already on the run's device
    (a copy from the host cannot be captured); ``written`` collects the
    persistables' write-backs, applied when the run ends."""

    def __init__(self, consts, device):
        self.consts = consts
        self.device = device
        self.written = {}

    def const(self, value):
        if isinstance(value, torch.Tensor):
            return self.consts[id(value)]
        return value

    def run(self, records, env, drops=None):
        """Interpret ``records`` over ``env``; ``drops`` (index -> names)
        lets go of each variable after the record that reads it last,
        as an eager step frees its intermediates (autograd keeps what a
        backward needs on its own)."""
        for i, rec in enumerate(records):
            self._one(i, rec, records, env)
            for name in (drops or {}).get(i, ()):
                env.pop(name, None)

    def _one(self, i, rec, records, env):
        if isinstance(rec, ConstRecord):
            env[rec.name] = self.consts[id(rec.array)]
        elif isinstance(rec, AliasRecord):
            env[rec.dst] = env[rec.src]
        elif isinstance(rec, WhileRecord):
            self._while(rec, env)
        elif isinstance(rec, ScanRecord):
            self._scan(rec, env)
        elif isinstance(rec, GradRecord):
            self._grad(rec, env, records[i + 1:])
        elif isinstance(rec, UpdateRecord):
            rec.optimizer._apply_grads([(p, env[g]) for p, g in rec.pairs])
        else:
            self._op(rec, env)

    def _op(self, rec, env):
        ins = []
        for r in rec.in_refs:
            if r is None:
                ins.append(None)
            elif isinstance(r, str):
                ins.append(_cast(env[r], rec.cast))
            else:
                ins.append(_cast(self.const(r[1]), rec.cast))
        with op_body():
            if rec.op.differentiable:
                outs = rec.op.fn(*ins, **rec.attrs)
            else:
                with torch.no_grad():
                    outs = rec.op.fn(*ins, **rec.attrs)
        out_list = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        for name, o in zip(rec.out_names, out_list):
            env[name] = o
        for idx, target in rec.writebacks.items():
            env[target.name] = out_list[idx]
            self.written[target.name] = (target, out_list[idx])

    def _grad(self, rec, env, rest):
        ins = [env[p.name] for p in rec.params]
        loss = env[rec.loss_name]
        more = any(isinstance(r, GradRecord) for r in rest)
        need = [i for i, v in enumerate(ins) if v.requires_grad]
        grads = [None] * len(ins)
        if loss.requires_grad and need:
            got = torch.autograd.grad(loss, [ins[i] for i in need],
                                      retain_graph=more, allow_unused=True)
            for i, g in zip(need, got):
                grads[i] = g
        for name, v, g in zip(rec.grad_names, ins, grads):
            env[name] = torch.zeros_like(v) if g is None else g.detach()

    def _while(self, rec, env):
        from . import nn as snn
        names = list(rec.carry_names)
        cidx = names.index(rec.cond_name)

        def cond(*carry):
            return Tensor._wrap(carry[cidx]._value)

        def body(*carry):
            env2 = dict(env)
            env2.update(zip(names, (c._value for c in carry)))
            self.run(rec.body, env2)
            return [Tensor._wrap(env2[n]) for n in names]

        final = snn.while_loop(cond, body,
                               [Tensor._wrap(env[n]) for n in names])
        env.update(zip(names, (f._value for f in final)))

    def _scan(self, rec, env):
        xs = [env[src] for _, src in rec.seq_inputs]
        batch = xs[0].shape[1] if xs and xs[0].dim() > 1 else 1
        carry = []
        for _, spec, _ in rec.mems:
            if isinstance(spec, str):
                carry.append(env[spec])
            else:
                _, shape, value, dt = spec
                shape = tuple(batch if s in (-1, None) else int(s)
                              for s in shape)
                carry.append(torch.full(shape, value,
                                        dtype=dtype_mod.to_torch_dtype(dt),
                                        device=self.device))
        steps = xs[0].shape[0] if xs else 0
        ys = [[] for _ in rec.out_pairs]
        for t in range(steps):
            env2 = dict(env)
            env2.update(zip((m for m, _, _ in rec.mems), carry))
            env2.update(zip((ph for ph, _ in rec.seq_inputs),
                            (x[t] for x in xs)))
            self.run(rec.body, env2)
            carry = [env2[n] for _, _, n in rec.mems]
            for y, (o, _) in zip(ys, rec.out_pairs):
                y.append(env2[o])
        for y, (_, prog_out) in zip(ys, rec.out_pairs):
            env[prog_out] = torch.stack(y)

    def finish(self):
        with torch.no_grad():
            for target, value in self.written.values():
                target._value.copy_(value)


def _reads(rec, out):
    """Every variable name ``rec`` reads (a sub-block's too)."""
    if isinstance(rec, OpRecord):
        out.update(r for r in rec.in_refs if isinstance(r, str))
    elif isinstance(rec, AliasRecord):
        out.add(rec.src)
    elif isinstance(rec, GradRecord):
        out.add(rec.loss_name)
        out.update(p.name for p in rec.params)
    elif isinstance(rec, UpdateRecord):
        out.update(g for _, g in rec.pairs)
    elif isinstance(rec, WhileRecord):
        out.add(rec.cond_name)
        out.update(rec.carry_names)
        for r in rec.body:
            _reads(r, out)
    elif isinstance(rec, ScanRecord):
        out.update(src for _, src in rec.seq_inputs)
        out.update(spec for _, spec, _ in rec.mems if isinstance(spec, str))
        for r in rec.body:
            _reads(r, out)
    return out


def _writes(rec):
    if isinstance(rec, OpRecord):
        return rec.out_names
    if isinstance(rec, ConstRecord):
        return [rec.name]
    if isinstance(rec, AliasRecord):
        return [rec.dst]
    if isinstance(rec, GradRecord):
        return rec.grad_names
    if isinstance(rec, ScanRecord):
        return [o for _, o in rec.out_pairs]
    return []


def _drops(records, keep):
    """Record index -> the names no later record reads (those in
    ``keep`` never go): each after its last read, or at once if none
    reads it."""
    last = {}
    for i, rec in enumerate(records):
        for name in _writes(rec):
            last.setdefault(name, i)
        for name in _reads(rec, set()):
            last[name] = i
    out = {}
    for name, i in last.items():
        if name not in keep:
            out.setdefault(i, []).append(name)
    return out


def _walk_consts(records, out):
    for rec in records:
        if isinstance(rec, ConstRecord):
            out.append(rec.array)
        elif isinstance(rec, OpRecord):
            out.extend(r[1] for r in rec.in_refs
                       if isinstance(r, tuple)
                       and isinstance(r[1], torch.Tensor))
        elif isinstance(rec, (WhileRecord, ScanRecord)):
            _walk_consts(rec.body, out)
    return out


class Executor:
    """Reference fluid/executor.py:916: ``run()`` interprets the program
    with the persistables threaded through and written, so consecutive
    runs train. The run's device is ``place``'s, else the persistables',
    else the current device (the card unless ``set_device('cpu')``)."""

    def __init__(self, place=None):
        self.place = place
        self._cache = {}

    def _device(self, program):
        from ..core import device as device_mod
        if self.place is not None:
            return device_mod.resolve_device(self.place)
        for t in program.persist.values():
            return t._value.device
        return device_mod.resolve_device()

    def run(self, program=None, feed=None, fetch_list=None,
            return_numpy=True):
        feed = feed or {}
        if callable(program) and not isinstance(program, Program):
            out = program(**feed)
            return out if isinstance(out, (list, tuple)) else [out]
        if program is None or not getattr(program, "ops", None):
            return []  # a startup program: the parameters exist already
        if not isinstance(program, Program):
            raise TypeError(f"cannot run {type(program).__name__}")
        fetch_names = [f.name if isinstance(f, Tensor) else str(f)
                       for f in (fetch_list or [])]
        device = self._device(program)
        feeds = {}
        for name, val in feed.items():
            feeds[name] = as_torch(val, device=device).detach()
        sig = (program, program._version(), device,
               tuple(sorted((n, tuple(t.shape), str(t.dtype))
                            for n, t in feeds.items())),
               tuple(fetch_names))
        fn = self._cache.get(sig)
        if fn is None:
            fn = self._cache[sig] = self._compile(program, fetch_names,
                                                  device)
        fetches = fn(feeds)
        if return_numpy:
            return [Tensor._wrap(f).numpy() for f in fetches]
        return [Tensor._wrap(f) for f in fetches]

    def _compile(self, program, fetch_names, device):
        records = list(program.ops)
        persist = dict(program.persist)
        consts = {id(a): (a.to(device) if isinstance(a, torch.Tensor)
                          else a)
                  for a in _walk_consts(records, [])}
        grads = any(isinstance(r, GradRecord) for r in records)
        drops = _drops(records, set(fetch_names) | set(persist))

        def run_fn(feeds):
            env = dict(feeds)
            for name, t in persist.items():
                env[name] = t._value
            run = _Run(consts, device)
            with torch.set_grad_enabled(grads):
                run.run(records, env, drops)
            fetched = [env[n].detach() for n in fetch_names]
            run.finish()
            return fetched

        if device.type != "cuda":
            return run_fn
        from ..jit.to_static import TracedFunction
        return TracedFunction(run_fn, enable_ast=False)

    def close(self):
        self._cache.clear()


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Reference paddle.static.append_backward."""
    prog = loss.program if isinstance(loss, Variable) \
        else building_program()
    if prog is None:
        raise RuntimeError("append_backward requires static mode")
    return prog.append_backward(loss, parameter_list)


# -- serialization: the reference's format (op records by name, numpy
# arrays), read and written the same way by both packages ---------------

def _np(v):
    if isinstance(v, Tensor):
        v = v._value
    if isinstance(v, torch.Tensor):
        return Tensor._wrap(v.detach()).numpy()
    return v


def _dtype_name(dt):
    return dtype_mod.to_paddle_dtype(dt).name


def _serialize_record(rec):
    if isinstance(rec, GradRecord):
        return {"kind": "grad", "loss": rec.loss_name,
                "params": [p.name for p in rec.params],
                "grad_names": list(rec.grad_names), "upto": rec.upto}
    if isinstance(rec, UpdateRecord):
        raise ValueError("an optimizer's update record does not serialize; "
                         "save the pruned program (clone(for_test=True))")
    if isinstance(rec, ConstRecord):
        return {"kind": "const", "name": rec.name, "array": _np(rec.array)}
    if isinstance(rec, AliasRecord):
        return {"kind": "alias", "src": rec.src, "dst": rec.dst}
    if isinstance(rec, WhileRecord):
        return {"kind": "while", "cond": rec.cond_name,
                "body": [_serialize_record(r) for r in rec.body],
                "carry": list(rec.carry_names)}
    if isinstance(rec, ScanRecord):
        return {"kind": "scan",
                "body": [_serialize_record(r) for r in rec.body],
                "seq_inputs": list(rec.seq_inputs), "mems": list(rec.mems),
                "out_pairs": list(rec.out_pairs)}
    return {
        "kind": "op", "type": rec.op.name,
        "in_refs": [r if (r is None or isinstance(r, str))
                    else ("#const", np.asarray(_np(r[1])))
                    for r in rec.in_refs],
        "out_names": list(rec.out_names),
        "attrs": rec.attrs,
        "cast": None if rec.cast is None else _dtype_name(rec.cast),
        "writebacks": {i: t.name for i, t in rec.writebacks.items()},
    }


def _serialize_program(program):
    var_meta = {n: (list(v._shape), _dtype_name(v._value.dtype),
                    v.stop_gradient)
                for n, v in program.vars.items()}
    persist = {n: (_np(t), bool(getattr(t, "trainable", True)),
                   bool(t.stop_gradient))
               for n, t in program.persist.items()}
    return {"records": [_serialize_record(r) for r in program.ops],
            "vars": var_meta, "persist": persist,
            "feed_names": list(program.feed_names),
            "counter": program._counter[0]}


def _tensor(arr):
    return torch.as_tensor(np.array(arr, dtype=np.float32)
                           if str(np.asarray(arr).dtype) == "bfloat16"
                           else np.array(arr))


def _deserialize_record(r, prog):
    from ..core.dispatch import _REGISTRY
    kind = r["kind"]
    if kind == "grad":
        return GradRecord(r["loss"], [prog.persist[p] for p in r["params"]],
                          list(r["grad_names"]), int(r["upto"]))
    if kind == "const":
        return ConstRecord(r["name"], _tensor(r["array"]))
    if kind == "alias":
        return AliasRecord(r["src"], r["dst"])
    if kind == "while":
        return WhileRecord(r["cond"], [_deserialize_record(b, prog)
                                       for b in r["body"]],
                           list(r["carry"]))
    if kind == "scan":
        return ScanRecord([_deserialize_record(b, prog) for b in r["body"]],
                          [tuple(p) for p in r["seq_inputs"]],
                          [tuple(m) for m in r["mems"]],
                          [tuple(p) for p in r["out_pairs"]])
    op = _REGISTRY.get(r["type"])
    if op is None:
        raise ValueError(
            f"program references unknown op {r['type']!r}; is the "
            "op registered in this build?")
    in_refs = []
    for x in r["in_refs"]:
        if x is None or isinstance(x, str):
            in_refs.append(x)
        else:
            v = x[1]
            in_refs.append(("#const", v if isinstance(v, (bool, int, float))
                            else _tensor(v)))
    rec = OpRecord(op, in_refs, list(r["out_names"]), dict(r["attrs"]),
                   cast=None if r.get("cast") is None
                   else dtype_mod.to_torch_dtype(r["cast"]))
    rec.writebacks = {int(i): prog.persist[name]
                      for i, name in r["writebacks"].items()}
    return rec


def _deserialize_program(blob, device=None):
    from ..core import device as device_mod
    dev = device if device is not None else device_mod.resolve_device()
    prog = Program()
    prog.feed_names = list(blob["feed_names"])
    prog._counter = [int(blob.get("counter", 0))]
    for n, (shape, dtype, stop_grad) in blob["vars"].items():
        prog.vars[n] = Variable(n, shape, str(dtype), prog,
                                stop_gradient=stop_grad)
    for n, (arr, trainable, stop_grad) in blob["persist"].items():
        t = Tensor._wrap(_tensor(arr).to(dev), name=n)
        t.persistable = True
        t.trainable = trainable
        if not stop_grad:
            t.stop_gradient = False
        prog.persist[n] = t
    for r in blob["records"]:
        prog.ops.append(_deserialize_record(r, prog))
    return prog


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None, **kwargs):
    """Reference paddle.static.save_inference_model: the pruned
    (forward-only) program and its persistables, with the feed and
    fetch names, in ``<path_prefix>.pdmodel``."""
    if program is None:
        program = building_program()
    if program is None:
        raise RuntimeError("no program to save")
    blob = _serialize_program(program.clone(for_test=True))
    blob["feed_targets"] = [v.name if isinstance(v, Tensor) else str(v)
                            for v in (feed_vars or [])]
    blob["fetch_targets"] = [v.name if isinstance(v, Tensor) else str(v)
                             for v in (fetch_vars or [])]
    path = str(path_prefix) + ".pdmodel"
    with open(path, "wb") as f:
        pickle.dump(blob, f, protocol=4)
    return path


def load_inference_model(path_prefix, executor=None, **kwargs):
    """Reference paddle.static.load_inference_model: ``(program,
    feed_target_names, fetch_targets)``, the persistables on the
    executor's place (else the current device)."""
    path = str(path_prefix)
    if not path.endswith(".pdmodel"):
        path += ".pdmodel"
    with open(path, "rb") as f:
        blob = pickle.load(f)
    dev = None
    if executor is not None and executor.place is not None:
        from ..core import device as device_mod
        dev = device_mod.resolve_device(executor.place)
    prog = _deserialize_program(blob, dev)
    fetch = [prog.vars[n] for n in blob.get("fetch_targets", [])]
    return prog, list(blob.get("feed_targets", [])), fetch


_block_inplace()
_register_with_dispatch()
