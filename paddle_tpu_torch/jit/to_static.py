"""``@to_static``: whole-step capture as a CUDA graph (a port of
``paddle_tpu/jit/to_static.py``).

The reference turns a step into one XLA program; the port captures the
step's launches into one CUDA graph and replays it with a single launch.
A replay runs the kernels the eager step ran (cuDNN, cuBLAS, torch's
elementwise kernels and the hand-written K1-K3/K5-K7) on the same
addresses, so it gives eager's bits. The phases are the reference's, per
input signature:

call 1  runs eagerly (warm-up: the optimizer's moments, the batch norms'
        statistics and cuBLAS's workspaces come into being);
call 2  runs eagerly under a recording ``TraceContext``
        (``core/trace.py``): the writes to pre-existing Tensors, any
        rebinding of one (refused: a replay would write storage the
        Tensor no longer holds), the leaves that take grads and the CUDA
        generators the step draws from;
call 3  captures the step into a graph over static copies of the
        arguments, then replays it;
later   replay: the arguments are copied into the static buffers, the
        graph is launched, the outputs come back as clones (the next
        replay overwrites the graph's own), and each leaf whose grad the
        step left set gets the graph's grad tensor, as the reference's
        ``_run_compiled`` sets ``.grad``.

``warmup=0`` skips call 1. The signature is the reference's (the
arguments' structure, each tensor's shape and dtype, here also its
device, the scalar constants, the bound instance) plus grad mode and
the ``auto_cast`` state the call is made under. The
state a capture assumed is keyed too: for each recorded leaf, whether
its grad was None, and if not, its address; a call whose state differs
captures again and never replays a graph made for another state. A new
shape of a recorded structure captures without the eager and record
calls, as the reference's ``_same_struct_compiled`` does. A
``to_static`` inside a trace inlines; ``ProgramTranslator().enable(
False)`` runs everything eagerly.

On CPU tensors nothing is captured: after its record the function is
called eagerly. On CUDA a failed capture raises ``ToStaticError`` with
its cause (a host read, a Tensor ``if``, a rebinding, an H2D copy,
state kept on the host) and nothing runs eagerly in its place.

The hand-written kernels' launch counters move only while a graph is
captured; ``to_static`` takes that back and adds the captured launches
at each replay, so a counter reads captured x replays. A launch captured
inside a branch or loop body runs only when the body does: the body adds
it to a counter on the card, which the replay reads (one sync, only for
a graph that has such launches). Each generator a
step draws from is registered with its graph (torch's graph-safe
generator state), so every replay draws new numbers. The entries of one
``TracedFunction`` share one memory pool; ``pool_bytes()`` reads it.

With ``enable_ast`` (the default) the function is first converted by
``jit/dy2static.py``, as the reference's ``TracedFunction.__init__``
does: its own ``if``/``while``/``for`` on a Tensor become
``static.nn.cond``/``while_loop``, which a capture turns into CUDA
conditional nodes (``core/graph_cond.py``): one graph, captured once,
takes either branch and any trip count the data asks for on each replay.
The record call warms the branch it did not take (a capture thrown
away). A Tensor ``if`` that no conversion reached (``enable_ast=False``,
a callee's, ``ProgramTranslator().enable(False)``) still raises
``ToStaticError`` under capture. With ``analysis.birth`` tracking on, a
step's output born inside a branch or loop body (a Tensor that escaped
its scope) raises ``TracerLeakError``.
"""
import contextlib
import functools
import gc
import time

import torch

from ..amp.auto_cast import amp_state
from ..core import rng
from ..core import trace as trace_mod
from ..core.tensor import Tensor
from ..core.trace import ToStaticError
from ..analysis.birth import TracerLeakError


def _flatten(obj, leaves):
    """Flatten nested (list/tuple/dict) structure, extracting Tensor and
    torch tensor leaves. Returns a structure token for cache keys."""
    if isinstance(obj, Tensor):
        leaves.append(obj)
        return ("T",)
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return ("t",)
    if isinstance(obj, (list, tuple)):
        return ("L" if isinstance(obj, list) else "U",
                tuple(_flatten(o, leaves) for o in obj))
    if isinstance(obj, dict):
        return ("D", tuple(sorted((k, _flatten(v, leaves))
                                  for k, v in obj.items())))
    return ("C", obj if _hashable_const(obj) else repr(obj))


def _hashable_const(o):
    try:
        hash(o)
        return True
    except TypeError:
        return False


def _rebuild(struct, leaf_iter):
    kind = struct[0]
    if kind in ("T", "t"):
        return next(leaf_iter)
    if kind in ("L", "U"):
        seq = [_rebuild(s, leaf_iter) for s in struct[1]]
        return seq if kind == "L" else tuple(seq)
    if kind == "D":
        return {k: _rebuild(s, leaf_iter) for k, s in struct[1]}
    return struct[1]


def _torch_of(leaf):
    return leaf._value if isinstance(leaf, Tensor) else leaf


@contextlib.contextmanager
def no_collection():
    """Collect Python's cyclic garbage now and not again until the block
    ends: a CUDA graph in that garbage (an earlier step's) destroyed
    while another captures fails ("operation not permitted when stream is
    capturing") and leaves torch's graph state broken."""
    gc.collect()
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _check_births(out):
    """With birth tracking on: an output of the step born inside a
    branch or loop body that has closed escaped its scope."""
    if trace_mod._capture_hook is not None:
        from ..analysis import birth
        leaves = []
        _flatten(out, leaves)
        birth.check_outputs([t for t in leaves if isinstance(t, Tensor)])


def _counted():
    """The kernel wrappers whose ``launches`` a replay moves."""
    from ..ops import attention, fused_ce, paged_attention
    return (attention.flash_attention_forward, attention.flash_bwd_dq,
            attention.flash_bwd_dkv, fused_ce.fused_ce_forward,
            fused_ce.fused_ce_bwd_dx, fused_ce.fused_ce_bwd_dw,
            paged_attention.paged_decode_attention)


def _enabled():
    from . import ProgramTranslator
    return ProgramTranslator.get_instance().enable_to_static


class _Record:
    """What record found: the leaves that take grads, the CUDA
    generators, whether the step touched the card, the writes."""

    def __init__(self, ctx):
        self.leaves = list(ctx.leaves.values())
        self.generators = list(ctx.generators.values())
        self.cuda = ctx.cuda
        self.writes = list(ctx.writes.values())

    def state(self):
        """The grad state a capture assumes: each leaf's grad None (0)
        or its address."""
        out = []
        for leaf in self.leaves:
            g = leaf.grad
            out.append(0 if g is None else g.data_ptr())
        return tuple(out)


class _Graph:
    """One captured step: the graph, its static inputs and outputs, the
    leaves' grads it leaves set, its launches, capture ms and pool bytes
    after it."""

    def __init__(self, graph, static_in, out_struct, static_out, grads,
                 launches, capture_ms, cond_launches=None):
        self.graph = graph
        self.static_in = static_in
        self.out_struct = out_struct
        self.static_out = static_out
        self.grads = grads
        self.launches = launches
        self.capture_ms = capture_ms
        self.replays = 0
        # the card's counter of the launches inside conditional bodies
        # (None when there are none) and its value at the last read
        self.cond_launches = cond_launches
        self.cond_read = [0] * len(launches)


class TracedFunction:
    def __init__(self, fn, input_spec=None, warmup=1, enable_ast=True):
        if enable_ast and not getattr(fn, "__wrapped_dy2static__", False):
            # the reference's TracedFunction.__init__: Tensor control
            # flow of the function's own body into static.nn's
            from .dy2static import convert_to_static
            fn = convert_to_static(fn)
        self._fn = fn
        self._input_spec = input_spec
        self._enable_ast = enable_ast
        self._warmup = max(0, warmup)
        self._entries = {}  # signature -> dict(calls, record, graphs)
        self._shared = {"pool": None, "stream": None, "body_pool": None}
        functools.update_wrapper(self, fn)
        self._bound_instance = None

    def __get__(self, instance, owner):
        if instance is None:
            return self
        bound = TracedFunction(self._fn.__get__(instance, owner),
                               self._input_spec, self._warmup,
                               self._enable_ast)
        bound._entries = self._entries  # share cache across accesses
        bound._shared = self._shared
        bound._bound_instance = instance
        return bound

    @property
    def entries(self):
        return self._entries

    def graphs(self):
        """Every captured graph of this function."""
        return [g for e in self._entries.values()
                for g in e["graphs"].values()]

    def pool_bytes(self):
        """Bytes the card holds in this function's graph pool (the
        caching allocator's segments of the pool)."""
        pool = self._shared["pool"]
        if pool is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(pool))

    def _signature(self, args, kwargs):
        leaves = []
        struct = _flatten((args, kwargs), leaves)
        avals = []
        for t in leaves:
            v = _torch_of(t)
            avals.append((tuple(v.shape), str(v.dtype), str(v.device)))
        inst = id(self._bound_instance) \
            if self._bound_instance is not None else 0
        return (struct, tuple(avals), inst, torch.is_grad_enabled(),
                amp_state()), leaves, struct

    def __call__(self, *args, **kwargs):
        if not _enabled() or trace_mod.current_trace() is not None:
            # disabled, or nested to_static inside a trace: inline
            return self._fn(*args, **kwargs)
        sig, leaves, struct = self._signature(args, kwargs)
        entry = self._entries.get(sig)
        if entry is None:
            entry = {"calls": 0, "record": None, "graphs": {}}
            self._entries[sig] = entry
            entry["record"] = self._same_struct_record(sig)
        rec = entry["record"]
        if rec is not None:
            if not rec.cuda:
                return self._fn(*args, **kwargs)
            key = rec.state()
            g = entry["graphs"].get(key)
            if g is None:
                g = self._capture(entry, key, args, kwargs, struct, leaves)
            else:
                self._copy_in(g, leaves)
            return self._replay(g)
        entry["calls"] += 1
        if entry["calls"] <= self._warmup:
            return self._eager(args, kwargs, leaves)
        return self._record(entry, args, kwargs, leaves)

    def _same_struct_record(self, sig):
        """The record of an entry whose call differs from ``sig`` only in
        its tensors' shapes and dtypes (not their devices)."""
        def key(sig):
            struct, avals, inst, grad, amp = sig
            return struct, tuple(a[2] for a in avals), inst, grad, amp
        for sig2, e2 in self._entries.items():
            if e2["record"] is not None and key(sig2) == key(sig):
                return e2["record"]
        return None

    def _stream(self):
        if self._shared["stream"] is None:
            self._shared["stream"] = torch.cuda.Stream()
            self._shared["pool"] = torch.cuda.graph_pool_handle()
            # conditional bodies allocate from a pool of their own
            # (core/graph_cond.py)
            self._shared["body_pool"] = torch.cuda.graph_pool_handle()
        return self._shared["stream"]

    # -- calls 1 and 2: eager, the second under record ---------------------
    def _eager(self, args, kwargs, leaves, ctx=None):
        """Run the step eagerly, under ``ctx`` when given. On the card it
        runs on the capture stream, so the autograd nodes that outlive
        it (each leaf's AccumulateGrad) and cuBLAS's workspace belong to
        the stream the capture will use."""
        on_card = any(_torch_of(t).is_cuda for t in leaves) or (
            torch.cuda.is_available() and torch.cuda.is_initialized())
        with contextlib.ExitStack() as stack:
            if ctx is not None:
                stack.enter_context(trace_mod.trace_guard(ctx))
                stack.enter_context(trace_mod.RecordMode(ctx))
            if not on_card:
                return self._fn(*args, **kwargs)
            stream = self._stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                out = self._fn(*args, **kwargs)
            torch.cuda.current_stream().wait_stream(stream)
            return out

    def _record(self, entry, args, kwargs, leaves):
        ctx = trace_mod.TraceContext("record")
        out = self._eager(args, kwargs, leaves, ctx)
        if ctx.rebinds:
            names = ", ".join(repr(t.name) for t in ctx.rebinds.values())
            raise ToStaticError(
                f"to_static({self._name()}): the step rebinds the Tensor(s) "
                f"{names} (their storage replaced, not written): a CUDA "
                "graph would replay into storage they no longer hold. Write "
                "them in place (set_value) instead")
        _check_births(out)
        entry["record"] = _Record(ctx)
        return out

    def _name(self):
        return getattr(self._fn, "__qualname__", repr(self._fn))

    # -- call 3: capture ----------------------------------------------------
    def _capture(self, entry, key, args, kwargs, struct, leaves):
        rec = entry["record"]
        stream = self._stream()
        static_in = []
        for t in leaves:
            v = _torch_of(t).detach().clone()
            if _torch_of(t).requires_grad:
                v.requires_grad_(True)
            static_in.append(Tensor._wrap(v, name=t.name)
                             if isinstance(t, Tensor) else v)
        cargs, ckwargs = _rebuild(struct, iter(static_in))
        counted = _counted()
        before = [w.launches for w in counted]
        ptrs = [(t, t._value.data_ptr()) for t in rec.writes]
        graph = torch.cuda.CUDAGraph()
        gens = {id(gen): gen for gen in rec.generators}
        for gen in rng._generators.values():
            if gen.device.type == "cuda":
                gens.setdefault(id(gen), gen)
        for gen in gens.values():
            graph.register_generator_state(gen)
        ctx = trace_mod.TraceContext("capture")
        ctx.graph = graph
        ctx.body_pool = self._shared["body_pool"]
        ctx.cond_launches = torch.zeros(len(counted), dtype=torch.int64,
                                        device=torch.cuda.current_device())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with trace_mod.trace_guard(ctx), no_collection(), \
                    torch.cuda.graph(graph, pool=self._shared["pool"],
                                     stream=stream):
                out = self._fn(*cargs, **ckwargs)
                _check_births(out)
        except (ToStaticError, TracerLeakError):
            raise
        except Exception as e:  # noqa: BLE001 - every cause is re-raised
            cause = e.__context__ if e.__context__ is not None else e
            raise ToStaticError(
                f"to_static({self._name()}): capturing the step as a CUDA "
                f"graph failed: {type(cause).__name__}: "
                f"{str(cause).splitlines()[0] if str(cause) else ''}") from e
        finally:
            captured = [w.launches - b for w, b in zip(counted, before)]
            for w, b in zip(counted, before):
                w.launches = b
        torch.cuda.synchronize()
        capture_ms = (time.perf_counter() - t0) * 1e3
        moved = [t.name for t, p in ptrs if t._value.data_ptr() != p]
        if moved:
            raise ToStaticError(
                f"to_static({self._name()}): the Tensor(s) {moved} changed "
                "storage during the capture")
        out_leaves = []
        out_struct = _flatten(out, out_leaves)
        grads = [(leaf, leaf.grad) for leaf in rec.leaves
                 if leaf.grad is not None]
        g = _Graph(graph, static_in, out_struct, out_leaves, grads,
                   captured, capture_ms,
                   ctx.cond_launches if ctx.cond_counted else None)
        entry["graphs"][key] = g
        return g

    # -- later calls: replay ----------------------------------------------
    def _copy_in(self, g, leaves):
        with torch.no_grad():
            for s, t in zip(g.static_in, leaves):
                _torch_of(s).copy_(_torch_of(t))

    def _replay(self, g):
        g.graph.replay()
        g.replays += 1
        for w, n in zip(_counted(), g.launches):
            w.launches += n
        if g.cond_launches is not None:
            now = g.cond_launches.tolist()
            for w, n, seen in zip(_counted(), now, g.cond_read):
                w.launches += n - seen
            g.cond_read = now
        for leaf, grad in g.grads:
            leaf.grad = grad
        outs = []
        for o in g.static_out:
            v = _torch_of(o).detach().clone()
            outs.append(Tensor._wrap(v) if isinstance(o, Tensor) else v)
        return _rebuild(g.out_struct, iter(outs))

    def concrete_program(self):
        return self._entries


def to_static(function=None, input_spec=None, build_strategy=None,
              property=False, warmup=1, enable_ast=True):  # noqa: A002
    """paddle.jit.to_static equivalent: a function, or a ``Layer`` whose
    ``forward`` is wrapped."""
    def deco(fn):
        from ..nn.layer_base import Layer
        if isinstance(fn, Layer):
            fn.forward = TracedFunction(fn.forward, input_spec,
                                        warmup=warmup, enable_ast=enable_ast)
            return fn
        return TracedFunction(fn, input_spec, warmup=warmup,
                              enable_ast=enable_ast)
    if function is not None:
        return deco(function)
    return deco


def not_to_static(fn):
    return fn
